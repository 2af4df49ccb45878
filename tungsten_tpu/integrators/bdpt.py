"""Wavefront bidirectional path tracer.

Mirror of src/core/integrators/bidirectional_path_tracer/ (LightPath.cpp:
tracePath :180-206, bdptConnect :323, bdptCameraConnect, misWeight :96-178;
BidirectionalPathTracer.cpp:21-68): one camera subpath + one light subpath per
sample, every (s, t) connection evaluated with area-measure MIS weights that
honor dirac vertices.

Wavefront form: fixed-K vertex arrays (N, K, ...) filled by a lockstep subpath
tracing loop (the same kernel set as the path tracer); connections run as a
Python loop over valid (s, t) pairs, each a full wavefront batch with one
merged visibility intersect; t=1 connections splat through the light-tracer
machinery. MIS uses PBRT-style stored forward/reverse area pdfs with junction
overrides computed per connection — algebraically the same pdf-ratio products
as LightPath::misWeight.

Supports surface and medium (phase-function) vertices; subpaths are capped at
K = min(max_bounces + 1, 16) vertices by default — configurable via the
integrator's "bdpt_max_vertices" (vertex SoA memory scales ~K, connection
batches ~K^2/2; see SceneMeta.bdpt_max_vertices for the measured curve).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..math import vecops as vo
from ..models.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from ..models.bsdfs.dispatch import bsdf_eta_sq
from ..models.bsdfs.common import Lobes
from ..models.cameras import camera_rays, camera_rays_w
from ..models.cameras.connect import camera_sample_direct
from ..models.phase import phase_eval, phase_sample
from ..models.primitives import lights as L
from ..sampling import Sampler, warps
from ..scene.flatten import DEFAULT_EPSILON, FlatScene
from .light_tracer import splat_filtered
from .path_tracer import (
    INF, SHADOW_FUDGE, _intersect, _select_medium_dir, _shading_data,
)

# vertex kinds
V_INVALID = 0
V_SURFACE = 1
V_MEDIUM = 2
V_LIGHT = 3  # root of the light subpath (on an area light)
V_CAMERA = 4  # root of the camera subpath (pinhole: dirac)

DIMS_PER_VERTEX = 8

# debug: restrict the estimator to one technique family with weight 1
# ("s0" | "s1" | "conn" | "t1" | "" = full MIS). Read statically at trace time.
import os as _os
_DEBUG_FAMILY = _os.environ.get("TUNGSTEN_BDPT_DEBUG", "")


def _remap0(x):
    return jnp.where(x > 0.0, x, 1.0)


def _solid_to_area(pdf_solid, d, dist_sq, ng, kind):
    """Solid-angle pdf at the source -> area pdf at the target vertex."""
    cos_t = jnp.abs(vo.dot(d, ng))
    jac = jnp.where(kind == V_MEDIUM, 1.0, cos_t) / jnp.maximum(dist_sq, 1e-20)
    return pdf_solid * jac


class _Verts:
    """SoA vertex storage (N, K, ...) with .at[:, k] update helpers."""

    def __init__(self, n, k):
        z = lambda *sh: jnp.zeros((n, k) + sh, jnp.float32)
        self.kind = jnp.zeros((n, k), jnp.int32)
        self.p = z(3)
        self.ng = z(3)
        self.nf = z(3)  # shading-frame normal (flipped)
        self.wi = z(3)  # unit direction toward the PREVIOUS vertex
        self.throughput = z(3)
        self.pdf_fwd = z()  # area pdf of this vertex from the previous
        self.pdf_rev = z()  # area pdf of this vertex from the next
        self.edge_med_bwd = jnp.ones((n, k))  # medium bwd pdf of edge to next
        self.mat = jnp.zeros((n, k), jnp.int32)
        self.uv = z(2)
        self.light = jnp.full((n, k), -1, jnp.int32)
        self.dirac = jnp.zeros((n, k), bool)
        self.medium = jnp.full((n, k), -1, jnp.int32)
        self.tri = jnp.full((n, k), -1, jnp.int32)  # surface prim (media select)
        self.flip = jnp.zeros((n, k), bool)  # two-sided shading-frame flip

    def tree(self):
        return vars(self)

    @staticmethod
    def from_tree(d):
        v = object.__new__(_Verts)
        vars(v).update(d)
        return v

    def set_slot(self, k, **fields):
        for name, val in fields.items():
            arr = getattr(self, name)
            setattr(self, name, arr.at[:, k].set(val))

    def slot(self, k):
        """Dynamic-index all fields at slot k (k may be traced)."""
        return _dyn_get_dict(self, k)


def _vertex_fg(scene, v, wi_world, wo_world, nonspec=False):
    """f*cos ("f" for medium = phase) and forward pdf at a stored vertex, for
    incoming direction wi_world (toward previous) and outgoing wo_world."""
    ctx = (scene.materials, scene.textures)
    n = wi_world.shape[0]
    t_ax, b_ax = vo.tangent_frame(v["nf"])
    wi_l = vo.to_local(t_ax, b_ax, v["nf"], wi_world)
    wo_l = vo.to_local(t_ax, b_ax, v["nf"], wo_world)
    f_s = bsdf_eval(ctx, v["mat"], v["uv"], wi_l, wo_l, nonspecular_only=nonspec)
    p_s = bsdf_pdf(ctx, v["mat"], v["uv"], wi_l, wo_l, nonspecular_only=nonspec)
    if scene.meta.has_media:
        mi = jnp.maximum(v["medium"], 0)
        ptype = scene.media.phase_type[mi]
        g = scene.media.phase_g[mi]
        # phase convention: eval(d_in, d_out) with d_in the propagation dir
        fp = phase_eval(ptype, g, -wi_world, wo_world)
        is_med = v["kind"] == V_MEDIUM
        f = jnp.where(is_med[..., None], fp[..., None], f_s)
        p = jnp.where(is_med, fp, p_s)
    else:
        f = f_s
        p = p_s
    return f, p


def _trace_subpath(scene, sampler, o0, d0, beta0, pdf0_dir, root_fields, k_max, adjoint):
    """Trace a subpath from (o0, d0); returns (_Verts, n_vertices (N,)).
    Slot 0 = the root (camera/light vertex); slots 1.. = scattering vertices.
    beta0: throughput after the root; pdf0_dir: solid-angle pdf of d0."""
    meta = scene.meta
    n = o0.shape[0]
    ctx = (scene.materials, scene.textures)
    verts = _Verts(n, k_max)
    root_alive = root_fields.pop("_alive", jnp.ones((n,), bool))
    root_medium = root_fields.pop("_medium", jnp.full((n,), -1, jnp.int32))
    verts.set_slot(0, **root_fields)

    state = dict(
        verts=verts.tree(),
        o=o0,
        d=d0,
        beta=beta0,
        pdf_dir=pdf0_dir,  # solid-angle pdf of the ray we're following
        alive=root_alive,
        medium=root_medium,
        first_scatter=jnp.ones((n,), bool),
        med_bounce=jnp.zeros((n,), jnp.int32),
        n_verts=jnp.ones((n,), jnp.int32),
        prev_dirac=jnp.zeros((n,), bool),
        near=jnp.full((n,), DEFAULT_EPSILON),
        seg_base=jnp.zeros((n,)),
        edge_fwd_base=jnp.ones((n,)),
        smp=sampler,
    )

    def body(k, s):
        verts = _Verts.from_tree(s["verts"])
        smp = s["smp"]
        o, d, alive = s["o"], s["d"], s["alive"]
        beta = s["beta"]
        medium = s["medium"]

        hit = _intersect(scene, o, d, s["near"], jnp.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive

        if meta.has_media:
            from ..models.media import medium_sample_distance

            u_mc, smp = smp.next_1d()
            u_md, smp = smp.next_1d()
            u_mb, smp = smp.next_1d()
            far = jnp.where(did_hit, hit.t, INF)
            ms = medium_sample_distance(
                scene.media, medium, o, d, far, s["first_scatter"], s["med_bounce"],
                u_mc, u_md, u_mb,
            )
            beta = beta * jnp.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface = ms.exited & did_hit
            alive = alive & (scattered | hit_surface)
            # edge medium pdfs (PathVertex.cpp:156-163): forward = the
            # distance sampler's pdf for this segment; backward = the pdf of
            # the reverse segment with swapped endpoint types
            in_med = medium >= 0
            edge_fwd_med = jnp.where(in_med, ms.pdf, 1.0)
        else:
            smp = smp.skip(3)
            scattered = jnp.zeros((n,), bool)
            hit_surface = did_hit
            alive = alive & did_hit

        p_srf, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        lobes = scene.materials.lobes[mat_id]
        hit_backside = vo.dot(ns, d) > 0.0
        flip = (
            hit_backside & ~Lobes.is_transmissive(lobes)
            if meta.enable_two_sided
            else jnp.zeros_like(hit_backside)
        )
        nf = vo.where3(flip, -ns, ns)

        if meta.has_media:
            vp = jnp.where(scattered[..., None], ms.p, p_srf)
            kind = jnp.where(
                scattered, V_MEDIUM, jnp.where(hit_surface, V_SURFACE, V_INVALID)
            )
            seg_sq = jnp.where(scattered, ms.t, hit.t) ** 2
        else:
            vp = p_srf
            kind = jnp.where(hit_surface, V_SURFACE, V_INVALID)
            seg_sq = hit.t**2

        # forward pass-through events (pure `forward` bsdfs, e.g. a window
        # the camera looks through) are COLLAPSED out of the path the way
        # LightPath.cpp:36-53 removes forward vertices and folds their edge
        # pdfs: no vertex is stored, the ray continues straight, and the
        # accumulated segment length feeds the next vertex's area pdf.
        fwd_evt = hit_surface & Lobes.is_forward(lobes)
        seg_len = jnp.sqrt(jnp.maximum(seg_sq, 0.0)) + s["seg_base"]
        seg_sq = seg_len * seg_len
        pdf_fwd_area = _solid_to_area(s["pdf_dir"], d, seg_sq, ng, kind)
        # dirac previous vertices propagate pdf 0 markers naturally
        if meta.has_media:
            # LightPath.cpp:66-71: vertices[i].pdfForward *= edge.pdfForward
            # (forward pass-through collapses accumulate in edge_fwd_base)
            pdf_fwd_area = pdf_fwd_area * s["edge_fwd_base"] * edge_fwd_med

        store = alive & ~fwd_evt
        idx = jnp.clip(s["n_verts"], 0, verts.kind.shape[1] - 1)

        new_fields = dict(
            kind=jnp.where(store, kind, V_INVALID),
            p=vp,
            ng=vo.where3(scattered, -d, ng) if meta.has_media else ng,
            nf=vo.where3(scattered, -d, nf) if meta.has_media else nf,
            wi=-d,
            throughput=beta,
            pdf_fwd=pdf_fwd_area,
            mat=mat_id,
            uv=uv,
            light=jnp.where(hit_surface, light_id, -1),
            dirac=jnp.zeros((n,), bool),
            medium=medium,
            tri=jnp.where(hit_surface, hit.prim, -1),
            flip=flip & hit_surface,
        )
        for name, val in new_fields.items():
            arr = getattr(verts, name)
            upd = jnp.where(_mask_like(store, val), val, _dyn_get(arr, idx))
            setattr(verts, name, _dyn_set(arr, idx, upd))
        n_verts = jnp.where(store, s["n_verts"] + 1, s["n_verts"])

        # sample the continuation
        t_ax, b_ax = vo.tangent_frame(nf)
        t_ax = vo.where3(flip, -t_ax, t_ax)
        wi_l = vo.to_local(t_ax, b_ax, nf, -d)
        u2, smp = smp.next_2d()
        u1, smp = smp.next_1d()
        bs = bsdf_sample(ctx, mat_id, uv, wi_l, u2, u1)
        wo_w = vo.to_global(t_ax, b_ax, nf, bs.wo)
        w_step = bs.weight
        pdf_next = bs.pdf
        if adjoint:
            eta2 = bsdf_eta_sq(ctx, mat_id, uv, wi_l, bs.wo)
            wi_w = -d
            corr = jnp.abs(
                (vo.dot(wo_w, ng) * wi_l[..., 2])
                / jnp.maximum(jnp.abs(vo.dot(wi_w, ng) * bs.wo[..., 2]), 1e-20)
            )
            w_step = w_step * (corr / jnp.maximum(eta2, 1e-20))[..., None]
        if meta.has_media:
            mi = jnp.maximum(medium, 0)
            u_ph = u2
            w_ph, pdf_ph = phase_sample(
                scene.media.phase_type[mi], scene.media.phase_g[mi], d, u_ph
            )
            wo_w = vo.where3(scattered, w_ph, wo_w)
            w_step = jnp.where(scattered[..., None], 1.0, w_step)
            pdf_next = jnp.where(scattered, pdf_ph, pdf_next)

        if meta.has_forward:
            from .path_tracer import _forward_transparency

            transp = _forward_transparency(scene, mat_id, uv, wi_l)
            wo_w = vo.where3(fwd_evt, d, wo_w)
            w_step = jnp.where(fwd_evt[..., None], transp, w_step)
            pdf_next = jnp.where(fwd_evt, s["pdf_dir"], pdf_next)

        sampled_dirac = Lobes.has_specular(bs.lobe) & hit_surface
        verts.dirac = _dyn_set(
            verts.dirac, idx,
            jnp.where(store, sampled_dirac, _dyn_get(verts.dirac, idx)),
        )

        # reverse pdf of the PREVIOUS vertex: pdf of sampling (wo -> wi)
        f_rev, p_rev_solid = _vertex_fg(scene, {
            "nf": nf if not meta.has_media else vo.where3(scattered, -d, nf),
            "mat": mat_id, "uv": uv, "medium": medium,
            "kind": kind,
        }, wo_w, -d)
        pidx = jnp.maximum(idx - 1, 0)
        prev = _dyn_get_dict(verts, pidx)
        dvec = prev["p"] - vp
        dsq = vo.length_sq(dvec)
        p_rev_area = _solid_to_area(
            p_rev_solid, vo.normalize(dvec, eps=1e-12), dsq, prev["ng"], prev["kind"]
        )
        if meta.has_media:
            # LightPath.cpp:70: vertices[i-1].pdfBackward *= edge.pdfBackward
            # — the reverse segment's distance pdf, start/end types swapped
            # (PathVertex.cpp:161-163)
            from ..models.media import medium_distance_pdf

            seg_t = jnp.sqrt(jnp.maximum(seg_sq, 1e-24))
            edge_bwd_med = medium_distance_pdf(
                scene.media, medium, vp, -d, seg_t,
                start_on_surface=kind != V_MEDIUM,
                end_on_surface=prev["kind"] != V_MEDIUM,
            )
            p_rev_area = p_rev_area * jnp.where(medium >= 0, edge_bwd_med, 1.0)
            # kept separately too: the junction overrides (over_rev_c2/l2)
            # REPLACE pdf_rev with a different directional pdf over the SAME
            # edge, so they must refold this factor (PathVertex::evalPdfs
            # uses prevEdge->pdfBackward)
            emb = jnp.where(medium >= 0, edge_bwd_med, 1.0)
            verts.edge_med_bwd = _dyn_set(
                verts.edge_med_bwd, pidx,
                jnp.where(store, emb, _dyn_get(verts.edge_med_bwd, pidx)),
            )
        verts.pdf_rev = _dyn_set(
            verts.pdf_rev, pidx,
            jnp.where(store, p_rev_area, _dyn_get(verts.pdf_rev, pidx)),
        )

        beta = beta * jnp.where(alive[..., None], w_step, 1.0)
        alive = alive & jnp.where(hit_surface & ~fwd_evt, bs.valid, True)
        alive = alive & (vo.max3(jnp.abs(beta)) > 0.0)

        if meta.has_media:
            tri = jnp.maximum(hit.prim, 0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & hit_surface
            new_med = jnp.where(backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri])
            medium = jnp.where(override, new_med, medium)
            s["first_scatter"] = jnp.where(hit_surface, True, jnp.where(scattered, False, s["first_scatter"]))
            s["med_bounce"] = jnp.where(hit_surface, 0, jnp.where(scattered, s["med_bounce"] + 1, s["med_bounce"]))

        return dict(
            verts=verts.tree(),
            o=vp,
            d=wo_w,
            beta=beta,
            pdf_dir=pdf_next,
            alive=alive,
            medium=medium,
            first_scatter=s["first_scatter"],
            med_bounce=s["med_bounce"],
            n_verts=n_verts,
            prev_dirac=jnp.where(fwd_evt, s["prev_dirac"], sampled_dirac),
            near=jnp.where(scattered, 0.0, jnp.full((n,), DEFAULT_EPSILON)),
            seg_base=jnp.where(fwd_evt, seg_len, 0.0),
            edge_fwd_base=(
                jnp.where(fwd_evt, s["edge_fwd_base"] * edge_fwd_med, 1.0)
                if meta.has_media else s["edge_fwd_base"]
            ),
            # skip(0) drops any pending half-draw so the carry pytree
            # structure matches the loop init (pending=None)
            smp=smp.skip(0),
        )

    final = jax.lax.fori_loop(1, k_max, body, state)
    return _Verts.from_tree(final["verts"]), final["n_verts"], final["smp"]


def _mask_like(mask, val):
    return mask[..., None] if val.ndim == 2 else mask


def _dyn_set(arr, k, val):
    """arr (N, K, ...); val (N, ...); k scalar or per-lane (N,) (traced ok):
    arr[:, k] = val, via a one-hot select over the small K axis (K <= 8)."""
    n, kdim = arr.shape[0], arr.shape[1]
    kk = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (n,))
    sel = jax.lax.broadcasted_iota(jnp.int32, (n, kdim), 1) == kk[:, None]
    sel = sel.reshape((n, kdim) + (1,) * (arr.ndim - 2))
    valx = val[:, None] if val.ndim == arr.ndim - 1 else val
    return jnp.where(sel, valx, arr)


def _dyn_get(arr, k):
    n = arr.shape[0]
    idx = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (n,)).reshape(
        (n, 1) + (1,) * (arr.ndim - 2)
    )
    out = jnp.take_along_axis(arr, idx, axis=1)
    return out[:, 0]


def _dyn_get_dict(verts, k):
    return {name: _dyn_get(arr, k) for name, arr in vars(verts).items()}


def _mis_weight_static(scene, cv, lv, s, t, over_rev_c1, over_rev_c2, over_rev_l1, over_rev_l2):
    """PBRT-style balance of pdf-ratio products for strategy (s, t), with the
    four junction reverse-pdf overrides (cam[t-1], cam[t-2], light[s-1],
    light[s-2]); s/t are Python ints so the walks unroll exactly."""
    n = cv.pdf_fwd.shape[0]
    sum_ri = jnp.zeros((n,))

    def rev_c(i):
        if i == t - 1 and over_rev_c1 is not None:
            return over_rev_c1
        if i == t - 2 and over_rev_c2 is not None:
            return over_rev_c2
        return cv.pdf_rev[:, i]

    def rev_l(i):
        if i == s - 1 and over_rev_l1 is not None:
            return over_rev_l1
        if i == s - 2 and over_rev_l2 is not None:
            return over_rev_l2
        return lv.pdf_rev[:, i]

    ri = jnp.ones((n,))
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_c(i)) / _remap0(cv.pdf_fwd[:, i])
        ok = ~cv.dirac[:, i] & ~cv.dirac[:, i - 1]
        # the i==1 term is technique (s+t-1, 1); (1,1) is not in the
        # estimator's technique set (area lights have no directional splat,
        # Primitive::evalDirectionalEmission == 0) so drop it from the sum
        if i == 1 and (s + t) < 3:
            ok = ok & False
        sum_ri = sum_ri + jnp.where(ok, ri, 0.0)

    ri = jnp.ones((n,))
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_l(i)) / _remap0(lv.pdf_fwd[:, i])
        prev_delta = lv.dirac[:, i - 1] if i > 0 else jnp.zeros((n,), bool)
        ok = ~lv.dirac[:, i] & ~prev_delta
        sum_ri = sum_ri + jnp.where(ok, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


def _vert_at(verts, i):
    return {name: arr[:, i] for name, arr in vars(verts).items()}


def _fg_static(scene, v, wi_world, wo_world):
    return _vertex_fg(scene, v, wi_world, wo_world)


def _adjoint_factor(v, wo_world):
    """Shading-normal adjoint correction at a light-subpath vertex
    (Bsdf.hpp adjoint branch); 1 at medium vertices."""
    wi_w = v["wi"]
    nf = v["nf"]
    ng = v["ng"]
    cos_wo_g = vo.dot(wo_world, ng)
    cos_wi_g = vo.dot(wi_w, ng)
    cos_wo_s = vo.dot(wo_world, nf)
    cos_wi_s = vo.dot(wi_w, nf)
    corr = jnp.abs(
        (cos_wo_g * cos_wi_s) / jnp.maximum(jnp.abs(cos_wi_g * cos_wo_s), 1e-20)
    )
    return jnp.where(v["kind"] == V_MEDIUM, 1.0, corr)


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("n_passes",))
def trace_bdpt_batch(scene: FlatScene, seed, lane_ids, px, py, base_pass, n_passes=1):
    """n_passes fused BDPT passes in ONE dispatch; returns summed
    (eye (N,3), splat (H*W,3))."""
    n = px.shape[0]
    n_pix = scene.meta.res_x * scene.meta.res_y

    def body(i, acc):
        eye_a, splat_a = acc
        ps = seed.at[1].set(0x20000 + (base_pass + i).astype(jnp.uint32))
        eye, splat = trace_bdpt_pass(scene, ps, lane_ids, px, py)
        return eye_a + eye, splat_a + splat

    return jax.lax.fori_loop(
        0, n_passes, body,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n_pix, 3), jnp.float32)),
    )


@jax.jit
def trace_bdpt_pass_pyramid(scene: FlatScene, seed, lane_ids, px, py):
    """One BDPT sample with the per-technique (s, t) decomposition kept
    (the reference's ImagePyramid diagnostic, ImagePyramid.cpp:20-40).
    Returns (eye, splat, {(s, t): per-lane add or t=1 splat buffer})."""
    return _bdpt_sample(scene, seed, lane_ids, px, py, pyramid=True)


@jax.jit
def trace_bdpt_pass(scene: FlatScene, seed, lane_ids, px, py):
    """One BDPT sample per lane. Returns (eye_radiance (N, 3),
    splat_buffer (H*W, 3)) — t=1 techniques go to the splat buffer
    (normalize by total paths like the light tracer)."""
    return _bdpt_sample(scene, seed, lane_ids, px, py)


def _bdpt_sample(scene: FlatScene, seed, lane_ids, px, py, table=None,
                 skip_dims=1, sel=None, collect=False, return_verts=False,
                 pyramid=False):
    """Core BDPT sample evaluation.

    table: optional (N, D, 2) primary-sample table (MLT replay — the
      WritableMetropolisSampler analog); slot layout: `skip_dims` reserved
      driver slots (pixel position, MMLT technique selector), then the path
      dims in trace order.
    sel: optional (s_sel (N,), v_sel (N,)) — restrict each lane to ONE
      technique: s light vertices with total vertex count v = s + t
      (multiplexed MLT, MultiplexedMltTracer.hpp:25-40). Contributions are
      NOT scaled by the per-length technique count (caller's job).
    collect=False: returns (eye (N,3), splat_buffer (H*W,3)).
    collect=True: returns dict(eye (N,3), t1_val (N,S,3), t1_pixf (N,S,2),
      t1_ok (N,S)) with S = k_max-2 t=1 techniques (s = 2..k_max-1), values
      in light-tracer units (divide by n_pix for eye units)."""
    from .path_tracer import _trace_transparent

    meta = scene.meta
    n = px.shape[0]
    # LightPath(settings.maxBounces + 1) vertices per subpath
    # (BidirectionalPathTracer.cpp:14-15); cap at 8 to bound the static
    # (s, t) family unroll count on the host compiler
    k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
    sampler = Sampler.create(seed, lane_ids, table)
    if table is not None and skip_dims:
        sampler = sampler.skip(skip_dims)

    def tech_mask(s, t):
        """Per-lane gate for technique family (s, t)."""
        if sel is None:
            return jnp.ones((n,), bool)
        return (sel[0] == s) & (sel[1] == s + t)

    # ---- camera subpath ----
    u_cam, sampler = sampler.next_2d()
    u_lens, sampler = sampler.next_2d()
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)
    ratio = meta.res_y / meta.res_x
    local = d @ scene.camera.rot  # camera-local direction
    cosz = jnp.maximum(local[..., 2], 1e-6)
    inv_plane_area = 1.0 / ((2.0 / scene.camera.plane_dist) * (2.0 * ratio / scene.camera.plane_dist))
    pdf_cam_dir = inv_plane_area / (cosz**3)
    cam_root = dict(
        kind=jnp.full((n,), V_CAMERA, jnp.int32),
        p=jnp.broadcast_to(scene.camera.pos, (n, 3)),
        ng=jnp.broadcast_to(scene.camera.rot[:, 2], (n, 3)),
        nf=jnp.broadcast_to(scene.camera.rot[:, 2], (n, 3)),
        throughput=jnp.ones((n, 3)),
        pdf_fwd=jnp.ones((n,)),
        # NOT dirac: the t=1 splat technique participates in MIS (the truly
        # excluded techniques are handled structurally below)
        dirac=jnp.zeros((n,), bool),
    )
    cam_root["_medium"] = jnp.full((n,), meta.camera_medium, jnp.int32)
    cv, n_cv, sampler = _trace_subpath(
        scene, sampler, o, d, jnp.broadcast_to(cam_w[..., None], (n, 3)),
        pdf_cam_dir, cam_root, k_max, adjoint=False
    )

    # ---- light subpath ----
    u_li, sampler = sampler.next_1d()
    li = jnp.minimum((u_li * meta.n_lights).astype(jnp.int32), meta.n_lights - 1)
    pick = 1.0 / meta.n_lights
    u_tri, sampler = sampler.next_1d()
    u_pos, sampler = sampler.next_2d()
    em = L.sample_emitter_position(scene, li, u_tri, u_pos)
    u_dir, sampler = sampler.next_2d()
    d_loc = warps.cosine_hemisphere(u_dir)
    t_e, b_e = vo.tangent_frame(em.ng)
    d_l = vo.to_global(t_e, b_e, em.ng, d_loc)
    area = scene.lights.area[li]
    light_root = dict(
        kind=jnp.full((n,), V_LIGHT, jnp.int32),
        p=em.p,
        ng=em.ng,
        nf=em.ng,
        uv=em.uv,
        throughput=em.weight / pick,  # pi * A * Le / pick
        pdf_fwd=pick / jnp.maximum(area, 1e-20),
        dirac=jnp.zeros((n,), bool),
        light=li,
    )
    light_root["_alive"] = em.valid
    # emitted rays leave into the light surface's exterior medium
    # (Primitive medium attachment; the reference threads it via
    # PathVertex::_medium from the emitter record)
    if meta.has_media:
        light_root["_medium"] = scene.tri_med_ext[jnp.maximum(em.tri, 0)]
    beta_l1 = em.weight / pick  # direction weight 1 (cosine)
    lv, n_lv, sampler = _trace_subpath(
        scene, sampler, em.p, d_l, beta_l1, warps.cosine_hemisphere_pdf(d_loc),
        light_root, k_max, adjoint=True,
    )

    eye = jnp.zeros((n, 3))
    splat = jnp.zeros((meta.res_x * meta.res_y, 3), jnp.float32)
    # per-(s, t) technique decomposition buffers (ImagePyramid.cpp:20-40):
    # per-lane adds for t >= 2 techniques, splat buffers for t = 1
    pyr = {}
    le_tex = scene.lights.tex

    # ---- s = 0: camera path hits a light ----
    for t in range(2, k_max + 1):
        C = _vert_at(cv, t - 1)
        lid = C["light"]
        on_light = (lid >= 0) & (C["kind"] == V_SURFACE) & (t <= n_cv)
        front = vo.dot(-C["wi"], C["ng"]) < 0.0
        from ..models.textures import eval_texture

        le = eval_texture(scene.textures, le_tex[jnp.maximum(lid, 0)], C["uv"])
        # junction overrides: rev(C_{t-1}) = light origin pdf; rev(C_{t-2}) =
        # light direction pdf (cosine) -> area
        area_t = scene.lights.area[jnp.maximum(lid, 0)]
        over_c1 = (1.0 / meta.n_lights) / jnp.maximum(area_t, 1e-20)
        P = _vert_at(cv, t - 2)
        dvec = P["p"] - C["p"]
        dsq = vo.length_sq(dvec)
        dn = vo.normalize(dvec, eps=1e-12)
        # emission is one-sided along +ng; hit from the front
        cos_emit = jnp.abs(vo.dot(dn, C["ng"]))
        over_c2 = _solid_to_area(cos_emit * warps.INV_PI, dn, dsq, P["ng"], P["kind"])
        if meta.has_media:
            over_c2 = over_c2 * cv.edge_med_bwd[:, t - 2]
        if _DEBUG_FAMILY == "s0":
            w = jnp.ones((n,))
        elif _DEBUG_FAMILY:
            w = jnp.zeros((n,))
        else:
            w = _mis_weight_static(scene, cv, lv, 0, t, over_c1, over_c2, None, None)
        contrib = C["throughput"] * le * w[..., None]
        add_st = jnp.where(
            (on_light & front & tech_mask(0, t))[..., None], contrib, 0.0
        )
        eye = eye + add_st
        if pyramid:
            pyr[(0, t)] = add_st

    # ---- s >= 1, t >= 2 connections ----
    for t in range(2, k_max + 1):
        for s in range(1, k_max + 1):
            # total segments = s + t - 1 <= max_bounces  (PT parity)
            if s + t > k_max:
                continue
            C = _vert_at(cv, t - 1)
            Lv = _vert_at(lv, s - 1)
            exists = (t <= n_cv) & (s <= n_lv) & ~C["dirac"] & ~Lv["dirac"]
            exists = exists & (C["kind"] != V_INVALID) & (Lv["kind"] != V_INVALID)
            dvec = Lv["p"] - C["p"]
            dsq = jnp.maximum(vo.length_sq(dvec), 1e-20)
            dist = jnp.sqrt(dsq)
            dn = dvec / dist[..., None]

            fC, pC_solid = _vertex_fg(scene, C, C["wi"], dn)
            if s == 1:
                cosL = jnp.maximum(vo.dot(-dn, Lv["ng"]), 0.0)
                fL = (cosL * warps.INV_PI)[..., None] * jnp.ones((1, 3))
                pL_solid = jnp.zeros((n,))
                fL_scale = Lv["throughput"]  # pi*A*Le/pick
            else:
                fL, pL_solid = _vertex_fg(scene, Lv, Lv["wi"], -dn)
                fL = fL * _adjoint_factor(Lv, -dn)[..., None]
                fL_scale = Lv["throughput"]

            contrib = C["throughput"] * fC * fL * fL_scale / dsq[..., None]
            cand = exists & (jnp.any(contrib > 0.0, axis=-1)) & tech_mask(s, t)

            if meta.has_media:
                # the connection ray leaves C toward Lv: start it in C's
                # medium on THAT side (a.selectMedium(edge.d),
                # LightPath.cpp:358, PathVertex.cpp:379-388)
                med = _select_medium_dir(
                    scene, C["medium"], C["tri"], dn, C["kind"] == V_SURFACE,
                    p=C["p"],
                )
            else:
                med = jnp.full((n,), -1, jnp.int32)
            w_vis, h_vis, _ = _trace_transparent(
                scene, C["p"], dn, jnp.where(cand, dist * SHADOW_FUDGE, 0.0), med,
                C["kind"] != V_MEDIUM, Lv["kind"] != V_MEDIUM,
            )
            visible = cand & (h_vis.prim < 0)
            contrib = contrib * w_vis

            # connection-EDGE medium distance pdfs (the reference fills
            # edge.pdfForward/Backward inside generalizedShadowRayAndPdfs,
            # LightPath.cpp:358-361, and evalPdfs multiplies them into the
            # junction pdfs as nextEdge.pdfForward, PathVertex.cpp:303-325).
            # Without them the junction overrides are inconsistent with the
            # stored pdf_fwd/pdf_rev (which DO carry edge medium pdfs) and
            # the balance products bias the estimator in scattering media.
            if meta.has_media:
                from ..models.media import medium_distance_pdf

                edge_pdf_cl = medium_distance_pdf(  # C -> Lv direction
                    scene.media, med, C["p"], dn, dist,
                    start_on_surface=C["kind"] != V_MEDIUM,
                    end_on_surface=Lv["kind"] != V_MEDIUM,
                )
                edge_pdf_lc = medium_distance_pdf(  # Lv -> C direction
                    scene.media, med, Lv["p"], -dn, dist,
                    start_on_surface=Lv["kind"] != V_MEDIUM,
                    end_on_surface=C["kind"] != V_MEDIUM,
                )
            else:
                edge_pdf_cl = edge_pdf_lc = jnp.ones((n,))

            # junction overrides
            # rev(C_{t-1}): pdf of generating C from Lv
            if s == 1:
                cosL2 = jnp.maximum(vo.dot(-dn, Lv["ng"]), 0.0)
                pLC_solid = cosL2 * warps.INV_PI
            else:
                _, pLC_solid = _vertex_fg(scene, Lv, Lv["wi"], -dn)
            over_c1 = _solid_to_area(pLC_solid, -dn, dsq, C["ng"], C["kind"]) * edge_pdf_lc
            # rev(C_{t-2}): pdf at C scattering backward (wi = dir to Lv)
            P = _vert_at(cv, t - 2)
            bvec = P["p"] - C["p"]
            bsq = jnp.maximum(vo.length_sq(bvec), 1e-20)
            bn = bvec / jnp.sqrt(bsq)[..., None]
            _, pCB_solid = _vertex_fg(scene, {**C, "wi": dn}, dn, bn)
            over_c2 = _solid_to_area(pCB_solid, bn, bsq, P["ng"], P["kind"])
            if meta.has_media:
                over_c2 = over_c2 * cv.edge_med_bwd[:, t - 2]
            # rev(L_{s-1}): pdf of generating Lv from C
            _, pCL_solid = _vertex_fg(scene, C, C["wi"], dn)
            over_l1 = _solid_to_area(pCL_solid, dn, dsq, Lv["ng"], Lv["kind"]) * edge_pdf_cl
            # rev(L_{s-2}): pdf at Lv scattering backward
            if s >= 2:
                Q = _vert_at(lv, s - 2)
                qvec = Q["p"] - Lv["p"]
                qsq = jnp.maximum(vo.length_sq(qvec), 1e-20)
                qn = qvec / jnp.sqrt(qsq)[..., None]
                _, pLQ_solid = _vertex_fg(scene, {**Lv, "wi": -dn}, -dn, qn)
                over_l2 = _solid_to_area(pLQ_solid, qn, qsq, Q["ng"], Q["kind"])
                if meta.has_media:
                    over_l2 = over_l2 * lv.edge_med_bwd[:, s - 2]
            else:
                over_l2 = None

            if _DEBUG_FAMILY == "conn" or (_DEBUG_FAMILY == "s1" and s == 1):
                w = jnp.ones((n,))
            elif _DEBUG_FAMILY:
                w = jnp.zeros((n,))
            else:
                w = _mis_weight_static(scene, cv, lv, s, t, over_c1, over_c2, over_l1, over_l2)
            add_st = jnp.where(visible[..., None], contrib * w[..., None], 0.0)
            eye = eye + add_st
            if pyramid:
                pyr[(s, t)] = add_st

    # ---- t = 1: splat light-subpath vertices to the camera ----
    t1_entries = []
    for s in range(2, k_max):
        Lv = _vert_at(lv, s - 1)
        exists = (s <= n_lv) & ~Lv["dirac"] & (Lv["kind"] != V_INVALID)
        dc, distc, cam_w, pixel, vld = camera_sample_direct(scene.camera, meta, Lv["p"])
        fL, _ = _vertex_fg(scene, Lv, Lv["wi"], dc)
        fL = fL * _adjoint_factor(Lv, dc)[..., None]
        cand = exists & vld & jnp.any(fL > 0.0, axis=-1) & tech_mask(s, 1)
        if meta.has_media:
            # splat walk leaves Lv toward the camera (b.selectMedium(-d),
            # LightPath.cpp:344)
            med = _select_medium_dir(
                scene, Lv["medium"], Lv["tri"], dc, Lv["kind"] == V_SURFACE,
                p=Lv["p"],
            )
        else:
            med = jnp.full((n,), -1, jnp.int32)
        w_vis, h_vis, _ = _trace_transparent(
            scene, Lv["p"], dc, jnp.where(cand, distc * SHADOW_FUDGE, 0.0), med,
            Lv["kind"] != V_MEDIUM, jnp.ones((n,), bool),
        )
        visible = cand & (h_vis.prim < 0)
        value = Lv["throughput"] * fL * w_vis * cam_w[:, None]
        # MIS: camera side contributes only the dirac root (t=1); overrides on
        # the light walk: rev(L_{s-1}) = camera direction pdf -> area
        local_d = (-dc) @ scene.camera.rot
        cosz2 = jnp.maximum(local_d[..., 2], 1e-6)
        pdf_cam = (1.0 / ((2.0 / scene.camera.plane_dist) * (2.0 * ratio / scene.camera.plane_dist))) / (cosz2**3)
        over_l1 = _solid_to_area(pdf_cam, -dc, distc**2, Lv["ng"], Lv["kind"])
        if meta.has_media:
            # camera-edge medium distance pdf, camera -> Lv direction
            # (LightPath.cpp:383-386 semantics; camera counts as a surface
            # endpoint). The edge medium is the splat walk's start medium.
            from ..models.media import medium_distance_pdf

            over_l1 = over_l1 * medium_distance_pdf(
                scene.media, med, Lv["p"] + dc * distc[..., None], -dc, distc,
                start_on_surface=jnp.ones((n,), bool),
                end_on_surface=Lv["kind"] != V_MEDIUM,
            )
        if s >= 2:
            Q = _vert_at(lv, s - 2)
            qvec = Q["p"] - Lv["p"]
            qsq = jnp.maximum(vo.length_sq(qvec), 1e-20)
            qn = qvec / jnp.sqrt(qsq)[..., None]
            _, pLQ_solid = _vertex_fg(scene, {**Lv, "wi": dc}, dc, qn)
            over_l2 = _solid_to_area(pLQ_solid, qn, qsq, Q["ng"], Q["kind"])
            if meta.has_media:
                over_l2 = over_l2 * lv.edge_med_bwd[:, s - 2]
        else:
            over_l2 = None
        if _DEBUG_FAMILY == "t1":
            w = jnp.ones((n,))
        elif _DEBUG_FAMILY:
            w = jnp.zeros((n,))
        else:
            w = _mis_weight_static(scene, cv, lv, s, 1, None, None, over_l1, over_l2)
        if collect:
            t1_entries.append((value * w[..., None], pixel, visible))
        else:
            splat = splat_filtered(
                splat, pixel, value * w[..., None], visible, meta.res_x, meta.res_y,
                filter_name=meta.filter
            )
            if pyramid:
                pyr[(s, 1)] = splat_filtered(
                    jnp.zeros_like(splat), pixel, value * w[..., None],
                    visible, meta.res_x, meta.res_y, filter_name=meta.filter,
                )

    eye = jnp.where(jnp.isfinite(eye), eye, 0.0)
    if collect:
        if t1_entries:
            t1_val = jnp.stack([jnp.where(jnp.isfinite(v), v, 0.0) for v, _, _ in t1_entries], axis=1)
            t1_pixf = jnp.stack([p_ for _, p_, _ in t1_entries], axis=1)
            t1_ok = jnp.stack([ok for _, _, ok in t1_entries], axis=1)
        else:
            t1_val = jnp.zeros((n, 1, 3))
            t1_pixf = jnp.zeros((n, 1, 2))
            t1_ok = jnp.zeros((n, 1), bool)
        out = dict(eye=eye, t1_val=t1_val, t1_pixf=t1_pixf, t1_ok=t1_ok)
        if return_verts:
            out["cv"] = cv.tree()
            out["lv"] = lv.tree()
            out["n_cv"] = n_cv
            out["n_lv"] = n_lv
        return out
    splat = jnp.where(jnp.isfinite(splat), splat, 0.0)
    if pyramid:
        return eye, splat, pyr
    return eye, splat
