"""Wavefront unidirectional path tracer with NEE + power-heuristic MIS.

The wavefront inversion of the reference's recursive per-ray megakernel
(PathTracer::traceSample, src/core/integrators/path_tracer/PathTracer.cpp:14-149
+ TraceBase::handleSurface, TraceBase.cpp:516-568): one `lax.while_loop` over
bounce depth drives the whole sample megabatch in lockstep; dead lanes are
masked. Estimator structure is identical to the reference:

  per bounce, per lane that hit a surface:
    1. emission at hit, added only if (no NEE | previous bounce specular |
       light unsamplable) and bounce >= min_bounces      [handleSurface]
    2. NEE against one uniformly chosen light, two strategies with power
       heuristic: light sampling (shadow ray) + BSDF sampling restricted to
       non-specular lobes (full ray, counts only the chosen light)
       [estimateDirect -> lightSample + bsdfSample, TraceBase.cpp:246-321]
    3. BSDF sampling (all lobes) for the continuation ray
    4. Russian roulette after bounce 2 when max|throughput| < 0.1
       [PathTracer.cpp:111-117]
  lanes that miss: env-map contribution with the same MIS gating
       [handleInfiniteLights, TraceBase.cpp:570-578]

Differences from the reference are those of a wavefront, not semantic:
stateless counter-based RNG instead of per-thread PCG streams, masked
vectorized BSDF dispatch instead of virtual calls, fixed per-bounce
random-dimension budget so all lanes stay aligned inside the while loop.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..math import vecops as vo
from ..models.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from ..models.bsdfs.common import Lobes
from ..models.cameras import camera_rays, camera_rays_w
from ..models.primitives import analytic as A
from ..models.primitives import lights as L
from ..models.textures import eval_texture
from ..ops import intersect as isect
from ..ops.gather_bvh import (
    intersect_bvh_gather,
    intersect_bvh_gather_mixed,
    occluded_bvh_gather,
)
from ..sampling import Sampler, warps
from ..scene.flatten import DEFAULT_EPSILON, FlatScene

INF = isect.INF
DIMS_PER_BOUNCE = 24
import os as _os
# lockstep-wavefront compaction: re-sort lanes each bounce by the next
# ray's origin cell and direction octant; opt-in (TUNGSTEN_COMPACT=1)
_NO_COMPACT = _os.environ.get("TUNGSTEN_COMPACT", "") != "1"
_NO_STRAT = _os.environ.get("TUNGSTEN_NO_STRAT", "") == "1"
# debug: isolate one MIS strategy half ("light" = light-sampling strategy
# only, "bsdf" = bsdf/phase-strategy only); biased output, diagnosis only
_DBG_MIS_HALF = _os.environ.get("TUNGSTEN_DEBUG_MIS_HALF", "")
# debug: regen uses the lockstep _unified_nee_prepare/_finish light strategy
_REGEN_UNEE = _os.environ.get("TUNGSTEN_REGEN_UNEE", "") == "1"
# merged regen walk: the bounce's NEE shadow batch and next-ray batch share
# ONE 2N-lane mixed traversal (per-lane any-hit latch); 0 = two separate
# walks (the round-4 arrangement, kept for A/B measurement)
_REGEN_MERGED = _os.environ.get("TUNGSTEN_REGEN_MERGED", "1") == "1"
SHADOW_FUDGE = 1.0 - 1e-3  # cf. attenuatedEmission's 1+1e-3 (TraceBase.cpp:155)


def _intersect(scene: FlatScene, o, d, tnear, tfar):
    """Closest hit over triangles (BVH) + analytic prims. Analytic prims are
    intersected first — their t clips the BVH walk's tfar (pruning) — and the
    winner carries a virtual id >= T with (u, v) = the analytic uv."""
    if scene.ana is not None:
        from ..models.primitives.analytic import intersect_analytic

        ah = intersect_analytic(scene.ana, o, d, tnear, tfar)
        h = _intersect_tris(scene, o, d, tnear, jnp.minimum(tfar, ah.t))
        n_tris = scene.tris.v0.shape[0]
        pick_a = (ah.k >= 0) & (ah.t < h.t)
        return isect.Hit(
            t=jnp.where(pick_a, ah.t, h.t),
            prim=jnp.where(pick_a, n_tris + ah.k, h.prim),
            u=jnp.where(pick_a, ah.uv[..., 0], h.u),
            v=jnp.where(pick_a, ah.uv[..., 1], h.v),
        )
    return _intersect_tris(scene, o, d, tnear, tfar)


def _walks_bvh(scene: FlatScene) -> bool:
    """Triangles are traced by the BVH walk when the scene asks for it
    (renderer `scene_bvh`) and has more than 64 of them; otherwise by the
    brute-force test, which is cheaper for a handful of triangles."""
    return scene.meta.use_bvh and scene.tris.v0.shape[0] > 64


def _intersect_tris(scene: FlatScene, o, d, tnear, tfar):
    if _walks_bvh(scene):
        return intersect_bvh_gather(scene.gbvh, o, d, tnear, tfar)
    return isect.intersect_brute(scene.tris, o, d, tnear, tfar)


def _shading_data(scene: FlatScene, hit: isect.Hit, o, d):
    """Gather surface info for hit lanes (garbage where prim < 0, masked out).
    Analytic prims (virtual ids >= T) carry their intersectionInfo uv in
    (hit.u, hit.v) and recompute Ng from the hit point; Ns = Ng for all
    analytic types (Sphere/Disk/Cylinder intersectionInfo)."""
    tri = jnp.maximum(hit.prim, 0)
    p = o + d * hit.t[..., None]
    u = hit.u[..., None]
    v = hit.v[..., None]
    w0 = 1.0 - u - v
    # ONE packed gather for all hit-shading attributes (gathers are
    # latency-bound per op at wavefront widths; this replaces 9)
    row = scene.shade_pack[tri]
    ng = row[..., 0:3]
    ns = vo.normalize(row[..., 3:6] * w0 + row[..., 6:9] * u + row[..., 9:12] * v)
    uv = row[..., 12:14] * w0 + row[..., 14:16] * u + row[..., 16:18] * v
    mat = row[..., 18].astype(jnp.int32)
    light = row[..., 19].astype(jnp.int32)
    if scene.meta.has_analytic:
        from ..models.primitives.analytic import normal_at

        n_tris = scene.tris.v0.shape[0]
        is_a = (hit.prim >= n_tris)[..., None]
        ng_a = normal_at(scene.ana, hit.prim - n_tris, p)
        ng = jnp.where(is_a, ng_a, ng)
        ns = jnp.where(is_a, ng_a, ns)
        uv = jnp.where(is_a, jnp.concatenate([u, v], -1), uv)
    return p, ng, ns, uv, mat, light


def _occluded(scene, p, d, dist):
    """Shadow query: is the segment [eps, dist*fudge] blocked?

    Takes the any-hit walk, whose lanes latch on their first hit and leave
    the traversal (the embree rtcOccluded split,
    TraceableScene.hpp:211-223)."""
    far = jnp.where(dist >= INF, INF, dist * SHADOW_FUDGE)
    near = jnp.full(p.shape[:-1], DEFAULT_EPSILON)
    return _occluded_raw(scene, p, d, near, far)


def _forward_transparency(scene, mat_id, uv, wi):
    """bsdf.eval(makeForwardEvent()): per-lane straight-through transmission
    (nonzero only for forward-lobed materials: forward/thinsheet/transparency).
    """
    from ..models.bsdfs.dispatch import module_for_id, _gather

    ctx = (scene.materials, scene.textures)
    params, mtype, albedo = _gather(ctx, mat_id, uv)[:3]
    out = jnp.zeros(wi.shape[:-1] + (3,), jnp.float32)
    for tid in scene.materials.present:
        mod = module_for_id(tid)
        if hasattr(mod, "forward_transparency"):
            val = mod.forward_transparency(ctx, params, albedo, uv, wi)
            out = jnp.where((mtype == tid)[..., None], val, out)
    return out


def _trace_transparent(scene, o, d, far, medium, start_on_surface, end_on_surface):
    """Generalized shadow/connection walk (TraceBase::generalizedShadowRayImpl,
    TraceBase.cpp:62-125): repeatedly intersect; forward-lobed surfaces are
    crossed (throughput *= transparency, medium handoff), anything else is a
    terminal hit. Every segment is attenuated by the current medium with the
    correct surface/medium endpoint cases.

    Returns (throughput (N,3), final Hit with t measured from the *original*
    origin, final medium). Lanes that exhaust the crossing budget or hit an
    opaque surface before `far` end with throughput 0 or the terminal hit.
    """
    from ..models.media import medium_transmittance

    meta = scene.meta
    n = o.shape[0]
    max_cross = 8 if meta.has_forward else 1

    weight = jnp.ones((n, 3))
    t_base = jnp.zeros((n,))
    cur_o = o
    remaining = far
    cur_med = medium
    done = jnp.zeros((n,), bool)
    fin_t = jnp.full((n,), INF)
    fin_prim = jnp.full((n,), -1, jnp.int32)
    fin_u = jnp.zeros((n,))
    fin_v = jnp.zeros((n,))
    start_surf = start_on_surface

    for step in range(max_cross):
        h = _intersect(
            scene, cur_o, d, jnp.full((n,), DEFAULT_EPSILON),
            jnp.where(done, 0.0, remaining),
        )
        did_hit = (h.prim >= 0) & ~done
        seg = jnp.where(did_hit, h.t, remaining)
        if meta.has_media:
            end_surf = did_hit | end_on_surface
            tr = medium_transmittance(
                scene.media, cur_med, seg, start_surf, end_surf, cur_o, d
            )
            weight = jnp.where(done[..., None], weight, weight * tr)

        tri = jnp.maximum(h.prim, 0)
        ng_h, uvh = A.hit_geom(scene, h.prim, cur_o + d * h.t[..., None], h.u, h.v)
        mat_id = scene.tri_mat[tri]
        if meta.has_forward:
            lobes = scene.materials.lobes[mat_id]
            t_ax, b_ax = vo.tangent_frame(ng_h)
            wi_loc = vo.to_local(t_ax, b_ax, ng_h, -d)
            trans = _forward_transparency(scene, mat_id, uvh, wi_loc)
            can_cross = Lobes.has_forward(lobes) & jnp.any(trans > 0.0, axis=-1)
        else:
            trans = jnp.zeros((n, 3))
            can_cross = jnp.zeros((n,), bool)

        terminal = did_hit & ~can_cross
        fin_t = jnp.where(terminal, t_base + h.t, fin_t)
        fin_prim = jnp.where(terminal, h.prim, fin_prim)
        fin_u = jnp.where(terminal, h.u, fin_u)
        fin_v = jnp.where(terminal, h.v, fin_v)

        crossing = did_hit & can_cross
        weight = jnp.where(crossing[..., None], weight * trans, weight)
        if meta.has_media:
            backside = vo.dot(d, ng_h) < 0.0
            override = scene.tri_med_override[tri]
            new_med = jnp.where(
                backside, scene.tri_med_int[tri], scene.tri_med_ext[tri]
            )
            cur_med = jnp.where(crossing & override, new_med, cur_med)

        done = done | terminal | ~did_hit
        t_base = jnp.where(crossing, t_base + h.t, t_base)
        remaining = jnp.where(crossing, remaining - h.t, remaining)
        cur_o = jnp.where(crossing[..., None], cur_o + d * h.t[..., None], cur_o)
        start_surf = jnp.where(crossing, True, start_surf)
        if max_cross == 1:
            break

    # exhausted the crossing budget without resolving -> treat as blocked
    weight = jnp.where((~done)[..., None], 0.0, weight)
    return weight, isect.Hit(t=fin_t, prim=fin_prim, u=fin_u, v=fin_v), cur_med


def _select_medium_dir(scene, medium, prim, d_dir, on_surface, p=None):
    """Primitive::selectMedium for a ray LEAVING a surface vertex along
    d_dir (Primitive.hpp:177-183; used by every reference shadow/connection
    ray: TraceBase.cpp:223-224/261-262/303-304, PathVertex.cpp:379-388):
    pick int/ext medium by the side of the geometric normal d_dir exits
    through, but only when the primitive overrides media; medium-scatter
    (non-surface) lanes keep the current medium. Pass the vertex position p
    when analytic prims may occur (their normal is position-dependent)."""
    tri = jnp.maximum(prim, 0)
    ng = scene.tri_ng[tri]
    if scene.meta.has_analytic and p is not None:
        from ..models.primitives.analytic import normal_at

        n_tris = scene.tris.v0.shape[0]
        ng = jnp.where(
            (prim >= n_tris)[..., None],
            normal_at(scene.ana, prim - n_tris, p), ng)
    backside = vo.dot(d_dir, ng) < 0.0
    override = scene.tri_med_override[tri] & on_surface & (prim >= 0)
    sel = jnp.where(backside, scene.tri_med_int[tri], scene.tri_med_ext[tri])
    return jnp.where(override, sel, medium)


def _nee(scene, sampler, p, ng, frame, wi, mat_id, uv, lobes, medium=None,
         prim=None):
    """estimateDirect: one uniformly chosen light, both MIS strategies.
    Returns (N, 3) contribution (un-multiplied by throughput)."""
    meta = scene.meta
    ctx = (scene.materials, scene.textures)
    n = p.shape[0]
    t, b, nrm = frame

    u_choose, sampler = sampler.next_1d()
    li, choice_weight = L.choose_light(scene, u_choose, p)
    is_env_choice = scene.lights.is_env[li]

    u_point, sampler = sampler.next_2d()
    u_tri, sampler = sampler.next_1d()

    # --- strategy 1: light sampling -------------------------------------
    ls_area = L.sample_area_direct(scene, li, p, u_tri, u_point)
    if any(i >= 0 for i in meta.env_light_idx):
        ls_env = L.sample_env_direct(scene, li, u_point)
        ls = L._merge_ls(is_env_choice, ls_env, ls_area)
    else:
        ls = ls_area
    if any(i >= 0 for i in meta.cap_light_idx):
        is_cap_choice = scene.lights.cap_slot[li] >= 0
        ls_cap = L.sample_cap_direct(scene, li, u_point)
        ls = L._merge_ls(is_cap_choice, ls_cap, ls)
    if meta.point_light_index >= 0:
        is_point_choice = scene.lights.pt_slot[li] >= 0
        ls_pt = L.sample_point_direct(scene, li, p)
        ls = L.LightSample(
            d=vo.where3(is_point_choice, ls_pt.d, ls.d),
            dist=jnp.where(is_point_choice, ls_pt.dist, ls.dist),
            pdf=jnp.where(is_point_choice, ls_pt.pdf, ls.pdf),
            radiance=vo.where3(is_point_choice, ls_pt.radiance, ls.radiance),
            valid=jnp.where(is_point_choice, ls_pt.valid, ls.valid),
        )
    else:
        is_point_choice = jnp.zeros_like(is_env_choice)

    wo_l = vo.to_local(t, b, nrm, ls.d)
    f_l = bsdf_eval(ctx, mat_id, uv, wi, wo_l, nonspecular_only=True)
    cand = ls.valid & (ls.pdf > 0.0) & jnp.any(f_l > 0.0, axis=-1)
    mis_l = warps.power_heuristic(
        ls.pdf, bsdf_pdf(ctx, mat_id, uv, wi, wo_l, nonspecular_only=True)
    )
    mis_l = jnp.where(is_point_choice, 1.0, mis_l)  # dirac: no bsdf strategy

    # --- strategy 2: bsdf sampling (non-specular lobes) -------------------
    u_bs2, sampler = sampler.next_2d()
    u_bs1, sampler = sampler.next_1d()
    bs = bsdf_sample(ctx, mat_id, uv, wi, u_bs2, u_bs1, nonspecular_only=True)
    wo_w = vo.to_global(t, b, nrm, bs.wo)
    bs_cand = bs.valid & jnp.any(bs.weight > 0.0, axis=-1)

    shadow_far = jnp.where(
        cand, jnp.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0
    )
    if not meta.has_forward and not meta.has_media:
        # nothing to cross or attenuate: the shadow strategy needs only a
        # boolean, which the dedicated any-hit kernel answers ~25x faster
        # than a closest-hit walk; the bsdf strategy is a single closest hit
        blocked = _occluded(scene, p, ls.d, jnp.where(cand, ls.dist, 0.0))
        h = _intersect(
            scene, p, wo_w, jnp.full((n,), DEFAULT_EPSILON),
            jnp.where(bs_cand, INF, 0.0),
        )
        w_shadow = jnp.ones((n, 3))
        tr_b = jnp.ones((n, 3))
    else:
        # both strategies' rays walk in ONE 2N-lane generalized-shadow call
        # (lockstep cost is max-over-lanes, so merging halves it); the walk
        # crosses forward-lobed surfaces and attenuates by media per segment
        o2 = jnp.concatenate([p, p])
        d2 = jnp.concatenate([ls.d, wo_w])
        far2 = jnp.concatenate([shadow_far, jnp.where(bs_cand, INF, 0.0)])
        if medium is not None:
            # each strategy's ray starts in the medium on ITS side of the
            # geometric normal (TraceBase.cpp:261-262, 303-304)
            on_surf = jnp.ones((n,), bool)
            pr = prim if prim is not None else jnp.full((n,), -1, jnp.int32)
            med_l = _select_medium_dir(scene, medium, pr, ls.d, on_surf, p=p)
            med_b = _select_medium_dir(scene, medium, pr, wo_w, on_surf, p=p)
            med2 = jnp.concatenate([med_l, med_b])
        else:
            med2 = jnp.full((2 * n,), -1, jnp.int32)
        w2, h2, _ = _trace_transparent(
            scene, o2, d2, far2, med2,
            jnp.ones((2 * n,), bool), jnp.ones((2 * n,), bool),
        )
        blocked = h2.prim[:n] >= 0
        w_shadow = w2[:n]
        tr_b = w2[n:]
        h = isect.Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])
    contrib_l = f_l * ls.radiance * (mis_l / jnp.maximum(ls.pdf, 1e-30))[..., None]
    contrib_l = contrib_l * w_shadow
    contrib_l = jnp.where((cand & ~blocked)[..., None], contrib_l, 0.0)
    hit_light = jnp.where(h.prim >= 0, scene.tri_light[jnp.maximum(h.prim, 0)], -1)
    # area-light hit: must be the chosen light & front side
    hp = p + wo_w * h.t[..., None]
    tri_hit = jnp.maximum(h.prim, 0)
    ng_hit, uvh = A.hit_geom(scene, tri_hit, hp, h.u, h.v)
    front = -vo.dot(wo_w, ng_hit) > jnp.maximum(
        scene.lights.cone_cos[jnp.maximum(hit_light, 0)], 0.0
    )  # emission cone (disk cone_angle); 0 = plain front test
    e_area = eval_texture(scene.textures, scene.lights.tex[li], uvh)
    match_area = (~is_env_choice) & (hit_light == li) & front & (h.prim >= 0)
    pdf_area = L.area_direct_pdf(scene, tri_hit, p, hp, wo_w)

    if L.any_infinite_sampled(meta):
        # bsdf-strategy match for infinite lights: estimateDirect intersects
        # the CHOSEN light primitive itself (attenuatedEmission,
        # TraceBase.cpp:286-319), so a masked env still matches its OWN
        # radiance/directPdf whenever the ray escapes scene geometry
        m_inf, e_inf, pdf_inf = L.chosen_infinite_eval(scene, li, wo_w)
        match_inf = (h.prim < 0) & m_inf
        e = jnp.where(match_inf[..., None], e_inf,
                      jnp.where(match_area[..., None], e_area, 0.0))
        light_pdf = jnp.where(match_inf, pdf_inf, pdf_area)
        match = match_inf | match_area
    else:
        e = jnp.where(match_area[..., None], e_area, 0.0)
        light_pdf = pdf_area
        match = match_area

    mis_b = warps.power_heuristic(bs.pdf, light_pdf)
    contrib_b = e * bs.weight * mis_b[..., None] * tr_b
    contrib_b = jnp.where((bs_cand & match)[..., None], contrib_b, 0.0)

    # pure-specular / forward materials skip NEE entirely (sampleDirect)
    skip = Lobes.is_pure_specular(lobes) | (lobes == Lobes.FORWARD) | (lobes == 0)
    total = (contrib_l + contrib_b) * choice_weight[..., None]
    return jnp.where(skip[..., None], 0.0, total), sampler




def _volume_nee(scene, sampler, p, d_in, medium, ptype, g):
    """volumeEstimateDirect (TraceBase.cpp:323-381): one chosen light from the
    medium scatter point p, phase light-sampling + phase-sampling strategies
    with power-heuristic MIS, both attenuated by the current medium.
    Consumes exactly 5 sampler dims."""
    from ..models.media import medium_transmittance
    from ..models.phase import phase_eval, phase_sample

    meta = scene.meta
    n = p.shape[0]

    u_choose, sampler = sampler.next_1d()
    li, choice_weight = L.choose_light(scene, u_choose, p)
    is_env_choice = scene.lights.is_env[li]

    u_point, sampler = sampler.next_2d()
    u_tri, sampler = sampler.next_1d()

    ls_area = L.sample_area_direct(scene, li, p, u_tri, u_point)
    if any(i >= 0 for i in meta.env_light_idx):
        ls_env = L.sample_env_direct(scene, li, u_point)
        ls = L._merge_ls(is_env_choice, ls_env, ls_area)
    else:
        ls = ls_area
    if any(i >= 0 for i in meta.cap_light_idx):
        is_cap_choice = scene.lights.cap_slot[li] >= 0
        ls_cap = L.sample_cap_direct(scene, li, u_point)
        ls = L._merge_ls(is_cap_choice, ls_cap, ls)
    if meta.point_light_index >= 0:
        is_point_choice = scene.lights.pt_slot[li] >= 0
        ls_pt = L.sample_point_direct(scene, li, p)
        ls = L.LightSample(
            d=vo.where3(is_point_choice, ls_pt.d, ls.d),
            dist=jnp.where(is_point_choice, ls_pt.dist, ls.dist),
            pdf=jnp.where(is_point_choice, ls_pt.pdf, ls.pdf),
            radiance=vo.where3(is_point_choice, ls_pt.radiance, ls.radiance),
            valid=jnp.where(is_point_choice, ls_pt.valid, ls.valid),
        )
    else:
        is_point_choice = jnp.zeros_like(is_env_choice)

    f_l = phase_eval(ptype, g, d_in, ls.d)
    cand = ls.valid & (ls.pdf > 0.0) & (f_l > 0.0)
    mis_l = warps.power_heuristic(ls.pdf, f_l)  # phase pdf == phase eval
    mis_l = jnp.where(is_point_choice, 1.0, mis_l)  # dirac: no bsdf strategy

    # phase-sampling strategy
    u_ph, sampler = sampler.next_2d()
    w_ph, pdf_ph = phase_sample(ptype, g, d_in, u_ph)

    shadow_far = jnp.where(
        cand, jnp.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0
    )
    o2 = jnp.concatenate([p, p])
    d2 = jnp.concatenate([ls.d, w_ph])
    far2 = jnp.concatenate([shadow_far, jnp.full((n,), INF)])
    med2 = jnp.concatenate([medium, medium])
    w2, h2, _ = _trace_transparent(
        scene, o2, d2, far2, med2,
        jnp.zeros((2 * n,), bool), jnp.ones((2 * n,), bool),
    )
    blocked = h2.prim[:n] >= 0
    h = isect.Hit(t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:])

    contrib_l = (
        (f_l * mis_l / jnp.maximum(ls.pdf, 1e-30))[..., None] * ls.radiance * w2[:n]
    )
    contrib_l = jnp.where((cand & ~blocked)[..., None], contrib_l, 0.0)

    # phase strategy: did it reach the chosen light?
    tri_hit = jnp.maximum(h.prim, 0)
    hit_light = jnp.where(h.prim >= 0, scene.tri_light[tri_hit], -1)
    hp = p + w_ph * h.t[..., None]
    ng_hit, uvh = A.hit_geom(scene, tri_hit, hp, h.u, h.v)
    front = -vo.dot(w_ph, ng_hit) > jnp.maximum(
        scene.lights.cone_cos[jnp.maximum(hit_light, 0)], 0.0
    )  # emission cone (disk cone_angle); 0 = plain front test
    e_area = eval_texture(scene.textures, scene.lights.tex[li], uvh)
    match_area = (~is_env_choice) & (hit_light == li) & front & (h.prim >= 0)
    pdf_area = L.area_direct_pdf(scene, tri_hit, p, hp, w_ph)
    if L.any_infinite_sampled(meta):
        # phase-strategy match for infinite lights: volumeEstimateDirect
        # intersects the CHOSEN light primitive itself (attenuatedEmission,
        # TraceBase.cpp:286-319), so a masked env still matches its OWN
        # radiance/directPdf whenever the ray escapes scene geometry
        m_inf, e_inf, pdf_inf = L.chosen_infinite_eval(scene, li, w_ph)
        match_inf = (h.prim < 0) & m_inf
        e = jnp.where(match_inf[..., None], e_inf,
                      jnp.where(match_area[..., None], e_area, 0.0))
        light_pdf = jnp.where(match_inf, pdf_inf, pdf_area)
        match = match_inf | match_area
    else:
        e = jnp.where(match_area[..., None], e_area, 0.0)
        light_pdf = pdf_area
        match = match_area

    mis_b = warps.power_heuristic(pdf_ph, light_pdf)
    contrib_b = e * w2[n:] * mis_b[..., None]
    contrib_b = jnp.where(match[..., None], contrib_b, 0.0)

    return (contrib_l + contrib_b) * choice_weight[..., None], sampler




def _compact_sort(key, state_dict, names_3, names_1):
    """Co-permute all lane state by `key` ascending — dead lanes sink to the
    tail, alive lanes group by origin cell and direction octant so
    neighbouring lanes walk neighbouring BVH nodes. One argsort + two packed
    gathers."""
    perm = jnp.argsort(key)
    out = dict(state_dict)
    f32_cols, f32_layout = [], []
    i32_cols, i32_layout = [], []
    for name in names_3:
        a = state_dict[name]
        f32_cols.append(a.astype(jnp.float32))
        f32_layout.append((name, 3, a.dtype))
    for name in names_1:
        a = state_dict[name]
        if a.dtype == jnp.float32:
            f32_cols.append(a[:, None])
            f32_layout.append((name, 1, a.dtype))
        else:
            i32_cols.append(a.astype(jnp.int32)[:, None])
            i32_layout.append((name, 1, a.dtype))
    fpack = jnp.concatenate(f32_cols, axis=1)[perm]
    ipack = jnp.concatenate(i32_cols, axis=1)[perm] if i32_cols else None
    fi = 0
    for name, width, dtype in f32_layout:
        col = fpack[:, fi : fi + width]
        out[name] = col if width == 3 else col[:, 0]
        fi += width
    ii = 0
    for name, width, dtype in i32_layout:
        out[name] = ipack[:, ii].astype(dtype)
        ii += 1
    return out




def _unified_nee_prepare(scene, sampler, vp, ng, frame, wi, mat_id, uv, lobes,
                         scattered, d_in, ptype, g, pre=None):
    """Shared NEE setup for surface and volume vertices: one chosen light,
    light-sampling + bsdf/phase-sampling strategies. Returns the sampler and a
    dict of deferred-ray data; the actual visibility rays are merged into the
    bounce's single 3N intersect call."""
    from ..models.phase import phase_eval, phase_sample

    meta = scene.meta
    ctx = (scene.materials, scene.textures)
    n = vp.shape[0]
    t, b, nrm = frame

    u_choose, sampler = sampler.next_1d()
    li, choice_weight = L.choose_light(scene, u_choose, vp)
    is_env_choice = scene.lights.is_env[li]
    is_cap_choice = jnp.zeros_like(is_env_choice)

    u_point, sampler = sampler.next_2d()
    u_tri, sampler = sampler.next_1d()
    ls_area = L.sample_area_direct(scene, li, vp, u_tri, u_point)
    if any(i >= 0 for i in meta.env_light_idx):
        ls_env = L.sample_env_direct(scene, li, u_point)
        ls = L._merge_ls(is_env_choice, ls_env, ls_area)
    else:
        ls = ls_area
    if any(i >= 0 for i in meta.cap_light_idx):
        is_cap_choice = scene.lights.cap_slot[li] >= 0
        ls_cap = L.sample_cap_direct(scene, li, u_point)
        ls = L._merge_ls(is_cap_choice, ls_cap, ls)
    if meta.point_light_index >= 0:
        is_point_choice = scene.lights.pt_slot[li] >= 0
        ls_pt = L.sample_point_direct(scene, li, vp)
        ls = L.LightSample(
            d=vo.where3(is_point_choice, ls_pt.d, ls.d),
            dist=jnp.where(is_point_choice, ls_pt.dist, ls.dist),
            pdf=jnp.where(is_point_choice, ls_pt.pdf, ls.pdf),
            radiance=vo.where3(is_point_choice, ls_pt.radiance, ls.radiance),
            valid=jnp.where(is_point_choice, ls_pt.valid, ls.valid),
        )
    else:
        is_point_choice = jnp.zeros_like(is_env_choice)

    # strategy 1 f/pdf at the sampled light direction
    wo_l = vo.to_local(t, b, nrm, ls.d)
    f_surf = bsdf_eval(ctx, mat_id, uv, wi, wo_l, nonspecular_only=True,
                       pre=pre)
    pdf_surf = bsdf_pdf(ctx, mat_id, uv, wi, wo_l, nonspecular_only=True,
                        pre=pre)
    if meta.has_media:
        f_vol = phase_eval(ptype, g, d_in, ls.d)
        f_l = jnp.where(scattered[..., None], f_vol[..., None], f_surf)
        pdf_fwd = jnp.where(scattered, f_vol, pdf_surf)
    else:
        f_l = f_surf
        pdf_fwd = pdf_surf
    mis_l = warps.power_heuristic(ls.pdf, pdf_fwd)
    mis_l = jnp.where(is_point_choice, 1.0, mis_l)  # dirac: no bsdf strategy
    cand = ls.valid & (ls.pdf > 0.0) & jnp.any(f_l > 0.0, axis=-1)

    # strategy 2: bsdf/phase sampling (non-specular lobes)
    u_bs2, sampler = sampler.next_2d()
    u_bs1, sampler = sampler.next_1d()
    bs = bsdf_sample(ctx, mat_id, uv, wi, u_bs2, u_bs1, nonspecular_only=True,
                     pre=pre)
    wo_mis = vo.to_global(t, b, nrm, bs.wo)
    w_mis = bs.weight
    pdf_mis = bs.pdf
    mis_cand = bs.valid & jnp.any(bs.weight > 0.0, axis=-1)
    if meta.has_media:
        w_ph, pdf_ph = phase_sample(ptype, g, d_in, u_bs2)
        wo_mis = vo.where3(scattered, w_ph, wo_mis)
        w_mis = jnp.where(scattered[..., None], 1.0, w_mis)
        pdf_mis = jnp.where(scattered, pdf_ph, pdf_mis)
        mis_cand = jnp.where(scattered, True, mis_cand)

    skip = Lobes.is_pure_specular(lobes) | (lobes == Lobes.FORWARD) | (lobes == 0)
    skip = skip & ~scattered

    shadow_far = jnp.where(
        cand & ~skip, jnp.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0
    )
    mis_far = jnp.where(mis_cand & ~skip, INF, 0.0)
    return sampler, dict(
        li=li, is_env=is_env_choice, is_cap=is_cap_choice,
        ls=ls, f_l=f_l, mis_l=mis_l, cand=cand,
        wo_mis=wo_mis, w_mis=w_mis, pdf_mis=pdf_mis, mis_cand=mis_cand,
        skip=skip, shadow_far=shadow_far, mis_far=mis_far, vp=vp,
        choice_weight=choice_weight,
    )


def _unified_nee_finish(scene, data, blocked, h_mis, medium_l, medium_b,
                        scattered):
    """Consume the visibility results -> NEE contribution (N, 3).
    `blocked` is the shadow-strategy occlusion boolean (from the dedicated
    any-hit kernel or a closest-hit's prim >= 0). medium_l / medium_b are
    the per-strategy shadow-ray media, each selected by ITS direction's
    side of the geometric normal (TraceBase.cpp:261-262, 303-304)."""
    meta = scene.meta
    n = blocked.shape[0]
    ls = data["ls"]
    li = data["li"]
    is_env_choice = data["is_env"]
    choice_weight = data["choice_weight"]
    contrib_l = data["f_l"] * ls.radiance * (
        data["mis_l"] / jnp.maximum(ls.pdf, 1e-30)
    )[..., None]
    if meta.has_media:
        from ..models.media import medium_transmittance

        tr_l = medium_transmittance(
            scene.media, medium_l, ls.dist, ~scattered, jnp.ones((n,), bool),
            data["vp"], ls.d,
        )
        contrib_l = contrib_l * tr_l
    contrib_l = jnp.where((data["cand"] & ~blocked)[..., None], contrib_l, 0.0)

    h = h_mis
    tri_hit = jnp.maximum(h.prim, 0)
    hit_light = jnp.where(h.prim >= 0, scene.tri_light[tri_hit], -1)
    vp = data["vp"]
    wo_mis = data["wo_mis"]
    hp = vp + wo_mis * h.t[..., None]
    ng_mis, uvh = A.hit_geom(scene, tri_hit, hp, h.u, h.v)
    front = -vo.dot(wo_mis, ng_mis) > jnp.maximum(
        scene.lights.cone_cos[jnp.maximum(hit_light, 0)], 0.0
    )  # emission cone (disk cone_angle); 0 = plain front test
    e_area = eval_texture(scene.textures, scene.lights.tex[li], uvh)
    match_area = (~is_env_choice) & (hit_light == li) & front & (h.prim >= 0)
    pdf_area = L.area_direct_pdf(scene, tri_hit, vp, hp, wo_mis)
    if L.any_infinite_sampled(meta):
        # bsdf/phase-strategy match for infinite lights: estimateDirect
        # intersects the CHOSEN light primitive itself (attenuatedEmission,
        # TraceBase.cpp:286-319), so a masked env still matches its OWN
        # radiance/directPdf whenever the ray escapes scene geometry
        m_inf, e_inf, pdf_inf = L.chosen_infinite_eval(scene, li, wo_mis)
        match_inf = (h.prim < 0) & m_inf
        e = jnp.where(match_inf[..., None], e_inf,
                      jnp.where(match_area[..., None], e_area, 0.0))
        light_pdf = jnp.where(match_inf, pdf_inf, pdf_area)
        match = match_inf | match_area
    else:
        e = jnp.where(match_area[..., None], e_area, 0.0)
        light_pdf = pdf_area
        match = match_area

    mis_b = warps.power_heuristic(data["pdf_mis"], light_pdf)
    contrib_b = e * data["w_mis"] * mis_b[..., None]
    if meta.has_media:
        from ..models.media import medium_transmittance

        tr_b = medium_transmittance(
            scene.media, medium_b, jnp.where(h.prim >= 0, h.t, INF),
            ~scattered, jnp.ones((n,), bool), vp, wo_mis,
        )
        contrib_b = contrib_b * tr_b
    contrib_b = jnp.where((data["mis_cand"] & match)[..., None], contrib_b, 0.0)

    if _DBG_MIS_HALF == "bsdf":
        contrib_l = jnp.zeros_like(contrib_l)
    elif _DBG_MIS_HALF == "light":
        contrib_b = jnp.zeros_like(contrib_b)
    total = (contrib_l + contrib_b) * choice_weight[..., None]
    return jnp.where(data["skip"][..., None], 0.0, total)


def _strat_fields(meta, seed, lane_ids, px, py):
    """Per-lane sobol sample index + pixel key (SobolPathSampler mode:
    renderer "stratified_sampler"). Lanes are m pixel-grid repetitions, so
    rep = lane // n_pix; the pass index rides in seed[1] (trace_batch folds
    pass_start + i there with a zero base)."""
    if not getattr(meta, "stratified", False):
        return None, None
    n_pix = meta.res_x * meta.res_y
    n = px.shape[0]
    m = max(n // n_pix, 1)
    rep = (lane_ids.astype(jnp.uint32) // jnp.uint32(n_pix))
    samp = seed[1].astype(jnp.uint32) * jnp.uint32(m) + rep
    pix = py.astype(jnp.uint32) * jnp.uint32(meta.res_x) + px.astype(jnp.uint32)
    return samp, pix


def _trace_pass_fast(scene: FlatScene, seed, lane_ids, px, py, table=None):
    """Fast-path wavefront PT (no forward-lobed materials): one merged
    3N-lane intersect per bounce carries the shadow, MIS, and continuation
    rays together — a single lockstep traversal instead of three."""
    meta = scene.meta
    n = px.shape[0]
    samp_idx, pix_key = _strat_fields(meta, seed, lane_ids, px, py)
    strat = samp_idx is not None and table is None
    sampler = Sampler.create(seed, lane_ids, table, samp_idx, pix_key, strat)
    if table is not None:
        sampler = sampler.skip(1)  # table slot 0 is the MLT pixel position

    STRAT = sampler.strat
    u_cam, sampler = sampler.next_2d()
    u_lens, sampler = sampler.next_2d()
    if table is None and not _NO_STRAT and not strat:
        # stratified (0,2)-sequence AA over passes (stratified_sampler mode)
        from ..sampling.sampler import stratified_cam_2d

        u_cam = stratified_cam_2d(sampler.lane_id, seed[1])
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)
    hit0 = _intersect(
        scene, o, d, jnp.full((n,), 1e-4),
        jnp.where(cam_w > 0.0, INF, 0.0),
    )

    state = dict(
        o=o,
        d=d,
        pix=jnp.arange(n, dtype=jnp.int32),
        hit_t=hit0.t,
        hit_prim=hit0.prim,
        hit_u=hit0.u,
        hit_v=hit0.v,
        throughput=jnp.broadcast_to(cam_w[..., None], (n, 3)),
        emission=jnp.zeros((n, 3)),
        alive=cam_w > 0.0,
        was_specular=jnp.ones((n,), bool),
        medium=jnp.full((n,), meta.camera_medium, jnp.int32),
        first_scatter=jnp.ones((n,), bool),
        med_bounce=jnp.zeros((n,), jnp.int32),
        bounce=jnp.int32(0),
        base_dim=sampler.dim,
        seed=sampler.seed,
        lane_id=sampler.lane_id,
        samp_idx=sampler.samp_idx,
        pix_key=sampler.pix_key,
    )
    if meta.aovs:
        state.update(
            aov_recorded=jnp.zeros((n,), bool),
            aov_depth=jnp.zeros((n,)),
            aov_dist=jnp.zeros((n,)),
            aov_normal=jnp.zeros((n, 3)),
            aov_albedo=jnp.zeros((n, 3)),
        )

    def cond(s):
        return jnp.any(s["alive"]) & (s["bounce"] < meta.max_bounces)

    def body(s):
        bounce = s["bounce"]
        smp = Sampler(
            s["seed"], s["lane_id"], s["base_dim"] + bounce * DIMS_PER_BOUNCE,
            table, s["samp_idx"], s["pix_key"], STRAT,
        ).prefetch(8)  # one gather serves every draw site this bounce
        o, d, alive = s["o"], s["d"], s["alive"]
        throughput, emission = s["throughput"], s["emission"]
        was_specular = s["was_specular"]
        medium = s["medium"]
        first_scatter = s["first_scatter"]
        med_bounce = s["med_bounce"]
        hit = isect.Hit(t=s["hit_t"], prim=s["hit_prim"], u=s["hit_u"], v=s["hit_v"])
        did_hit = (hit.prim >= 0) & alive
        far = jnp.where(did_hit, hit.t, INF)

        # ---- medium interaction ----
        if meta.has_media:
            from ..models.media import medium_sample_distance
            from ..models.phase import phase_sample

            u_mc, smp = smp.next_1d()
            u_md, smp = smp.next_1d()
            u_mb, smp = smp.next_1d()
            ms = medium_sample_distance(
                scene.media, medium, o, d, far, first_scatter, med_bounce,
                u_mc, u_md, u_mb,
            )
            if scene.media.has_emissive_grid:
                # emission += throughput * mediumSample.emission, BEFORE the
                # weight multiply (PathTracer.cpp:56-57)
                emission = emission + jnp.where(
                    alive[..., None], throughput * ms.emission, 0.0
                )
            throughput = throughput * jnp.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface_lane = ms.exited & did_hit
            alive = alive & (scattered | (ms.exited & did_hit))
            med_bounce = jnp.where(scattered, med_bounce + 1, med_bounce)
            first_scatter = jnp.where(scattered, False, first_scatter)
            mi = jnp.maximum(medium, 0)
            ptype = scene.media.phase_type[mi]
            g = scene.media.phase_g[mi]
            vert_p = jnp.where(scattered[..., None], ms.p, jnp.zeros((n, 3)))
        else:
            smp = smp.skip(3)
            scattered = jnp.zeros((n,), bool)
            hit_surface_lane = did_hit
            alive = alive & did_hit
            ptype = jnp.zeros((n,), jnp.int32)
            g = jnp.zeros((n,))
            vert_p = jnp.zeros((n, 3))

        # ---- misses: environment ----
        miss = s["alive"] & (hit.prim < 0) & ~scattered
        if meta.has_env or meta.has_cap:
            gate = L.infinite_needs_escape_add(scene, d, was_specular)
            add_env = miss & gate & (bounce >= meta.min_bounces)
            emission = emission + jnp.where(
                add_env[..., None], throughput * L.infinite_radiance(scene, d), 0.0
            )

        # ---- surface shading data ----
        p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        lobes = scene.materials.lobes[mat_id]
        ctx = (scene.materials, scene.textures)
        hit_backside = vo.dot(ns, d) > 0.0
        flip = hit_backside & ~Lobes.is_transmissive(lobes) if meta.enable_two_sided else jnp.zeros_like(hit_backside)
        t_ax, b_ax, frame_n = _shading_frame(scene, jnp.maximum(hit.prim, 0), ns, flip)
        frame = (t_ax, b_ax, frame_n)
        wi = vo.to_local(*frame, -d)

        geo_front = -vo.dot(d, ng) > jnp.maximum(
            scene.lights.cone_cos[jnp.maximum(light_id, 0)], 0.0
        )  # emission cone (disk cone_angle); 0 reduces to the plain test
        gate_emit = (not meta.enable_light_sampling) | was_specular
        add_emit = (
            hit_surface_lane
            & (light_id >= 0)
            & geo_front
            & gate_emit
            & (bounce >= meta.min_bounces)
        )
        e_hit = eval_texture(scene.textures, scene.lights.tex[jnp.maximum(light_id, 0)], uv)
        emission = emission + jnp.where(add_emit[..., None], throughput * e_hit, 0.0)

        if meta.aovs:
            dist_new = s["aov_dist"] + jnp.where(did_hit, hit.t, 0.0)
            not_spec = ~Lobes.is_pure_specular(lobes)
            rec_now = hit_surface_lane & ~s["aov_recorded"]
            albedo_aov = eval_texture(
                scene.textures, scene.materials.albedo_tex[mat_id], uv
            ) + jnp.where((light_id >= 0)[..., None], e_hit, 0.0)
            s["aov_depth"] = jnp.where(rec_now & not_spec, dist_new, s["aov_depth"])
            s["aov_normal"] = vo.where3(rec_now & not_spec, ns, s["aov_normal"])
            s["aov_albedo"] = jnp.where((rec_now & not_spec)[..., None], albedo_aov, s["aov_albedo"])
            s["aov_recorded"] = s["aov_recorded"] | (rec_now & not_spec)
            s["aov_dist"] = dist_new

        vp = jnp.where(scattered[..., None], vert_p, p)
        throughput_vertex = throughput
        # shadow/MIS media derive from the medium AT THE VERTEX (selected
        # per strategy direction below) — snapshot it BEFORE the
        # continuation's boundary update, or NEE transmittance silently
        # evaluates in the continuation-side medium (TraceBase.cpp:261-262)
        medium_vertex = medium

        # ---- NEE prepare ----
        do_nee = meta.enable_light_sampling and meta.n_lights > 0
        from ..models.bsdfs.dispatch import _gather as _mat_gather

        mat_pre = _mat_gather(ctx, mat_id, uv)
        if do_nee:
            smp2, nee = _unified_nee_prepare(
                scene, smp, vp, ng, frame, wi, mat_id, uv, lobes,
                scattered, d, ptype, g, pre=mat_pre,
            )
            smp = smp2
            nee_gate = (hit_surface_lane | (scattered & meta.enable_volume_light_sampling)) & (
                bounce < meta.max_bounces - 1
            )
            if meta.has_media and not meta.low_order_scattering:
                nee_gate = nee_gate & jnp.where(scattered, med_bounce > 1, True)
            shadow_far = jnp.where(nee_gate, nee["shadow_far"], 0.0)
            mis_far = jnp.where(nee_gate, nee["mis_far"], 0.0)
        else:
            smp = smp.skip(5)
            shadow_far = jnp.zeros((n,))
            mis_far = jnp.zeros((n,))
            nee = None
            nee_gate = jnp.zeros((n,), bool)

        # ---- continuation sample ----
        u_c2, smp = smp.next_2d()
        u_c1, smp = smp.next_1d()
        bs = bsdf_sample(ctx, mat_id, uv, wi, u_c2, u_c1, pre=mat_pre)
        wo_w = vo.to_global(*frame, bs.wo)
        pdf_cont = bs.pdf
        if meta.has_media:
            from ..models.phase import phase_sample as _ps

            w_phase, pdf_phase = _ps(ptype, g, d, u_c2)
            wo_w = vo.where3(scattered, w_phase, wo_w)
            pdf_cont = jnp.where(scattered, pdf_phase, pdf_cont)
        weight_step = jnp.where(scattered[..., None], 1.0, bs.weight)
        throughput = throughput * jnp.where(alive[..., None], weight_step, 1.0)
        was_specular = jnp.where(
            hit_surface_lane, Lobes.has_specular(bs.lobe),
            jnp.where(
                scattered,
                jnp.asarray(not meta.enable_volume_light_sampling),
                was_specular,
            ),
        )
        alive = alive & jnp.where(hit_surface_lane, bs.valid, True)

        if meta.has_media:
            tri = jnp.maximum(hit.prim, 0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & hit_surface_lane
            new_med = jnp.where(
                backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri]
            )
            medium = jnp.where(override, new_med, medium)
            first_scatter = jnp.where(hit_surface_lane, True, first_scatter)
            med_bounce = jnp.where(hit_surface_lane, 0, med_bounce)

        alive = alive & (vo.max3(jnp.abs(throughput)) > 0.0)

        # ---- russian roulette ----
        rp = vo.max3(jnp.abs(throughput))
        u_rr, smp = smp.next_1d()
        do_rr = (bounce > 2) & (rp < 0.1)
        survive = u_rr < rp
        throughput = jnp.where(
            (do_rr & survive & alive)[..., None],
            throughput / jnp.maximum(rp, 1e-30)[..., None],
            throughput,
        )
        alive = alive & (~do_rr | survive)
        cont_alive = alive & (bounce + 1 < meta.max_bounces)

        # ---- merged [mis | continuation] closest hit + any-hit shadows ----
        # (the shadow strategy needs only a boolean: the latching any-hit
        # walk answers it cheaper than carrying it in the closest batch)
        o_new = vp
        near_cont = jnp.where(scattered, 0.0, DEFAULT_EPSILON)
        if do_nee:
            near_nee = jnp.where(scattered, 0.0, DEFAULT_EPSILON)
            shadow_blocked = _occluded_raw(
                scene, vp, nee["ls"].d, near_nee, shadow_far
            )
            o3 = jnp.concatenate([vp, o_new])
            d3 = jnp.concatenate([nee["wo_mis"], wo_w])
            near3 = jnp.concatenate([near_nee, near_cont])
            far3 = jnp.concatenate([mis_far, jnp.where(cont_alive, INF, 0.0)])
            h3 = _intersect(scene, o3, d3, near3, far3)
            h_mis = isect.Hit(t=h3.t[:n], prim=h3.prim[:n], u=h3.u[:n], v=h3.v[:n])
            h_cont = isect.Hit(
                t=h3.t[n:], prim=h3.prim[n:], u=h3.u[n:], v=h3.v[n:],
            )
            if meta.has_media:
                med_l = _select_medium_dir(
                    scene, medium_vertex, hit.prim, nee["ls"].d,
                    hit_surface_lane, p=nee["vp"],
                )
                med_b = _select_medium_dir(
                    scene, medium_vertex, hit.prim, nee["wo_mis"],
                    hit_surface_lane, p=nee["vp"],
                )
            else:
                med_l = med_b = medium_vertex
            contrib = _unified_nee_finish(
                scene, nee, shadow_blocked, h_mis, med_l, med_b, scattered
            )
            emission = emission + jnp.where(
                nee_gate[..., None], throughput_vertex * contrib, 0.0
            )
        else:
            h_cont = _intersect(
                scene, o_new, wo_w, near_cont, jnp.where(cont_alive, INF, 0.0)
            )

        new_state = dict(
            o=o_new,
            d=wo_w,
            pix=s["pix"],
            hit_t=h_cont.t,
            hit_prim=h_cont.prim,
            hit_u=h_cont.u,
            hit_v=h_cont.v,
            throughput=throughput,
            emission=emission,
            alive=alive,
            was_specular=was_specular,
            medium=medium,
            first_scatter=first_scatter,
            med_bounce=med_bounce,
            bounce=bounce + 1,
            base_dim=s["base_dim"],
            seed=s["seed"],
            lane_id=s["lane_id"],
            samp_idx=s["samp_idx"],
            pix_key=s["pix_key"],
        )
        if meta.aovs:
            new_state.update(
                aov_recorded=s["aov_recorded"],
                aov_depth=s["aov_depth"],
                aov_dist=s["aov_dist"],
                aov_normal=s["aov_normal"],
                aov_albedo=s["aov_albedo"],
            )
        if n >= 4096 and not _NO_COMPACT:
            # compaction: dead lanes sink; alive lanes group by a coarse
            # morton cell of the next ray origin + direction octant, so
            # secondary-bounce lanes stay spatially coherent
            root_lo = scene.bounds[0]
            root_ext = jnp.maximum(scene.bounds[1] - root_lo, 1e-6)
            q = jnp.clip(((o_new - root_lo) / root_ext * 4.0).astype(jnp.int32), 0, 3)
            morton = (
                (q[:, 0] & 1) | ((q[:, 1] & 1) << 1) | ((q[:, 2] & 1) << 2)
                | ((q[:, 0] >> 1) << 3) | ((q[:, 1] >> 1) << 4) | ((q[:, 2] >> 1) << 5)
            )
            oct_key = (
                (wo_w[:, 0] > 0).astype(jnp.int32)
                + 2 * (wo_w[:, 1] > 0).astype(jnp.int32)
                + 4 * (wo_w[:, 2] > 0).astype(jnp.int32)
            )
            key = jnp.where(alive, (morton << 3) | oct_key, 1 << 12)
            names_3 = ["o", "d", "throughput", "emission"]
            names_1 = [
                "pix", "hit_t", "hit_u", "hit_v", "alive", "was_specular",
                "medium", "first_scatter", "med_bounce", "lane_id", "hit_prim",
            ]
            if new_state.get("samp_idx") is not None:
                names_1 += ["samp_idx", "pix_key"]
            if meta.aovs:
                names_3 += ["aov_normal", "aov_albedo"]
                names_1 += ["aov_recorded", "aov_depth", "aov_dist"]
            new_state = _compact_sort(key, new_state, tuple(names_3), tuple(names_1))
        return new_state

    final = jax.lax.while_loop(cond, body, state)
    rad = jnp.zeros((n, 3), jnp.float32).at[final["pix"]].set(final["emission"])
    rad = jnp.where(jnp.isfinite(rad), rad, 0.0)
    if meta.aovs:
        pixf = final["pix"]
        aux = dict(
            depth=jnp.zeros((n,)).at[pixf].set(final["aov_depth"]),
            normal=jnp.zeros((n, 3)).at[pixf].set(final["aov_normal"]),
            albedo=jnp.zeros((n, 3)).at[pixf].set(final["aov_albedo"]),
        )
        return rad, aux
    return rad


def _shading_frame(scene, tri, ns, flip):
    """Local shading frame (t, b, n) with the two-sided flip applied.

    For fiber (curve) triangles the frame follows the reference
    Curves::tangentSpace convention (Curves.cpp:517-528): b = the fiber
    tangent, t = b x n — the hair BCSDF reads sin(theta) = dir.y and
    measures phi in the (x, z) normal plane (models/bsdfs/hair.py)."""
    t_ax, b_ax = vo.tangent_frame(ns)
    n_ax = ns
    if scene.meta.has_fiber_tan:
        tan = scene.tri_tan[jnp.clip(tri, 0, scene.tri_tan.shape[0] - 1)]
        has = vo.length_sq(tan) > 1e-12
        b2 = vo.normalize(tan, eps=1e-12)
        t2 = vo.normalize(jnp.cross(b2, ns), eps=1e-12)
        n2 = jnp.cross(t2, b2)
        t_ax = vo.where3(has, t2, t_ax)
        b_ax = vo.where3(has, b2, b_ax)
        n_ax = vo.where3(has, n2, n_ax)
    t_ax = vo.where3(flip, -t_ax, t_ax)
    n_ax = vo.where3(flip, -n_ax, n_ax)
    return t_ax, b_ax, n_ax


def _choose_and_sample_light(scene, sampler, p):
    """Radiance-weighted light choice (TraceBase::chooseLight) + sampleDirect
    composition over the light kinds (area / env / cap / point). Consumes 4
    sampler dims. Returns (li, is_env, is_cap, is_point, LightSample,
    choice_pdf, sampler) — LightSample.pdf excludes the choice pdf."""
    meta = scene.meta
    u_choose, sampler = sampler.next_1d()
    if meta.n_lights == 1:
        # STATIC single-light fast path: the choice, its pdf, and the light
        # KIND are all compile-time facts — no per-lane table gathers
        n1 = p.shape[0]
        li = jnp.zeros((n1,), jnp.int32)
        choice_weight = jnp.ones((n1,))
        choice_pdf = jnp.ones((n1,))
        is_env_choice = jnp.full((n1,), 0 in meta.env_light_idx)
    else:
        li, choice_weight = L.choose_light(scene, u_choose, p)
        choice_pdf = jnp.where(choice_weight > 0.0,
                               1.0 / jnp.maximum(choice_weight, 1e-30), 0.0)
        is_env_choice = scene.lights.is_env[li]
    is_cap_choice = jnp.zeros_like(is_env_choice)

    u_point, sampler = sampler.next_2d()
    u_tri, sampler = sampler.next_1d()
    ls = L.sample_area_direct(scene, li, p, u_tri, u_point)
    if any(i >= 0 for i in meta.env_light_idx):
        ls_env = L.sample_env_direct(scene, li, u_point)
        ls = L._merge_ls(is_env_choice, ls_env, ls)
    if any(i >= 0 for i in meta.cap_light_idx):
        is_cap_choice = scene.lights.cap_slot[li] >= 0
        ls_cap = L.sample_cap_direct(scene, li, u_point)
        ls = L._merge_ls(is_cap_choice, ls_cap, ls)
    if meta.point_light_index >= 0:
        is_point_choice = scene.lights.pt_slot[li] >= 0
        ls_pt = L.sample_point_direct(scene, li, p)
        ls = L.LightSample(
            d=vo.where3(is_point_choice, ls_pt.d, ls.d),
            dist=jnp.where(is_point_choice, ls_pt.dist, ls.dist),
            pdf=jnp.where(is_point_choice, ls_pt.pdf, ls.pdf),
            radiance=vo.where3(is_point_choice, ls_pt.radiance, ls.radiance),
            valid=jnp.where(is_point_choice, ls_pt.valid, ls.valid),
        )
    else:
        is_point_choice = jnp.zeros_like(is_env_choice)
    return (li, is_env_choice, is_cap_choice, is_point_choice, ls,
            choice_pdf, sampler)


def _intersect_mixed(scene, o, d, tnear, tfar, latch):
    """ONE walk for a mixed [any-hit | closest-hit] wavefront: lanes with
    latch=True record the first hit and leave the walk (only prim >= 0 is
    meaningful), latch=False lanes run closest-hit. This merges a bounce's
    shadow + continuation rays into a single traversal whose straggler
    phases amortize over both ray classes. Scenes traced by brute force
    take a plain closest-hit query (same booleans)."""
    if not _walks_bvh(scene):
        return _intersect(scene, o, d, tnear, tfar)
    if scene.ana is not None:
        from ..models.primitives.analytic import intersect_analytic

        n_tris = scene.tris.v0.shape[0]
        ah = intersect_analytic(scene.ana, o, d, tnear, tfar)
        h = intersect_bvh_gather_mixed(
            scene.gbvh, o, d, tnear, jnp.minimum(tfar, ah.t), latch)
        pick_a = (ah.k >= 0) & (ah.t < h.t)
        return isect.Hit(
            t=jnp.where(pick_a, ah.t, h.t),
            prim=jnp.where(pick_a, n_tris + ah.k, h.prim),
            u=jnp.where(pick_a, ah.uv[..., 0], h.u),
            v=jnp.where(pick_a, ah.uv[..., 1], h.v),
        )
    return intersect_bvh_gather_mixed(scene.gbvh, o, d, tnear, tfar, latch)


def _occluded_raw(scene, p, d, near, far):
    """Any-hit boolean for explicit [near, far] segments (shadow strategy)."""
    if scene.ana is not None:
        from ..models.primitives.analytic import occluded_analytic

        blocked_a = occluded_analytic(scene.ana, p, d, near, far)
        # analytically-blocked lanes skip the triangle walk (far = 0)
        far2 = jnp.where(blocked_a, 0.0, far)
        return blocked_a | _occluded_raw_tris(scene, p, d, near, far2)
    return _occluded_raw_tris(scene, p, d, near, far)


def _occluded_raw_tris(scene, p, d, near, far):
    if _walks_bvh(scene):
        return occluded_bvh_gather(scene.gbvh, p, d, near, far)
    return _intersect_tris(scene, p, d, near, far).prim >= 0


@partial(jax.jit, static_argnames=("n_passes",))
def trace_regen_batch(scene: FlatScene, seed, px_cycle, py_cycle, pix_cycle,
                      pass_base, n_passes=1):
    """Regenerating (persistent-threads) wavefront PT — the wavefront analog of a
    GPU megakernel with path regeneration [Laine et al. 2013 wavefront
    formulation]: a fixed-width W wavefront where every lane that finishes
    its path immediately respawns a fresh camera path from the remaining
    budget of n_passes * W paths. Occupancy stays near 100% across the
    whole batch instead of decaying with the lockstep bounce loop (the
    reference's thread pool gets this for free — tiles retire per-thread,
    PathTraceIntegrator.cpp:136-156; a lockstep while_loop does not).

    Estimator: NEE with single-sample MIS — the light strategy (any-hit
    shadow kernel) pairs with the CONTINUATION bsdf sample, whose hit
    emission is weighted by power_heuristic(pdf_cont, light_direct_pdf) at
    the next vertex (the PBRT-style arrangement). This halves the
    closest-hit work per bounce vs the reference's separate bsdf-strategy
    ray (TraceBase::estimateDirect) while estimating the same integral with
    the same two-strategy MIS; the reference-structured estimator remains in
    trace_pass. Per iteration the kernels are ONE any-hit (shadow) + ONE
    closest-hit (continuation).

    Radiance is accumulated DEVICE-side: completed paths scatter-add into a
    per-pixel (n_pix, 3) buffer (AOVs likewise). RNG streams key on the
    global path id, so results are independent of W and of how paths
    interleave. Returns rad (n_pix, 3) [and aux per-pixel sums if AOVs]."""
    meta = scene.meta
    assert not meta.has_forward, "regen path: forward lobes need trace_pass"
    W = px_cycle.shape[0]
    n_pix = meta.res_x * meta.res_y
    m = max(W // n_pix, 1)
    strat = bool(getattr(meta, "stratified", False))
    total = jnp.uint32(n_passes * W)
    do_nee = meta.enable_light_sampling and meta.n_lights > 0
    want_aovs = bool(meta.aovs)
    ctx = (scene.materials, scene.textures)
    n = W

    def regen(s):
        """Respawn dead lanes with the next path ids; past-budget lanes idle."""
        dead = ~s["alive"]
        ranks = jnp.cumsum(dead.astype(jnp.uint32)) - jnp.uint32(1)
        new_id = s["next_id"] + jnp.where(dead, ranks, jnp.uint32(0))
        take = dead & (new_id < total)
        next_id = s["next_id"] + jnp.sum(dead.astype(jnp.uint32))
        cyc = jnp.where(take, (new_id % jnp.uint32(W)).astype(jnp.int32), 0)
        pxn, pyn = px_cycle[cyc], py_cycle[cyc]
        pass_idx = pass_base.astype(jnp.uint32) + new_id // jnp.uint32(W)
        # global path id = RNG stream key, W-independent AND batch-unique:
        # pass_base must fold in, or successive driver batches replay the
        # SAME per-path randoms (spp stops reducing variance, A/B halves
        # collapse) — only the in-invocation id is new_id
        lane_key = pass_base.astype(jnp.uint32) * jnp.uint32(W) + new_id
        if strat:
            samp_idx = pass_idx * jnp.uint32(m) + (cyc // n_pix).astype(jnp.uint32)
            pix_key = pyn.astype(jnp.uint32) * jnp.uint32(meta.res_x) + pxn.astype(jnp.uint32)
        else:
            samp_idx = s["samp_idx"]
            pix_key = s["pix_key"]
        smp = Sampler.create(seed, lane_key, None,
                             samp_idx if strat else None,
                             pix_key if strat else None, strat)
        u_cam, smp = smp.next_2d()
        u_lens, smp = smp.next_2d()
        if not strat and not _NO_STRAT:
            from ..sampling.sampler import stratified_cam_2d

            u_cam = stratified_cam_2d(cyc.astype(jnp.uint32), pass_idx)
        o_c, d_c, cam_w = camera_rays_w(scene.camera, meta, pxn, pyn, u_cam, u_lens)
        t3 = take[..., None]
        out = dict(s)
        out["o"] = jnp.where(t3, o_c, s["o"])
        out["d"] = jnp.where(t3, d_c, s["d"])
        out["near"] = jnp.where(take, 1e-4, s["near"])
        out["pix"] = jnp.where(take, pix_cycle[cyc], s["pix"])
        out["lane_key"] = jnp.where(take, lane_key, s["lane_key"])
        if strat:
            out["samp_idx"] = jnp.where(take, samp_idx, s["samp_idx"])
            out["pix_key"] = jnp.where(take, pix_key, s["pix_key"])
        out["throughput"] = jnp.where(t3, cam_w[..., None], s["throughput"])
        out["emission"] = jnp.where(t3, 0.0, s["emission"])
        # a cat-eye-vignetted camera sample is one path contributing 0
        # (its budget id is consumed, the lane respawns next iteration)
        out["alive"] = s["alive"] | (take & (cam_w > 0.0))
        out["was_specular"] = jnp.where(take, True, s["was_specular"])
        out["medium"] = jnp.where(take, meta.camera_medium, s["medium"])
        out["first_scatter"] = jnp.where(take, True, s["first_scatter"])
        out["med_bounce"] = jnp.where(take, 0, s["med_bounce"])
        out["bounce"] = jnp.where(take, 0, s["bounce"])
        out["pdf_cont"] = jnp.where(take, 1.0, s["pdf_cont"])
        out["nee_active"] = jnp.where(take, False, s["nee_active"])
        out["next_id"] = next_id
        if want_aovs:
            out["aov_recorded"] = jnp.where(take, False, s["aov_recorded"])
            out["aov_depth"] = jnp.where(take, 0.0, s["aov_depth"])
            out["aov_dist"] = jnp.where(take, 0.0, s["aov_dist"])
            out["aov_normal"] = jnp.where(t3, 0.0, s["aov_normal"])
            out["aov_albedo"] = jnp.where(t3, 0.0, s["aov_albedo"])
        return out

    zero3 = jnp.zeros((W, 3))
    state = dict(
        o=zero3,
        d=jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (W, 3)),
        near=jnp.full((W,), 1e-4),
        pix=jnp.zeros((W,), jnp.int32),
        lane_key=jnp.zeros((W,), jnp.uint32),
        samp_idx=jnp.zeros((W,), jnp.uint32) if strat else None,
        pix_key=jnp.zeros((W,), jnp.uint32) if strat else None,
        hit_t=jnp.full((W,), INF),
        hit_prim=jnp.full((W,), -1, jnp.int32),
        hit_u=jnp.zeros((W,)),
        hit_v=jnp.zeros((W,)),
        throughput=jnp.ones((W, 3)),
        emission=jnp.zeros((W, 3)),
        alive=jnp.zeros((W,), bool),
        was_specular=jnp.ones((W,), bool),
        medium=jnp.full((W,), meta.camera_medium, jnp.int32),
        first_scatter=jnp.ones((W,), bool),
        med_bounce=jnp.zeros((W,), jnp.int32),
        bounce=jnp.zeros((W,), jnp.int32),
        pdf_cont=jnp.ones((W,)),
        nee_active=jnp.zeros((W,), bool),
        next_id=jnp.uint32(0),
        rad_pix=jnp.zeros((n_pix, 3)),
    )
    if want_aovs:
        state.update(
            aov_recorded=jnp.zeros((W,), bool),
            aov_depth=jnp.zeros((W,)),
            aov_dist=jnp.zeros((W,)),
            aov_normal=zero3,
            aov_albedo=zero3,
            aov_depth_pix=jnp.zeros((n_pix,)),
            aov_normal_pix=jnp.zeros((n_pix, 3)),
            aov_albedo_pix=jnp.zeros((n_pix, 3)),
        )

    state = regen(state)
    h0 = _intersect(scene, state["o"], state["d"], state["near"],
                    jnp.where(state["alive"], INF, 0.0))
    state.update(hit_t=h0.t, hit_prim=h0.prim, hit_u=h0.u, hit_v=h0.v)

    def cond(s):
        return jnp.any(s["alive"])

    def body(s):
        bounce = s["bounce"]  # (W,) per-lane
        smp = Sampler(seed, s["lane_key"], jnp.int32(2) + bounce * DIMS_PER_BOUNCE,
                      None, s["samp_idx"], s["pix_key"], strat).prefetch(8)  # one gather serves every draw site
        o, d, alive = s["o"], s["d"], s["alive"]
        throughput, emission = s["throughput"], s["emission"]
        was_specular = s["was_specular"]
        medium = s["medium"]
        first_scatter = s["first_scatter"]
        med_bounce = s["med_bounce"]
        hit = isect.Hit(t=s["hit_t"], prim=s["hit_prim"], u=s["hit_u"], v=s["hit_v"])
        did_hit = (hit.prim >= 0) & alive

        far = jnp.where(did_hit, hit.t, INF)

        # ---- medium interaction ----
        if meta.has_media:
            from ..models.media import medium_sample_distance

            u_mc, smp = smp.next_1d()
            u_md, smp = smp.next_1d()
            u_mb, smp = smp.next_1d()
            ms = medium_sample_distance(
                scene.media, medium, o, d, far, first_scatter, med_bounce,
                u_mc, u_md, u_mb,
            )
            if scene.media.has_emissive_grid:
                emission = emission + jnp.where(
                    alive[..., None], throughput * ms.emission, 0.0
                )
            throughput = throughput * jnp.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface_lane = ms.exited & did_hit
            alive = alive & (scattered | (ms.exited & did_hit))
            med_bounce = jnp.where(scattered, med_bounce + 1, med_bounce)
            first_scatter = jnp.where(scattered, False, first_scatter)
            mi = jnp.maximum(medium, 0)
            ptype = scene.media.phase_type[mi]
            g = scene.media.phase_g[mi]
            vert_p = jnp.where(scattered[..., None], ms.p, jnp.zeros((n, 3)))
        else:
            smp = smp.skip(3)
            scattered = jnp.zeros((n,), bool)
            hit_surface_lane = did_hit
            alive = alive & did_hit
            ptype = jnp.zeros((n,), jnp.int32)
            g = jnp.zeros((n,))
            vert_p = jnp.zeros((n, 3))

        # ---- misses: environment (MIS vs the previous vertex's light
        # strategy; an unsamplable winner has pdf 0 -> weight 1, the
        # handleInfiniteLights gate) ----
        miss = s["alive"] & (hit.prim < 0) & ~scattered
        do_nee = meta.enable_light_sampling and meta.n_lights > 0
        mis_applies = ~was_specular & s["nee_active"] if do_nee else jnp.zeros((n,), bool)
        if meta.has_env or meta.has_cap:
            if do_nee:
                lp_inf = (L.infinite_winner_pdf(scene, d)
                          * L.infinite_winner_choice_pdf(scene, d, o))
                w_env = jnp.where(
                    mis_applies, warps.power_heuristic(s["pdf_cont"], lp_inf), 1.0
                )
            else:
                w_env = jnp.ones((n,))
            add_env = miss & (bounce >= meta.min_bounces)
            emission = emission + jnp.where(
                add_env[..., None],
                throughput * L.infinite_radiance(scene, d) * w_env[..., None],
                0.0,
            )

        # ---- surface shading data ----
        p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        # ONE material gather per bounce serves params + type + albedo
        # (header pre-packed) + the lobe mask, shared by the NEE eval/pdf
        # and the continuation sample (gathers are latency-bound per op)
        from ..models.bsdfs.dispatch import _gather as _mat_gather

        mat_pre = _mat_gather(ctx, mat_id, uv)
        lobes = mat_pre[3]
        cx = ctx
        if len(mat_pre) > 4:
            # stash the pre-fetched substrate row: nested dispatch inside
            # wrapper bsdfs (smooth_coat etc.) reads it instead of gathering
            cx = (ctx[0].replace(sub_pre=mat_pre[4]), ctx[1])
            mat_pre = mat_pre[:4]
        hit_backside = vo.dot(ns, d) > 0.0
        flip = hit_backside & ~Lobes.is_transmissive(lobes) if meta.enable_two_sided else jnp.zeros_like(hit_backside)
        t_ax, b_ax, frame_n = _shading_frame(scene, jnp.maximum(hit.prim, 0), ns, flip)
        frame = (t_ax, b_ax, frame_n)
        wi = vo.to_local(*frame, -d)

        if scene.lights.has_surface:
            geo_front = -vo.dot(d, ng) > jnp.maximum(
                scene.lights.cone_cos[jnp.maximum(light_id, 0)], 0.0
            )
            if do_nee:
                tri_e = jnp.maximum(hit.prim, 0)
                hl_e = light_id
                lp_hit = (L.area_direct_pdf(scene, tri_e, o, p, d)
                          * L.light_choice_pdf(scene, jnp.maximum(hl_e, 0), o))
                w_emit = jnp.where(
                    mis_applies, warps.power_heuristic(s["pdf_cont"], lp_hit), 1.0
                )
                if _DBG_MIS_HALF == "light":
                    w_emit = jnp.where(mis_applies, 0.0, w_emit)
            else:
                w_emit = jnp.ones((n,))
            add_emit = (
                hit_surface_lane
                & (light_id >= 0)
                & geo_front
                & (bounce >= meta.min_bounces)
            )
            e_hit = eval_texture(
                scene.textures, scene.lights.tex[jnp.maximum(light_id, 0)],
                uv, may=scene.lights.emit_kinds,
            )
            emission = emission + jnp.where(
                add_emit[..., None], throughput * e_hit * w_emit[..., None], 0.0
            )
        else:
            # no surface emitters in the scene: the whole hit-emitter block
            # (cone gather, texture eval, area pdf) is statically absent
            e_hit = jnp.zeros((n, 3))

        if want_aovs:
            dist_new = s["aov_dist"] + jnp.where(did_hit, hit.t, 0.0)
            not_spec = ~Lobes.is_pure_specular(lobes)
            rec_now = hit_surface_lane & ~s["aov_recorded"]
            albedo_aov = eval_texture(
                scene.textures, scene.materials.albedo_tex[mat_id], uv
            ) + jnp.where((light_id >= 0)[..., None], e_hit, 0.0)
            aov_depth = jnp.where(rec_now & not_spec, dist_new, s["aov_depth"])
            aov_normal = vo.where3(rec_now & not_spec, ns, s["aov_normal"])
            aov_albedo = jnp.where((rec_now & not_spec)[..., None], albedo_aov, s["aov_albedo"])
            aov_recorded = s["aov_recorded"] | (rec_now & not_spec)

        vp = jnp.where(scattered[..., None], vert_p, p)
        throughput_vertex = throughput

        # ---- NEE: light strategy only (single-sample MIS; the bsdf
        # strategy is the continuation sample, weighted at its hit) ----
        if do_nee and _REGEN_UNEE:
            smp, nee = _unified_nee_prepare(
                scene, smp, vp, ng, frame, wi, mat_id, uv, lobes,
                scattered, d, ptype, g,
            )
            nee_gate = (
                hit_surface_lane | (scattered & meta.enable_volume_light_sampling)
            ) & (bounce < meta.max_bounces - 1)
            if meta.has_media and not meta.low_order_scattering:
                nee_gate = nee_gate & jnp.where(scattered, med_bounce > 1, True)
            shadow_far_u = jnp.where(nee_gate, nee["shadow_far"], 0.0)
            near_nee = jnp.where(scattered, 0.0, DEFAULT_EPSILON)
            blocked = _occluded_raw(scene, vp, nee["ls"].d, near_nee, shadow_far_u)
            dummy = isect.Hit(
                t=jnp.zeros((n,)), prim=jnp.full((n,), -1, jnp.int32),
                u=jnp.zeros((n,)), v=jnp.zeros((n,)),
            )
            # this path traces NO bsdf-strategy ray (the continuation sample
            # is the bsdf half, weighted at its own hit) — suppress the
            # finish's bsdf-strategy term explicitly instead of relying on
            # the dummy prim=-1, which is exactly the infinite-light match
            nee = dict(nee)
            nee["mis_cand"] = jnp.zeros_like(nee["mis_cand"])
            if meta.has_media:
                med_l = _select_medium_dir(
                    scene, medium, hit.prim, nee["ls"].d, hit_surface_lane,
                    p=nee["vp"],
                )
                med_b = _select_medium_dir(
                    scene, medium, hit.prim, nee["wo_mis"], hit_surface_lane,
                    p=nee["vp"],
                )
            else:
                med_l = med_b = medium
            contrib = _unified_nee_finish(
                scene, nee, blocked, dummy, med_l, med_b, scattered
            )
            emission = emission + jnp.where(
                nee_gate[..., None], throughput_vertex * contrib, 0.0
            )
            nee_pending = None
        elif do_nee:
            from ..models.phase import phase_eval

            (li, is_env_c, is_cap_c, is_point_c, ls, cp_pick,
             smp) = _choose_and_sample_light(scene, smp, vp)
            wo_l = vo.to_local(*frame, ls.d)
            f_l = bsdf_eval(cx, mat_id, uv, wi, wo_l, nonspecular_only=True,
                            pre=mat_pre)
            # competing strategy = the continuation sampler's density over
            # continuous directions (full pdf incl. lobe-selection weight)
            pdf_b = bsdf_pdf(cx, mat_id, uv, wi, wo_l, pre=mat_pre)
            if meta.has_media:
                fp = phase_eval(ptype, g, d, ls.d)
                f_l = jnp.where(scattered[..., None], fp[..., None], f_l)
                pdf_b = jnp.where(scattered, fp, pdf_b)
            w_light = warps.power_heuristic(ls.pdf * cp_pick, pdf_b)
            w_light = jnp.where(is_point_c, 1.0, w_light)  # dirac light
            if L.any_infinite_sampled(meta):
                # masked infinite choice: the continuation escape (the bsdf
                # half of this single-sample MIS pair) credits only the LAST
                # intersecting infinite along ls.d. When that winner is NOT
                # the chosen light, the light strategy is the SOLE estimator
                # for it and its MIS weight must be 1 — the reference instead
                # traces a dedicated bsdf ray at the chosen light
                # (TraceBase.cpp:286-319); weight 1 keeps the same
                # expectation in this arrangement
                wl_d, _, _ = L.escape_winner(scene, ls.d, want_radiance=False)
                inf_choice = is_env_c | is_cap_c
                w_light = jnp.where(inf_choice & (wl_d != li), 1.0, w_light)
            skip_l = (
                Lobes.is_pure_specular(lobes) | (lobes == Lobes.FORWARD) | (lobes == 0)
            ) & ~scattered
            nee_gate = (
                hit_surface_lane
                | (scattered & meta.enable_volume_light_sampling)
            ) & (bounce < meta.max_bounces - 1)
            if meta.has_media and not meta.low_order_scattering:
                nee_gate = nee_gate & jnp.where(scattered, med_bounce > 1, True)
            cand = (
                ls.valid & (ls.pdf > 0.0) & jnp.any(f_l > 0.0, axis=-1)
                & ~skip_l & nee_gate
            )
            shadow_far = jnp.where(
                cand, jnp.where(ls.dist >= INF, INF, ls.dist * SHADOW_FUDGE), 0.0
            )
            near_nee = jnp.where(scattered, 0.0, DEFAULT_EPSILON)
            contrib_l = f_l * ls.radiance * (
                w_light / jnp.maximum(ls.pdf * cp_pick, 1e-30)
            )[..., None]
            if meta.has_media:
                from ..models.media import medium_transmittance

                med_l = _select_medium_dir(
                    scene, medium, hit.prim, ls.d, hit_surface_lane, p=vp
                )
                tr_l = medium_transmittance(
                    scene.media, med_l, ls.dist, ~scattered,
                    jnp.ones((n,), bool), vp, ls.d,
                )
                contrib_l = contrib_l * tr_l
            contrib_l = jnp.where(
                jnp.all(jnp.isfinite(contrib_l), axis=-1)[..., None], contrib_l, 0.0
            )
            if _DBG_MIS_HALF == "bsdf":
                contrib_l = jnp.zeros_like(contrib_l)
            nee_add = jnp.where(
                cand[..., None], throughput_vertex * contrib_l, 0.0
            )
            if _REGEN_MERGED:
                # defer the shadow trace: it rides the SAME walk as the
                # next-ray batch below, and the contribution scatter-adds
                # straight into rad_pix once `blocked` is known (the lane
                # emission accumulator never sees it — same total sum)
                nee_pending = (nee_add, vp, ls.d, near_nee, shadow_far)
            else:
                blocked = _occluded_raw(scene, vp, ls.d, near_nee, shadow_far)
                emission = emission + jnp.where(
                    blocked[..., None], 0.0, nee_add
                )
                nee_pending = None
        else:
            smp = smp.skip(4)
            nee_gate = jnp.zeros((n,), bool)
            nee_pending = None

        # ---- continuation sample ----
        u_c2, smp = smp.next_2d()
        u_c1, smp = smp.next_1d()
        bs = bsdf_sample(cx, mat_id, uv, wi, u_c2, u_c1, pre=mat_pre)
        wo_w = vo.to_global(*frame, bs.wo)
        pdf_cont = bs.pdf
        if meta.has_media:
            from ..models.phase import phase_sample as _ps

            w_phase, pdf_phase = _ps(ptype, g, d, u_c2)
            wo_w = vo.where3(scattered, w_phase, wo_w)
            pdf_cont = jnp.where(scattered, pdf_phase, pdf_cont)
        weight_step = jnp.where(scattered[..., None], 1.0, bs.weight)
        throughput = throughput * jnp.where(alive[..., None], weight_step, 1.0)
        was_specular = jnp.where(
            hit_surface_lane, Lobes.has_specular(bs.lobe),
            jnp.where(
                scattered,
                jnp.asarray(not meta.enable_volume_light_sampling),
                was_specular,
            ),
        )
        alive = alive & jnp.where(hit_surface_lane, bs.valid, True)

        if meta.has_media:
            tri = jnp.maximum(hit.prim, 0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & hit_surface_lane
            new_med = jnp.where(
                backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri]
            )
            medium = jnp.where(override, new_med, medium)
            first_scatter = jnp.where(hit_surface_lane, True, first_scatter)
            med_bounce = jnp.where(hit_surface_lane, 0, med_bounce)

        alive = alive & (vo.max3(jnp.abs(throughput)) > 0.0)

        # ---- russian roulette ----
        rp = vo.max3(jnp.abs(throughput))
        u_rr, smp = smp.next_1d()
        do_rr = (bounce > 2) & (rp < 0.1)
        survive = u_rr < rp
        throughput = jnp.where(
            (do_rr & survive & alive)[..., None],
            throughput / jnp.maximum(rp, 1e-30)[..., None],
            throughput,
        )
        alive = alive & (~do_rr | survive)
        alive = alive & (bounce + 1 < meta.max_bounces)

        # ---- deposit finished paths, then respawn their lanes ----
        fin = s["alive"] & ~alive
        em_clean = jnp.where(jnp.isfinite(emission), emission, 0.0)
        # finished-path deposit: DEFERRED to ride the NEE deposit's scatter
        # below (same index vector -> one scatter-add per bounce; each XLA
        # scatter costs a fixed ~0.3 ms at wavefront widths)
        dep_val = jnp.where(fin[..., None], em_clean, 0.0)
        rad_pix = s["rad_pix"]
        old_pix = s["pix"]

        s2 = dict(s)
        s2.update(
            o=vp, d=wo_w,
            near=jnp.where(scattered, 0.0, DEFAULT_EPSILON),
            throughput=throughput, emission=emission, alive=alive,
            was_specular=was_specular, medium=medium,
            first_scatter=first_scatter, med_bounce=med_bounce,
            bounce=bounce + 1, rad_pix=rad_pix,
            pdf_cont=pdf_cont, nee_active=nee_gate,
        )
        if want_aovs:
            dep_pix = jnp.where(fin, old_pix, 0)
            s2.update(
                aov_recorded=aov_recorded,
                aov_depth=aov_depth,
                aov_dist=dist_new,
                aov_normal=aov_normal,
                aov_albedo=aov_albedo,
                aov_depth_pix=s["aov_depth_pix"].at[dep_pix].add(
                    jnp.where(fin, aov_depth, 0.0)
                ),
                aov_normal_pix=s["aov_normal_pix"].at[dep_pix].add(
                    jnp.where(fin[..., None], aov_normal, 0.0)
                ),
                aov_albedo_pix=s["aov_albedo_pix"].at[dep_pix].add(
                    jnp.where(fin[..., None], aov_albedo, 0.0)
                ),
            )
        s2 = regen(s2)

        # ---- next-ray closest hit (continuation | fresh camera ray),
        # merged with the deferred NEE shadow batch: one 2N mixed walk ----
        far_next = jnp.where(s2["alive"], INF, 0.0)
        if nee_pending is not None:
            nee_add, svp, sd, snear, sfar = nee_pending
            o2 = jnp.concatenate([svp, s2["o"]])
            d2 = jnp.concatenate([sd, s2["d"]])
            nr2 = jnp.concatenate([snear, s2["near"]])
            fr2 = jnp.concatenate([sfar, far_next])
            latch2 = jnp.concatenate(
                [jnp.ones((n,), bool), jnp.zeros((n,), bool)]
            )
            h2 = _intersect_mixed(scene, o2, d2, nr2, fr2, latch2)
            blocked = h2.prim[:n] >= 0
            h_next = isect.Hit(
                t=h2.t[n:], prim=h2.prim[n:], u=h2.u[n:], v=h2.v[n:]
            )
            # ONE scatter: the finished-path deposit + the NEE contribution,
            # both indexed by the pre-regen pixel
            s2["rad_pix"] = s2["rad_pix"].at[old_pix].add(
                dep_val + jnp.where(blocked[..., None], 0.0, nee_add)
            )
        else:
            s2["rad_pix"] = s2["rad_pix"].at[old_pix].add(dep_val)
            h_next = _intersect(scene, s2["o"], s2["d"], s2["near"], far_next)

        s2.update(hit_t=h_next.t, hit_prim=h_next.prim, hit_u=h_next.u, hit_v=h_next.v)
        return s2

    final = jax.lax.while_loop(cond, body, state)
    rad = final["rad_pix"]
    if want_aovs:
        aux = dict(
            depth=final["aov_depth_pix"],
            normal=final["aov_normal_pix"],
            albedo=final["aov_albedo_pix"],
        )
        return rad, aux
    return rad


@partial(jax.jit, static_argnames=("n_passes",))
def trace_batch(scene: FlatScene, seed, lane_base, px, py, pass_start, n_passes=1):
    """Accumulate n_passes wavefront passes in one dispatch (fori_loop) —
    amortizes launch and transfer latency.
    Returns summed radiance (N, 3)."""

    want_aovs = bool(scene.meta.aovs)

    def body(i, acc):
        pass_seed = jnp.stack([seed[0], seed[1] + (pass_start + i).astype(jnp.uint32)])
        out = trace_pass(scene, pass_seed, lane_base, px, py)
        return jax.tree.map(lambda a, b: a + b, acc, out)

    zero = jnp.zeros(px.shape + (3,), jnp.float32)
    if want_aovs:
        init = (zero, dict(depth=jnp.zeros(px.shape), normal=zero, albedo=zero))
    else:
        init = zero
    return jax.lax.fori_loop(0, n_passes, body, init)


@jax.jit
def trace_pass(scene: FlatScene, seed, lane_ids, px, py, table=None):
    """Trace one sample for each lane. Returns radiance (N, 3).

    Dispatches to the merged-intersect fast path unless the scene has
    forward-lobed materials (which need the crossing-walk NEE).
    table: optional MLT primary-sample table (see Sampler)."""
    meta = scene.meta
    if not meta.has_forward:
        return _trace_pass_fast(scene, seed, lane_ids, px, py, table)
    n = px.shape[0]
    samp_idx, pix_key = _strat_fields(meta, seed, lane_ids, px, py)
    sampler = Sampler.create(
        seed, lane_ids, None, samp_idx, pix_key, samp_idx is not None
    )
    STRAT = sampler.strat

    u_cam, sampler = sampler.next_2d()
    u_lens, sampler = sampler.next_2d()
    o, d, cam_w = camera_rays_w(scene.camera, meta, px, py, u_cam, u_lens)

    state = dict(
        o=o,
        d=d,
        pix=jnp.arange(n, dtype=jnp.int32),
        near=jnp.full((n,), 1e-4),
        throughput=jnp.broadcast_to(cam_w[..., None], (n, 3)),
        emission=jnp.zeros((n, 3)),
        alive=cam_w > 0.0,
        was_specular=jnp.ones((n,), bool),
        medium=jnp.full((n,), meta.camera_medium, jnp.int32),
        first_scatter=jnp.ones((n,), bool),
        med_bounce=jnp.zeros((n,), jnp.int32),
        bounce=jnp.int32(0),
        base_dim=sampler.dim,
        seed=sampler.seed,
        lane_id=sampler.lane_id,
        samp_idx=sampler.samp_idx,
        pix_key=sampler.pix_key,
    )
    if meta.aovs:
        state.update(
            aov_recorded=jnp.zeros((n,), bool),
            aov_depth=jnp.zeros((n,)),
            aov_dist=jnp.zeros((n,)),
            aov_normal=jnp.zeros((n, 3)),
            aov_albedo=jnp.zeros((n, 3)),
        )

    def cond(s):
        return jnp.any(s["alive"]) & (s["bounce"] < meta.max_bounces)

    def body(s):
        bounce = s["bounce"]
        smp = Sampler(
            s["seed"], s["lane_id"], s["base_dim"] + bounce * DIMS_PER_BOUNCE,
            table, s["samp_idx"], s["pix_key"], STRAT,
        ).prefetch(8)  # one gather serves every draw site this bounce
        o, d, alive = s["o"], s["d"], s["alive"]
        throughput, emission = s["throughput"], s["emission"]
        was_specular = s["was_specular"]
        medium = s["medium"]
        first_scatter = s["first_scatter"]
        med_bounce = s["med_bounce"]

        hit = _intersect(scene, o, d, s["near"], jnp.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive
        far = jnp.where(did_hit, hit.t, INF)

        # ---- medium interaction (PathTracer.cpp:52-62) ----
        if meta.has_media:
            from ..models.media import medium_sample_distance

            u_mc, smp = smp.next_1d()
            u_md, smp = smp.next_1d()
            u_mb, smp = smp.next_1d()
            ms = medium_sample_distance(
                scene.media, medium, o, d, far, first_scatter, med_bounce,
                u_mc, u_md, u_mb,
            )
            throughput = throughput * jnp.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface_lane = ms.exited & did_hit
            # lanes whose medium sample failed (absorption-only to infinity,
            # max medium bounce) terminate
            alive = alive & (scattered | ms.exited)
            med_bounce = jnp.where(scattered, med_bounce + 1, med_bounce)
            first_scatter = jnp.where(scattered, False, first_scatter)
        else:
            smp = smp.skip(3)
            scattered = jnp.zeros((n,), bool)
            hit_surface_lane = did_hit

        # ---- misses: environment (handleInfiniteLights) ----
        miss = alive & ~did_hit & ~scattered
        if meta.has_env or meta.has_cap:
            gate = L.infinite_needs_escape_add(scene, d, was_specular)
            add_env = miss & gate & (bounce >= meta.min_bounces)
            emission = emission + jnp.where(
                add_env[..., None], throughput * L.infinite_radiance(scene, d), 0.0
            )
        alive = alive & (did_hit | scattered)

        # ---- volume scattering (handleVolume, TraceBase.cpp:496-514) ----
        if meta.has_media:
            from ..models.phase import phase_eval, phase_sample

            vol_nee_gate = meta.enable_volume_light_sampling and meta.n_lights > 0
            if vol_nee_gate:
                mi_v = jnp.maximum(medium, 0)
                vnee, smp = _volume_nee(
                    scene, smp, ms.p, d, medium,
                    scene.media.phase_type[mi_v], scene.media.phase_g[mi_v],
                )
                do_vnee = (
                    scattered
                    & (bounce < meta.max_bounces - 1)
                    & (meta.low_order_scattering | (med_bounce > 1))
                )
                emission = emission + jnp.where(
                    do_vnee[..., None], throughput * vnee, 0.0
                )
            else:
                smp = smp.skip(5)
            u_ph, smp = smp.next_2d()
            mi = jnp.maximum(medium, 0)
            w_phase, _ = phase_sample(
                scene.media.phase_type[mi], scene.media.phase_g[mi], d, u_ph
            )
            vol_spec = not meta.enable_volume_light_sampling
        else:
            smp = smp.skip(6)
            w_phase = d
            vol_spec = False

        # ---- surface shading ----
        p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        lobes = scene.materials.lobes[mat_id]
        ctx = (scene.materials, scene.textures)

        # two-sided flip (makeLocalScatterEvent, TraceBase.cpp:24-51)
        hit_backside = vo.dot(ns, d) > 0.0
        flip = hit_backside & ~Lobes.is_transmissive(lobes) if meta.enable_two_sided else jnp.zeros_like(hit_backside)
        t_ax, b_ax, frame_n = _shading_frame(scene, jnp.maximum(hit.prim, 0), ns, flip)
        frame = (t_ax, b_ax, frame_n)
        wi = vo.to_local(*frame, -d)

        # transparency lottery (handleSurface forward branch,
        # TraceBase.cpp:528-537): pass straight through forward-lobed
        # surfaces with probability avg(transparency)
        if meta.has_forward:
            u_fwd, smp = smp.next_1d()
            trans_f = _forward_transparency(scene, mat_id, uv, wi)
            trans_scalar = vo.avg3(trans_f)
            go_forward = hit_surface_lane & (u_fwd < trans_scalar)
            fwd_weight = trans_f / jnp.maximum(trans_scalar, 1e-20)[..., None]
        else:
            smp = smp.skip(1)
            go_forward = jnp.zeros((n,), bool)
            fwd_weight = jnp.ones((n, 3))

        # emission at hit (front side geometrically: evalDirect)
        geo_front = -vo.dot(d, ng) > jnp.maximum(
            scene.lights.cone_cos[jnp.maximum(light_id, 0)], 0.0
        )  # emission cone (disk cone_angle); 0 reduces to the plain test
        gate_emit = (not meta.enable_light_sampling) | was_specular
        add_emit = (
            hit_surface_lane
            & ~go_forward
            & (light_id >= 0)
            & geo_front
            & gate_emit
            & (bounce >= meta.min_bounces)
        )
        e_hit = eval_texture(scene.textures, scene.lights.tex[jnp.maximum(light_id, 0)], uv)
        emission = emission + jnp.where(add_emit[..., None], throughput * e_hit, 0.0)

        # ---- AOV capture at the first non-specular hit (PathTracer.cpp:78-96) ----
        if meta.aovs:
            dist_new = s["aov_dist"] + jnp.where(did_hit, hit.t, 0.0)
            not_spec = ~Lobes.is_pure_specular(lobes)
            rec_now = hit_surface_lane & ~s["aov_recorded"] & ~go_forward
            albedo_aov = eval_texture(
                scene.textures, scene.materials.albedo_tex[mat_id], uv
            ) + jnp.where((light_id >= 0)[..., None], e_hit, 0.0)
            s["aov_depth"] = jnp.where(rec_now & not_spec, dist_new, s["aov_depth"])
            s["aov_normal"] = vo.where3(rec_now & not_spec, ns, s["aov_normal"])
            s["aov_albedo"] = jnp.where((rec_now & not_spec)[..., None], albedo_aov, s["aov_albedo"])
            s["aov_recorded"] = s["aov_recorded"] | (rec_now & not_spec)
            s["aov_dist"] = dist_new

        # ---- surface NEE ----
        if meta.enable_light_sampling and meta.n_lights > 0:
            nee, smp = _nee(scene, smp, p, ng, frame, wi, mat_id, uv, lobes,
                            medium, prim=hit.prim)
            do_nee = hit_surface_lane & ~go_forward & (bounce < meta.max_bounces - 1)
            emission = emission + jnp.where(do_nee[..., None], throughput * nee, 0.0)
        else:
            smp = smp.skip(5)

        # ---- continuation BSDF sample ----
        u_c2, smp = smp.next_2d()
        u_c1, smp = smp.next_1d()
        bs = bsdf_sample(ctx, mat_id, uv, wi, u_c2, u_c1)
        wo_w = vo.to_global(*frame, bs.wo)
        wo_w = vo.where3(go_forward, d, wo_w)
        weight_step = vo.where3(go_forward, fwd_weight, bs.weight)
        throughput = throughput * jnp.where(hit_surface_lane[..., None], weight_step, 1.0)
        was_specular = jnp.where(
            hit_surface_lane & ~go_forward, Lobes.has_specular(bs.lobe),
            jnp.where(scattered, vol_spec, was_specular),
        )
        alive = alive & jnp.where(hit_surface_lane & ~go_forward, bs.valid, True)

        # medium handoff at surface crossings (selectMedium, Primitive.hpp:177)
        if meta.has_media:
            tri = jnp.maximum(hit.prim, 0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & hit_surface_lane
            new_med = jnp.where(
                backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri]
            )
            medium = jnp.where(override, new_med, medium)
            first_scatter = jnp.where(hit_surface_lane, True, first_scatter)
            med_bounce = jnp.where(hit_surface_lane, 0, med_bounce)

        # next ray: phase-scattered lanes continue from the scatter point
        if meta.has_media:
            o_new = jnp.where(scattered[..., None], ms.p, p)
            d_new = vo.where3(scattered, w_phase, wo_w)
            near_new = jnp.where(scattered, 0.0, DEFAULT_EPSILON)
        else:
            o_new = p
            d_new = wo_w
            near_new = jnp.full((n,), DEFAULT_EPSILON)

        alive = alive & (vo.max3(jnp.abs(throughput)) > 0.0)

        # ---- russian roulette (PathTracer.cpp:111-117) ----
        rp = vo.max3(jnp.abs(throughput))
        u_rr, smp = smp.next_1d()
        do_rr = (bounce > 2) & (rp < 0.1)
        survive = u_rr < rp
        throughput = jnp.where(
            (do_rr & survive & alive)[..., None],
            throughput / jnp.maximum(rp, 1e-30)[..., None],
            throughput,
        )
        alive = alive & (~do_rr | survive)

        new_state = dict(
            o=o_new,
            d=d_new,
            pix=s["pix"],
            near=jnp.where(scattered, 0.0, jnp.full((n,), DEFAULT_EPSILON)),
            throughput=throughput,
            emission=emission,
            alive=alive,
            was_specular=was_specular,
            medium=medium,
            first_scatter=first_scatter,
            med_bounce=med_bounce,
            bounce=bounce + 1,
            base_dim=s["base_dim"],
            seed=s["seed"],
            lane_id=s["lane_id"],
            samp_idx=s["samp_idx"],
            pix_key=s["pix_key"],
        )
        if meta.aovs:
            new_state.update(
                aov_recorded=s["aov_recorded"],
                aov_depth=s["aov_depth"],
                aov_dist=s["aov_dist"],
                aov_normal=s["aov_normal"],
                aov_albedo=s["aov_albedo"],
            )
        if n >= 4096:
            # compaction: dead lanes last, alive lanes grouped by octant
            oct_key = (
                (d_new[:, 0] > 0).astype(jnp.int32)
                + 2 * (d_new[:, 1] > 0).astype(jnp.int32)
                + 4 * (d_new[:, 2] > 0).astype(jnp.int32)
            )
            key = jnp.where(alive, oct_key, 8)
            names_3 = ["o", "d", "throughput", "emission"]
            names_1 = [
                "pix", "near", "alive", "was_specular", "medium",
                "first_scatter", "med_bounce", "lane_id",
            ]
            if meta.aovs:
                names_3 += ["aov_normal", "aov_albedo"]
                names_1 += ["aov_recorded", "aov_depth", "aov_dist"]
            new_state = _compact_sort(key, new_state, tuple(names_3), tuple(names_1))
        return new_state

    final = jax.lax.while_loop(cond, body, state)
    # un-permute compacted lanes back to pixel order
    rad = jnp.zeros((n, 3), jnp.float32).at[final["pix"]].set(final["emission"])
    # NaN guard (OutputBuffer.hpp:106-107 semantics: reject non-finite samples)
    rad = jnp.where(jnp.isfinite(rad), rad, 0.0)
    if meta.aovs:
        pixf = final["pix"]
        aux = dict(
            depth=jnp.zeros((n,)).at[pixf].set(final["aov_depth"]),
            normal=jnp.zeros((n, 3)).at[pixf].set(final["aov_normal"]),
            albedo=jnp.zeros((n, 3)).at[pixf].set(final["aov_albedo"]),
        )
        return rad, aux
    return rad
