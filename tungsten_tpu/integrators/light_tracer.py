"""Wavefront light tracer (adjoint particle tracing).

Mirror of src/core/integrators/light_tracer/LightTracer.cpp:12-120: emit
particles from lights (uniform light choice, position + cosine direction
sampling), connect every surface vertex to the camera through the generalized
shadow walk, splat filtered contributions into the framebuffer, continue via
adjoint BSDF sampling (no NEE, no emission gathering — handleSurface with
adjoint=true).

Wavefront form: one lax.while_loop over bounce depth for the particle megabatch;
camera connections scatter-add into a per-pass (H*W, 3) splat buffer with
2x2 tent-filter footprints (the AtomicFramebuffer::splatFiltered analog,
AtomicFramebuffer.hpp:50-90 — scatter-add replaces CAS atomics).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..math import vecops as vo
from ..models.bsdfs import bsdf_eval, bsdf_sample
from ..models.bsdfs.dispatch import bsdf_eta_sq
from ..models.bsdfs.common import Lobes
from ..models.cameras.connect import camera_sample_direct
from ..models.primitives import lights as L
from ..sampling import Sampler, warps
from ..scene.flatten import DEFAULT_EPSILON, FlatScene
from .path_tracer import (
    DIMS_PER_BOUNCE,
    INF,
    SHADOW_FUDGE,
    _intersect,
    _shading_data,
    _trace_transparent,
)


def splat_filtered(buf, pixel_xy, value, valid, res_x, res_y, filter_name="tent"):
    """Filtered splat (AtomicFramebuffer::splatFiltered, AtomicFramebuffer.
    hpp:50-76): tent gets the exact analytic 2x2; gaussian / mitchell /
    catmull_rom / lanczos use the SIGNED tabulated evalApproximate over their
    width-2 4x4 support (negative lobes splat negative energy — the
    sharpening the reference's pyramid filters rely on); box hits one pixel;
    dirac drops the splat (the reference does too — dirac scenes cannot use
    splatting integrators)."""
    from ..models.cameras import rfilter

    if filter_name == "dirac":
        return buf
    fx = pixel_xy[:, 0] - 0.5
    fy = pixel_xy[:, 1] - 0.5
    if filter_name == "box":
        px = jnp.floor(pixel_xy[:, 0])
        py = jnp.floor(pixel_xy[:, 1])
        inside = (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y) & valid
        idx = jnp.clip(py.astype(jnp.int32) * res_x + px.astype(jnp.int32), 0, res_x * res_y - 1)
        return buf.at[idx].add(jnp.where(inside[:, None], value, 0.0))
    tabulated = rfilter.is_tabulated(filter_name)
    taps = (-1, 0, 1, 2) if tabulated else (0, 1)
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    for dx in taps:
        for dy in taps:
            px = x0 + dx
            py = y0 + dy
            if tabulated:
                w = rfilter.eval_approx(filter_name, fx - px) * rfilter.eval_approx(
                    filter_name, fy - py
                )
            else:
                wx = jnp.maximum(0.0, 1.0 - jnp.abs(fx - px))
                wy = jnp.maximum(0.0, 1.0 - jnp.abs(fy - py))
                w = wx * wy
            inside = (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y) & valid
            idx = jnp.clip(py.astype(jnp.int32) * res_x + px.astype(jnp.int32), 0, res_x * res_y - 1)
            contrib = jnp.where(inside[:, None], value * w[:, None], 0.0)
            buf = buf.at[idx].add(contrib)
    return buf


def _connect_to_camera(scene, buf, p, ng, frame, wi, mat_id, uv, throughput,
                       medium, active, prim=None):
    """surfaceLensSample (TraceBase.cpp:176-244): adjoint bsdf eval toward the
    lens, generalized shadow walk, filtered splat."""
    meta = scene.meta
    ctx = (scene.materials, scene.textures)
    n = p.shape[0]
    t_ax, b_ax, nrm = frame

    d, dist, cam_w, pixel, valid = camera_sample_direct(scene.camera, meta, p)
    wo_l = vo.to_local(t_ax, b_ax, nrm, d)
    f = bsdf_eval(ctx, mat_id, uv, wi, wo_l, nonspecular_only=True)
    # adjoint correction: divide out the radiance eta^2, multiply the
    # shading/geometric normal factor (Bsdf.hpp:75-81 adjoint branch)
    eta2 = bsdf_eta_sq(ctx, mat_id, uv, wi, wo_l)
    wi_w = vo.to_global(t_ax, b_ax, nrm, wi)
    corr = jnp.abs(
        (vo.dot(d, ng) * wi[..., 2])
        / jnp.maximum(jnp.abs(vo.dot(wi_w, ng) * wo_l[..., 2]), 1e-20)
    )
    f = f * (corr / jnp.maximum(eta2, 1e-20))[..., None]

    cand = active & valid & jnp.any(f > 0.0, axis=-1)
    if meta.has_media:
        # the lens ray leaves the vertex toward the camera: start it in the
        # medium on THAT side of the geometric normal (TraceBase.cpp:223-224)
        from .path_tracer import _select_medium_dir

        pr = prim if prim is not None else jnp.full((n,), -1, jnp.int32)
        med = _select_medium_dir(scene, medium, pr, d, active, p=p)
    else:
        med = jnp.full((n,), -1, jnp.int32)
    w_sh, h_sh, _ = _trace_transparent(
        scene, p, d, jnp.where(cand, dist * SHADOW_FUDGE, 0.0), med,
        jnp.ones((n,), bool), jnp.ones((n,), bool),
    )
    visible = cand & (h_sh.prim < 0)
    value = throughput * f * w_sh * cam_w[:, None]
    return splat_filtered(buf, pixel, value, visible, meta.res_x, meta.res_y,
                          filter_name=meta.filter)


import functools


@functools.partial(jax.jit, static_argnames=("n_passes",))
def trace_light_batch(scene: FlatScene, seed, lane_ids, base_pass, n_passes=1):
    """n_passes fused light-trace passes in ONE dispatch (the per-dispatch
    tax on this runtime is ~25 ms; the PT's trace_batch does the same).
    Returns the summed splat buffer."""
    import jax.numpy as _jnp

    def body(i, acc):
        ps = seed.at[1].set(0x10000 + (base_pass + i).astype(_jnp.uint32))
        return acc + trace_light_pass(scene, ps, lane_ids)

    n_pix = scene.meta.res_x * scene.meta.res_y
    return jax.lax.fori_loop(
        0, n_passes, body, _jnp.zeros((n_pix, 3), _jnp.float32)
    )


@jax.jit
def trace_light_pass(scene: FlatScene, seed, lane_ids):
    """Trace one light path per lane; returns the (H*W, 3) splat buffer
    (un-normalized: divide by paths-per-pixel outside)."""
    meta = scene.meta
    n = lane_ids.shape[0]
    sampler = Sampler.create(seed, lane_ids)
    buf = jnp.zeros((meta.res_x * meta.res_y, 3), jnp.float32)

    # emitter sampling (chooseLightAdjoint: uniform, LightTracer.cpp:14-22)
    u_li, sampler = sampler.next_1d()
    li = jnp.minimum((u_li * meta.n_lights).astype(jnp.int32), meta.n_lights - 1)
    light_pdf = 1.0 / meta.n_lights
    u_tri, sampler = sampler.next_1d()
    u_pos, sampler = sampler.next_2d()
    em = L.sample_emitter_position(scene, li, u_tri, u_pos)
    u_dir, sampler = sampler.next_2d()
    d_local = warps.cosine_hemisphere(u_dir)
    t_e, b_e = vo.tangent_frame(em.ng)
    d0 = vo.to_global(t_e, b_e, em.ng, d_local)

    throughput0 = em.weight / light_pdf  # direction weight is 1 (cosine)
    alive0 = em.valid

    # emitter -> lens root splat (LightTracer.cpp:27-38, minBounces==0):
    # value = (pi*A*Le/pick) * Tr * lensWeight * evalDirectionalEmission
    # with evalDirectionalEmission = cos(d.n)/pi for area lights (Quad.cpp:
    # 230-233) — the (s=1, t=1) technique the splat loop never reaches
    if meta.min_bounces == 0:
        dc0, dist0, cam_w0, pixel0, vld0 = camera_sample_direct(
            scene.camera, meta, em.p
        )
        cos_e = jnp.maximum(vo.dot(dc0, em.ng), 0.0)
        cand0 = alive0 & vld0 & (cos_e > 0.0)
        med0 = (
            scene.tri_med_ext[jnp.maximum(em.tri, 0)]
            if meta.has_media else jnp.full((n,), -1, jnp.int32)
        )
        w_sh0, h_sh0, _ = _trace_transparent(
            scene, em.p, dc0, jnp.where(cand0, dist0 * SHADOW_FUDGE, 0.0),
            med0, jnp.ones((n,), bool), jnp.ones((n,), bool),
        )
        visible0 = cand0 & (h_sh0.prim < 0)
        val0 = throughput0 * w_sh0 * (cam_w0 * cos_e * warps.INV_PI)[:, None]
        buf = splat_filtered(buf, pixel0, val0, visible0, meta.res_x,
                             meta.res_y, filter_name=meta.filter)

    state = dict(
        o=em.p,
        d=d0,
        near=jnp.full((n,), DEFAULT_EPSILON),
        throughput=throughput0,
        alive=alive0,
        medium=(
            scene.tri_med_ext[jnp.maximum(em.tri, 0)]
            if meta.has_media else jnp.full((n,), -1, jnp.int32)
        ),
        first_scatter=jnp.ones((n,), bool),
        med_bounce=jnp.zeros((n,), jnp.int32),
        bounce=jnp.int32(0),
        buf=buf,
        base_dim=sampler.dim,
        seed=sampler.seed,
        lane_id=sampler.lane_id,
    )

    def cond(s):
        return jnp.any(s["alive"]) & (s["bounce"] < meta.max_bounces - 1)

    def body(s):
        bounce = s["bounce"]
        smp = Sampler(s["seed"], s["lane_id"], s["base_dim"] + bounce * DIMS_PER_BOUNCE)
        o, d, alive = s["o"], s["d"], s["alive"]
        throughput = s["throughput"]
        medium = s["medium"]
        buf = s["buf"]

        hit = _intersect(scene, o, d, s["near"], jnp.where(alive, INF, 0.0))
        did_hit = (hit.prim >= 0) & alive

        if meta.has_media:
            from ..models.media import medium_sample_distance
            from ..models.phase import phase_eval, phase_sample
            from ..models.cameras.connect import camera_sample_direct as csd

            u_mc, smp = smp.next_1d()
            u_md, smp = smp.next_1d()
            u_mb, smp = smp.next_1d()
            far = jnp.where(did_hit, hit.t, INF)
            ms = medium_sample_distance(
                scene.media, medium, o, d, far, s["first_scatter"], s["med_bounce"],
                u_mc, u_md, u_mb,
            )
            throughput = throughput * jnp.where(alive[..., None], ms.weight, 1.0)
            scattered = ms.scattered & alive
            hit_surface_lane = ms.exited & did_hit
            alive = alive & (scattered | (ms.exited & did_hit))
            # volume -> camera connection (volumeLensSample)
            mi = jnp.maximum(medium, 0)
            dc, distc, cw, pix, vld = csd(scene.camera, meta, ms.p)
            fp = phase_eval(scene.media.phase_type[mi], scene.media.phase_g[mi], d, dc)
            candv = scattered & vld
            wv, hv, _ = _trace_transparent(
                scene, ms.p, dc, jnp.where(candv, distc * SHADOW_FUDGE, 0.0), medium,
                jnp.zeros((n,), bool), jnp.ones((n,), bool),
            )
            visv = candv & (hv.prim < 0)
            buf = splat_filtered(
                buf, pix, throughput * wv * (fp * cw)[:, None], visv,
                meta.res_x, meta.res_y, filter_name=meta.filter,
            )
            u_ph, smp = smp.next_2d()
            w_phase, _ = phase_sample(
                scene.media.phase_type[mi], scene.media.phase_g[mi], d, u_ph
            )
            s["med_bounce"] = jnp.where(scattered, s["med_bounce"] + 1, s["med_bounce"])
            s["first_scatter"] = jnp.where(scattered, False, s["first_scatter"])
        else:
            smp = smp.skip(6)
            scattered = jnp.zeros((n,), bool)
            hit_surface_lane = did_hit
            w_phase = d
            alive = alive & did_hit

        # surface vertex: connect to camera + adjoint continuation
        p, ng, ns, uv, mat_id, light_id = _shading_data(scene, hit, o, d)
        lobes = scene.materials.lobes[mat_id]
        ctx = (scene.materials, scene.textures)
        hit_backside = vo.dot(ns, d) > 0.0
        flip = hit_backside & ~Lobes.is_transmissive(lobes) if meta.enable_two_sided else jnp.zeros_like(hit_backside)
        from .path_tracer import _shading_frame

        t_ax, b_ax, frame_n = _shading_frame(scene, jnp.maximum(hit.prim, 0), ns, flip)
        frame = (t_ax, b_ax, frame_n)
        wi = vo.to_local(*frame, -d)

        buf = _connect_to_camera(
            scene, buf, p, ng, frame, wi, mat_id, uv, throughput, medium,
            hit_surface_lane, prim=hit.prim,
        )

        u_c2, smp = smp.next_2d()
        u_c1, smp = smp.next_1d()
        bs = bsdf_sample(ctx, mat_id, uv, wi, u_c2, u_c1)
        wo_w = vo.to_global(*frame, bs.wo)
        # adjoint sample correction (Bsdf.hpp:75-81)
        eta2 = bsdf_eta_sq(ctx, mat_id, uv, wi, bs.wo)
        wi_w = vo.to_global(*frame, wi)
        corr = jnp.abs(
            (vo.dot(wo_w, ng) * wi[..., 2])
            / jnp.maximum(jnp.abs(vo.dot(wi_w, ng) * bs.wo[..., 2]), 1e-20)
        )
        adj_weight = bs.weight * (corr / jnp.maximum(eta2, 1e-20))[..., None]
        throughput = throughput * jnp.where(hit_surface_lane[..., None], adj_weight, 1.0)
        alive = alive & jnp.where(hit_surface_lane, bs.valid, True)

        if meta.has_media:
            tri = jnp.maximum(hit.prim, 0)
            backside_new = vo.dot(wo_w, ng) < 0.0
            override = scene.tri_med_override[tri] & hit_surface_lane
            new_med = jnp.where(
                backside_new, scene.tri_med_int[tri], scene.tri_med_ext[tri]
            )
            medium = jnp.where(override, new_med, medium)
            s["first_scatter"] = jnp.where(hit_surface_lane, True, s["first_scatter"])
            s["med_bounce"] = jnp.where(hit_surface_lane, 0, s["med_bounce"])
            o_new = jnp.where(scattered[..., None], ms.p, p)
            d_new = vo.where3(scattered, w_phase, wo_w)
        else:
            o_new = p
            d_new = wo_w

        alive = alive & (vo.max3(jnp.abs(throughput)) > 0.0)

        # russian roulette (LightTracer.cpp: same schedule as PT)
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

        return dict(
            o=o_new,
            d=d_new,
            near=jnp.where(scattered, 0.0, jnp.full((n,), DEFAULT_EPSILON)),
            throughput=throughput,
            alive=alive,
            medium=medium,
            first_scatter=s["first_scatter"],
            med_bounce=s["med_bounce"],
            bounce=bounce + 1,
            buf=buf,
            base_dim=s["base_dim"],
            seed=s["seed"],
            lane_id=s["lane_id"],
        )

    final = jax.lax.while_loop(cond, body, state)
    out = final["buf"]
    return jnp.where(jnp.isfinite(out), out, 0.0)
