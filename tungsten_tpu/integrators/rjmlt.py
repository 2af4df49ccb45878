"""Reversible-Jump MLT (Bitterli & Jarosz 2017, src/core/integrators/
reversible_jump_mlt/).

MMLT keeps one Markov chain per path length V and samples the technique
index s inside the chain; its weakness is that changing s re-randomizes the
whole path. RJ-MLT adds a *strategy perturbation* that keeps the geometric
path fixed and jumps to a different (s', t' = V - s') technique by INVERTING
the path back into primary-sample space for the new split
(ReversibleJumpMltTracer.cpp:154-209, LightPath::invert via
WritableMetropolisSampler.hpp) — the acceptance then compares the same path
under two techniques, which mixes across strategies at zero re-exploration
cost.

Wavefront form: the chain state is the (N, D, 2) primary-sample table (see
kelemen.py). A strategy step re-traces the current tables (pure replay),
gathers the realized vertex chain z_0..z_{V-1} (camera root .. light root),
and REWRITES the table slots that differ under s':
  - camera scatter groups i in [t_old-1, t_new-1): bsdf_invert at z_i
  - light root slots (s_old == 0 -> s' >= 1): emitter CDF + barycentric
    inversion of z_{V-1}
  - light first-direction slot (s_old <= 1 -> s' >= 2): cosine inverse
  - light scatter groups j in [max(s_old-1,1), s_new-1): bsdf_invert
  - pixel + filter slots (t_old == 1 -> t' >= 2): pinhole film inversion
All other slots are kept, so the unchanged subpath prefixes replay
bit-exactly. Lanes whose chain contains a non-invertible vertex (medium
scatter, wrapper bsdf, out-of-filter-support pixel) get proposalWeight 0 —
the reference's failure path (stats.inversion().reject).

Deterministic kernel cycling replaces the per-mutation strategy lottery:
every STRATEGY_EVERY-th step is a strategy move for ALL lanes (a cycle of
MCMC kernels is valid and keeps the wavefront branch-free); the remaining
steps are the shared Kelemen large/small mutations (kelemen.mlt_steps_bdpt).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..math import vecops as vo
from ..sampling import warps
from ..scene.flatten import FlatScene
from .bdpt import V_SURFACE, _bdpt_sample
from .kelemen import (
    _luminance,
    _rand,
    _splat_chain,
    mlt_steps_bdpt,
)

STRATEGY_EVERY = 4  # every 4th mutation is a strategy perturbation


def _take_slot(tree, idx):
    """Gather slot idx (N,) from every (N, K, ...) field of a verts tree."""
    out = {}
    for name, arr in tree.items():
        ix = jnp.clip(idx, 0, arr.shape[1] - 1)
        ixe = ix.reshape((-1,) + (1,) * (arr.ndim - 1))
        out[name] = jnp.take_along_axis(arr, ixe, axis=1)[:, 0]
    return out


def _chain_at(cv, lv, t_old, v, i):
    """Vertex z_i of the realized chain: camera side for i < t_old, light
    side (reversed) beyond. i is a static int; t_old/v are (N,) arrays."""
    c = {k: a[:, min(i, a.shape[1] - 1)] for k, a in cv.items()}
    l = _take_slot(lv, v - 1 - i)
    on_cam = i < t_old
    out = {}
    for k in c:
        sel = on_cam.reshape((-1,) + (1,) * (c[k].ndim - 1))
        out[k] = jnp.where(sel, c[k], l[k])
    return out


def _local_frame(nf, flip):
    t_ax, b_ax = vo.tangent_frame(nf)
    t_ax = vo.where3(flip, -t_ax, t_ax)
    return t_ax, b_ax, nf


def _tent_cdf(t):
    return jnp.where(t < 0.0, 0.5 * (t + 1.0) ** 2, 1.0 - 0.5 * (1.0 - t) ** 2)


def _invert_camera_pixel(scene, meta, d, mu):
    """Pinhole film inversion: world direction -> (u_pix (N,2), u_cam (N,2),
    ok). Only pinhole + box/tent/dirac filters invert; other camera types or
    filters report ok=False (proposal rejected)."""
    n = d.shape[0]
    if meta.camera_type != "pinhole" or meta.filter not in ("box", "tent", "dirac"):
        z2 = jnp.full((n, 2), 0.5)
        return z2, z2, jnp.zeros((n,), bool)
    w, h = meta.res_x, meta.res_y
    ratio = h / w
    local = d @ scene.camera.rot
    ok = local[..., 2] > 1e-6
    scale = scene.camera.plane_dist / jnp.maximum(local[..., 2], 1e-6)
    lx = local[..., 0] * scale
    ly = local[..., 1] * scale
    film_x = (lx + 1.0) * (w / 2.0)
    film_y = (ratio - ly) * (w / 2.0)
    if meta.filter == "box":
        px = jnp.floor(film_x)
        py = jnp.floor(film_y)
        ux = film_x - px - 0.5 + 0.5  # f0 + 0.5 with f0 = u - 0.5
        uy = film_y - py - 0.5 + 0.5
    elif meta.filter == "tent":
        px = jnp.round(film_x - 0.5)
        py = jnp.round(film_y - 0.5)
        ux = _tent_cdf(film_x - 0.5 - px)
        uy = _tent_cdf(film_y - 0.5 - py)
    else:  # dirac: offset must be ~0
        px = jnp.round(film_x - 0.5)
        py = jnp.round(film_y - 0.5)
        ok = ok & (jnp.abs(film_x - 0.5 - px) < 1e-3)
        ok = ok & (jnp.abs(film_y - 0.5 - py) < 1e-3)
        ux = jnp.full_like(film_x, 0.5)
        uy = jnp.full_like(film_y, 0.5)
    ok = ok & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    u_pix = jnp.stack(
        [(px + 0.5) / w, (py + 0.5) / h], axis=-1
    )
    u_cam = jnp.stack([jnp.clip(ux, 0.0, 1.0), jnp.clip(uy, 0.0, 1.0)], axis=-1)
    return u_pix, u_cam, ok


def _invert_emitter_root(scene, vert, mu):
    """Invert sample_emitter_position at a camera-subpath vertex that lies on
    an area light: -> (u_li, u_tri, u_pos (N,2), ok)."""
    lights = scene.lights
    li = jnp.maximum(vert["light"], 0)
    tri = jnp.maximum(vert["tri"], 0)
    n = li.shape[0]
    # the tri's slot within the light's triangle list (bounded scan)
    off = lights.offset[li]
    count = lights.count[li]
    k = jnp.zeros((n,), jnp.int32)
    found = jnp.zeros((n,), bool)
    for j in range(int(lights.max_count)):
        idx = jnp.clip(off + j, 0, lights.tri_idx.shape[0] - 1)
        match = (lights.tri_idx[idx] == tri) & (j < count) & ~found
        k = jnp.where(match, j, k)
        found = found | match
    cdf_off = lights.cdf_offset[li]
    cdf_lo = lights.cdf[jnp.clip(cdf_off + k, 0, lights.cdf.shape[0] - 1)]
    cdf_hi = lights.cdf[jnp.clip(cdf_off + k + 1, 0, lights.cdf.shape[0] - 1)]
    u_tri = cdf_lo + mu * jnp.maximum(cdf_hi - cdf_lo, 0.0)
    # barycentric of p in (v0, e1, e2)
    v0 = scene.tris.v0[tri]
    e1 = scene.tris.e1[tri]
    e2 = scene.tris.e2[tri]
    dp = vert["p"] - v0
    g11 = vo.dot(e1, e1)
    g12 = vo.dot(e1, e2)
    g22 = vo.dot(e2, e2)
    det = jnp.maximum(g11 * g22 - g12 * g12, 1e-20)
    a = (g22 * vo.dot(dp, e1) - g12 * vo.dot(dp, e2)) / det
    b = (g11 * vo.dot(dp, e2) - g12 * vo.dot(dp, e1)) / det
    # sample_emitter_position: q = v0 + e1*ly + e2*(1-lx-ly) with
    # lam = uniform_triangle_uv(u2) = (lx, ly) -> ly = a, lx = 1 - a - b
    lam = jnp.stack([1.0 - a - b, a], axis=-1)
    ok = found & (a > -1e-4) & (b > -1e-4) & (a + b < 1.0 + 1e-4)
    u_pos = warps.invert_uniform_triangle_uv(
        jnp.clip(lam, 0.0, 1.0)
    )
    u_li = (li.astype(jnp.float32) + mu) / jnp.float32(scene.meta.n_lights)
    if scene.meta.has_analytic:
        # analytic-emitter position inversion not implemented: the proposal
        # fails and is rejected, exactly the reference's invertPosition()
        # == false path (Sphere.cpp:193-197 CAN invert; TODO implement)
        ok = ok & (lights.ana_prim[li] < 0)
    return u_li, u_tri, jnp.clip(u_pos, 0.0, 1.0), ok


def invert_path_to_table(scene, out, table, s_old, s_new, v, k_max, skip_dims, mu3):
    """Rewrite `table` so the chain realized under (s_old, t_old) replays as
    technique (s_new, t_new = v - s_new). Returns (table', ok)."""
    from ..models.bsdfs.invert import bsdf_invert

    meta = scene.meta
    ctx = (scene.materials, scene.textures)
    cv, lv = out["cv"], out["lv"]
    n = table.shape[0]
    t_old = v - s_old
    t_new = v - s_new

    ok = jnp.ones((n,), bool)
    # the chain must have been realized
    ok = ok & (out["n_cv"] >= t_old) & (out["n_lv"] >= jnp.maximum(s_old, 1))
    if meta.has_media:
        # v1: medium vertices / medium distance dims are not inverted
        ok = jnp.zeros((n,), bool)

    # technique selector (slot 1): s_sel = min(u * ntech, v-1)
    ntech = jnp.where(v <= 2, 1, v).astype(jnp.float32)
    tbl = table.at[:, 1, 0].set((s_new.astype(jnp.float32) + mu3[1]) / ntech)

    # Slot layout (no-media replay; Sampler half-draw pairing, sampler.py
    # next_1d/next_2d): u_cam = slot skip, u_lens = skip+1; camera scatter
    # group g: [3 skipped][u2 at skip+2+5g+3][u1 at (skip+2+5g+4).u0, its
    # .u1 becoming the pending half]. The light root then draws u_li from
    # that PENDING half (the last camera group's u1 slot, component 1!),
    # u_tri = L0.u0, u_pos = L0+1, u_dir = L0+2 with
    # L0 = skip+2+5*(k_max-1); light scatter group g: u2 at L0+3+5g+3,
    # u1 at (L0+3+5g+4).u0.
    base_cam = skip_dims  # u_cam slot; u_lens at +1; groups at +2
    base_l = skip_dims + 2 + 5 * (k_max - 1)

    # gather chain vertices once (static unroll over positions)
    chain = [
        _chain_at(cv, lv, t_old, v, i) for i in range(k_max + 1)
    ]

    # ---- camera scatter groups ----
    for i in range(1, k_max):
        need = (i >= t_old - 1) & (i <= t_new - 2)
        if i + 1 > k_max:
            continue
        zi = chain[i]
        zp = chain[i - 1]
        zn = chain[i + 1]
        wi_dir = vo.normalize(zp["p"] - zi["p"], eps=1e-12)
        wo_dir = vo.normalize(zn["p"] - zi["p"], eps=1e-12)
        t_ax, b_ax, nf = _local_frame(zi["nf"], zi["flip"])
        wi_l = vo.to_local(t_ax, b_ax, nf, wi_dir)
        wo_l = vo.to_local(t_ax, b_ax, nf, wo_dir)
        u2, u1, iok = bsdf_invert(ctx, zi["mat"], zi["uv"], wi_l, wo_l, mu=mu3)
        iok = iok & (zi["kind"] == V_SURFACE)
        ok = ok & jnp.where(need, iok, True)
        g = base_cam + 2 + 5 * (i - 1)
        nd = need[..., None]
        tbl = tbl.at[:, g + 3, :].set(jnp.where(nd, u2, tbl[:, g + 3, :]))
        tbl = tbl.at[:, g + 4, 0].set(jnp.where(need, u1, tbl[:, g + 4, 0]))

    # ---- camera pixel (t_old == 1 -> t_new >= 2) ----
    need_pix = (t_old == 1) & (t_new >= 2)
    z1 = chain[1]
    d_cam = vo.normalize(z1["p"] - jnp.broadcast_to(scene.camera.pos, (n, 3)),
                         eps=1e-12)
    u_pix, u_cam, pok = _invert_camera_pixel(scene, meta, d_cam, mu3)
    ok = ok & jnp.where(need_pix, pok, True)
    npx = need_pix[..., None]
    tbl = tbl.at[:, 0, :].set(jnp.where(npx, u_pix, tbl[:, 0, :]))
    tbl = tbl.at[:, base_cam, :].set(jnp.where(npx, u_cam, tbl[:, base_cam, :]))

    # ---- light root (s_old == 0 -> s_new >= 1) ----
    # the light root under the NEW split is the chain's last vertex, which
    # when s_old == 0 lives on the camera side at slot v-1
    need_root = (s_old == 0) & (s_new >= 1)
    zl = _take_slot(cv, v - 1)
    u_li, u_tri, u_pos, rok = _invert_emitter_root(scene, zl, mu3[0])
    rok = rok & (zl["light"] >= 0)
    ok = ok & jnp.where(need_root, rok, True)
    nr = need_root[..., None]
    # u_li rides the pending half of the last camera group's u1 slot
    tbl = tbl.at[:, base_l - 1, 1].set(
        jnp.where(need_root, u_li, tbl[:, base_l - 1, 1])
    )
    tbl = tbl.at[:, base_l, 0].set(jnp.where(need_root, u_tri, tbl[:, base_l, 0]))
    tbl = tbl.at[:, base_l + 1, :].set(jnp.where(nr, u_pos, tbl[:, base_l + 1, :]))

    # ---- light first direction (s_old <= 1 -> s_new >= 2) ----
    need_dir = (s_old <= 1) & (s_new >= 2)

    # dynamic-position chain gather (both sides), for the light-side walk
    def _chain_dyn(idx):
        c = _take_slot(cv, idx)
        l = _take_slot(lv, v - 1 - idx)
        on_cam = idx < t_old
        outd = {}
        for kf in c:
            sel = on_cam.reshape((-1,) + (1,) * (c[kf].ndim - 1))
            outd[kf] = jnp.where(sel, c[kf], l[kf])
        return outd

    zv1 = _chain_dyn(v - 1)
    zv2 = _chain_dyn(v - 2)
    d0 = vo.normalize(zv2["p"] - zv1["p"], eps=1e-12)
    t_e, b_e = vo.tangent_frame(zv1["ng"])
    d_loc = vo.to_local(t_e, b_e, zv1["ng"], d0)
    dok = d_loc[..., 2] > 0.0
    u_dir = warps.invert_cosine_hemisphere(d_loc, mu3[0])
    ok = ok & jnp.where(need_dir, dok, True)
    ndr = need_dir[..., None]
    tbl = tbl.at[:, base_l + 2, :].set(jnp.where(ndr, u_dir, tbl[:, base_l + 2, :]))

    # ---- light scatter groups ----
    for j in range(1, k_max):
        need = (j >= jnp.maximum(s_old - 1, 1)) & (j <= s_new - 2)
        need = need | ((s_old == 0) & (j >= 1) & (j <= s_new - 2))
        zi = _chain_dyn(v - 1 - j)
        zp = _chain_dyn(v - j)
        zn = _chain_dyn(v - 2 - j)
        wi_dir = vo.normalize(zp["p"] - zi["p"], eps=1e-12)
        wo_dir = vo.normalize(zn["p"] - zi["p"], eps=1e-12)
        t_ax, b_ax, nf = _local_frame(zi["nf"], zi["flip"])
        wi_l = vo.to_local(t_ax, b_ax, nf, wi_dir)
        wo_l = vo.to_local(t_ax, b_ax, nf, wo_dir)
        u2, u1, iok = bsdf_invert(ctx, zi["mat"], zi["uv"], wi_l, wo_l, mu=mu3)
        iok = iok & (zi["kind"] == V_SURFACE)
        ok = ok & jnp.where(need, iok, True)
        g = base_l + 3 + 5 * (j - 1)
        nd = need[..., None]
        tbl = tbl.at[:, g + 3, :].set(jnp.where(nd, u2, tbl[:, g + 3, :]))
        tbl = tbl.at[:, g + 4, 0].set(jnp.where(need, u1, tbl[:, g + 4, 0]))

    return tbl, ok


def _rjmlt_strategy_step_impl(scene, state, lane_ids, seed, step_idx, bw,
                              v_sel, k_max, skip_dims=2):
    """One strategy-perturbation mutation for all chains: keep the geometric
    path, propose a uniformly-chosen s', invert, evaluate, accept by
    luminance ratio x inversion success (ReversibleJumpMltTracer.cpp:154+).
    The uniform s' proposal is symmetric, so no proposal-ratio correction."""
    meta = scene.meta
    table = state["table"]
    n = table.shape[0]

    s0 = seed[0] ^ jnp.uint32(0xC0FFEE)
    u_s, u_mu0 = _rand((n,), s0, seed[1], jnp.uint32(step_idx) * 4 + 0)
    u_mu1, u_mu2 = _rand((n,), s0, seed[1], jnp.uint32(step_idx) * 4 + 1)

    ntech = jnp.where(v_sel <= 2, 1, v_sel)
    s_cur = jnp.minimum(
        (table[:, 1, 0] * ntech.astype(jnp.float32)).astype(jnp.int32), v_sel - 1
    )
    s_cur = jnp.where(v_sel <= 2, 0, s_cur)
    s_new = jnp.minimum((u_s * ntech.astype(jnp.float32)).astype(jnp.int32),
                        v_sel - 1)
    s_new = jnp.where(v_sel <= 2, 0, s_new)

    # replay the current table to recover the realized vertex chain
    w, h = meta.res_x, meta.res_y
    u_pix = table[:, 0, :]
    px = jnp.minimum((u_pix[:, 0] * w).astype(jnp.int32), w - 1)
    py = jnp.minimum((u_pix[:, 1] * h).astype(jnp.int32), h - 1)
    cur = _bdpt_sample(scene, seed, lane_ids, px, py, table=table,
                       skip_dims=skip_dims, sel=(s_cur, v_sel), collect=True,
                       return_verts=True)

    mu3 = (u_mu0, u_mu1, u_mu2)
    proposal, inv_ok = invert_path_to_table(
        scene, cur, table, s_cur, s_new, v_sel, k_max, skip_dims, mu3
    )
    inv_ok = inv_ok & (s_new != s_cur) & (v_sel >= 3)

    px_p = jnp.minimum((proposal[:, 0, 0] * w).astype(jnp.int32), w - 1)
    py_p = jnp.minimum((proposal[:, 0, 1] * h).astype(jnp.int32), h - 1)
    prop = _bdpt_sample(scene, seed, lane_ids, px_p, py_p, table=proposal,
                        skip_dims=skip_dims, sel=(s_new, v_sel), collect=True,
                        return_verts=True)
    # replay-consistency gate (the reference FAILs on inversion
    # inconsistency, ReversibleJumpMltTracer.cpp:143-144; we reject the
    # proposal instead): the proposal must realize the SAME geometric chain
    # under (s', t') or detailed balance is broken.
    t_old = v_sel - s_cur
    t_new = v_sel - s_new
    match = jnp.ones((n,), bool)
    for i in range(k_max):
        zo = _chain_at(cur["cv"], cur["lv"], t_old, v_sel, i)
        zn = _chain_at(prop["cv"], prop["lv"], t_new, v_sel, i)
        dp = jnp.abs(zo["p"] - zn["p"]).max(-1)
        match = match & jnp.where(i < v_sel, dp < 1e-3, True)
    inv_ok = inv_ok & match

    inv_pix = 1.0 / (w * h)
    t1 = jnp.where(prop["t1_ok"][..., None], prop["t1_val"], 0.0) * inv_pix
    ev_p = dict(
        eye=prop["eye"],
        pix=jnp.stack([px_p + 0.5, py_p + 0.5], axis=-1),
        t1_val=t1,
        t1_pixf=prop["t1_pixf"],
        lum=_luminance(prop["eye"]) + _luminance(t1).sum(axis=1),
    )
    ntech_f = ntech.astype(jnp.float32)
    ev_p = dict(
        ev_p,
        eye=ev_p["eye"] * ntech_f[:, None],
        t1_val=ev_p["t1_val"] * ntech_f[:, None, None],
        lum=ev_p["lum"] * ntech_f,
    )

    a = jnp.where(
        inv_ok,
        jnp.clip(ev_p["lum"] / jnp.maximum(state["lum"], 1e-20), 0.0, 1.0),
        0.0,
    )
    w_cur = (1.0 - a) * bw / jnp.maximum(state["lum"], 1e-20)
    w_prop = a * bw / jnp.maximum(ev_p["lum"], 1e-20)

    ev_cur = dict(eye=state["eye"], pix=state["pix"],
                  t1_val=state["t1_val"], t1_pixf=state["t1_pixf"])
    buf = state["splat"]
    buf = _splat_chain(buf, ev_cur, jnp.where(state["lum"] > 0, w_cur, 0.0),
                       w, h, filter_name=meta.filter)
    buf = _splat_chain(buf, ev_p, jnp.where(ev_p["lum"] > 0, w_prop, 0.0),
                       w, h, filter_name=meta.filter)

    u_acc, _ = _rand((n,), s0, seed[1], jnp.uint32(step_idx) * 4 + 3)
    accept = u_acc < a
    acc3 = accept[:, None]
    return dict(
        table=jnp.where(accept[:, None, None], proposal, table),
        eye=jnp.where(acc3, ev_p["eye"], state["eye"]),
        pix=jnp.where(acc3, ev_p["pix"], state["pix"]),
        t1_val=jnp.where(accept[:, None, None], ev_p["t1_val"], state["t1_val"]),
        t1_pixf=jnp.where(accept[:, None, None], ev_p["t1_pixf"], state["t1_pixf"]),
        lum=jnp.where(accept, ev_p["lum"], state["lum"]),
        splat=buf,
        accept_frac=accept.mean(),
        invert_frac=inv_ok.mean(),
    )


@partial(jax.jit, static_argnames=("k_max", "skip_dims"))
def rjmlt_strategy_step(scene, state, lane_ids, seed, step_idx, bw, v_sel,
                        k_max, skip_dims=2):
    st = dict(state)
    out = _rjmlt_strategy_step_impl(
        scene, st, lane_ids, seed, step_idx, bw, v_sel, k_max, skip_dims
    )
    stats = (out.pop("accept_frac"), out.pop("invert_frac"))
    return out, stats


def render_rjmlt(
    scene: FlatScene,
    spp=None,
    seed=0xBA5EBA11,
    n_chains=1 << 13,
    p_large=0.1,
    bootstrap_factor=16,
    verbose=False,
    mesh=None,
    resume_file=None,
    scene_hash_value="",
):
    """Full RJ-MLT render: MMLT chain populations + every STRATEGY_EVERY-th
    mutation a reversible-jump strategy perturbation. Bootstrap, per-length
    budgeting and normalization are shared with MMLT
    (MultiplexedMltIntegrator.cpp:92-94 / ReversibleJumpMltIntegrator)."""
    from .multiplexed import _bootstrap_mmlt

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
    seed_arr = jnp.array([seed & 0xFFFFFFFF, 0x71000], jnp.uint32)
    lane_ids = jnp.arange(n_chains, dtype=jnp.uint32)

    boot = _bootstrap_mmlt(scene, seed, seed_arr, n_chains, k_max,
                           bootstrap_factor)
    if boot is None:
        return np.zeros((h, w, 3), np.float32)
    state, bw, v_sel = boot
    state = dict(state, splat=jnp.zeros((w * h, 3), jnp.float32))
    if mesh is not None:
        from ..parallel.mesh import replicate, shard_chain_state, shard_lanes

        scene = replicate(mesh, scene)
        lane_ids, bw, v_sel = shard_lanes(mesh, lane_ids, bw, v_sel)
        state = shard_chain_state(mesh, state, n_chains)

    from .kelemen import load_mlt_state, save_mlt_state

    total_mutations = spp * w * h
    steps = max(1, total_mutations // n_chains)
    if resume_file:
        loaded = load_mlt_state(resume_file, scene_hash_value)
        if loaded is not None:
            state, extras, _it0 = loaded
            bw = extras.get("bw", bw)
            v_sel = extras.get("v_sel", v_sel)
            globals_it0 = _it0
        else:
            globals_it0 = 0
    else:
        globals_it0 = 0
    it = globals_it0
    acc_hist = []
    while it < steps:
        k = min(STRATEGY_EVERY - 1, steps - it)
        if k > 0:
            state = mlt_steps_bdpt(
                scene, state, lane_ids, seed_arr, jnp.uint32(it), k,
                jnp.float32(p_large), bw, v_sel=v_sel, skip_dims=2,
            )
            it += k
        if it < steps:
            state, stats = rjmlt_strategy_step(
                scene, state, lane_ids, seed_arr, jnp.uint32(0x4000 + it), bw,
                v_sel, k_max, 2,
            )
            acc_hist.append(stats)
            it += 1
        if verbose:
            print(f"  rjmlt step {it}/{steps}")
    if resume_file:
        save_mlt_state(resume_file, scene_hash_value, state, it,
                       extras=dict(bw=bw, v_sel=v_sel))
    if verbose and acc_hist:
        acc = float(np.mean([float(a) for a, _ in acc_hist]))
        inv = float(np.mean([float(i) for _, i in acc_hist]))
        print(f"  strategy: accept {acc:.3f}, invertible {inv:.3f}")
    img = np.asarray(state["splat"]).reshape(h, w, 3) / steps
    return img * (w * h) / n_chains
