"""Multiplexed Metropolis Light Transport (MMLT, Hachisuka et al. 2014).

Mirror of src/core/integrators/multiplexed_mlt/ (MultiplexedMltTracer.hpp:
25-40 — one Markov chain per path LENGTH with the technique index s sampled
*inside* the chain from a primary-sample dimension;
MultiplexedMltIntegrator.cpp:92-94 — per-length luminance budgeting).

Wavefront form: every chain population is a slice of one fixed-width wavefront;
a lane carries its (static) total vertex count V and reads its technique
selector from table slot 1. Evaluation reuses the BDPT machinery
(integrators.bdpt._bdpt_sample) with per-lane technique masks, so only the
selected (s, t = V - s) connection's visibility ray is live per lane. The
per-length normalization b_V and the lane budgets come from a bootstrap
pass, exactly the reference's two-phase structure.

Technique count per length: V = 2 has only the s = 0 emission technique
((1,1) splats are excluded from the estimator set, see bdpt.py); V >= 3
has all s in 0..V-1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.flatten import FlatScene
from .kelemen import (
    _eval_bdpt,
    _rand,
    _table_dims_bdpt,
    mlt_steps_bdpt,
)


def _ntech(v):
    return 1 if v <= 2 else v


def _bootstrap_mmlt(scene, seed, seed_arr, n_chains, k_max, bootstrap_factor):
    """Shared MMLT/RJ-MLT bootstrap: per-length luminance estimation,
    chain-count budgeting, and luminance-proportional seeding. Returns
    (state-without-splat, bw (N,), v_sel (N,)) or None if the scene is
    black (MultiplexedMltIntegrator.cpp:92-124)."""
    meta = scene.meta
    lengths = list(range(2, k_max + 1))
    dims = _table_dims_bdpt(meta, k_max, extra=2)  # slot 0 pixel, slot 1 tech

    # ---- bootstrap: per-length luminances on uniformly-assigned lanes ----
    lane_ids = jnp.arange(n_chains, dtype=jnp.uint32)
    v_cycle = np.array(lengths, np.int32)[
        np.arange(n_chains) % len(lengths)
    ]
    v_boot = jnp.asarray(v_cycle)
    nt_boot = jnp.where(v_boot <= 2, 1, v_boot).astype(jnp.float32)
    boot = []
    for i in range(bootstrap_factor):
        u0, u1 = _rand((n_chains, dims), seed_arr[0] ^ jnp.uint32(0xDEADBEEF),
                       seed_arr[1], jnp.uint32(0x7D000 + i))
        tbl = jnp.stack([u0, u1], axis=-1)
        s_sel = jnp.minimum((tbl[:, 1, 0] * nt_boot).astype(jnp.int32), v_boot - 1)
        s_sel = jnp.where(v_boot <= 2, 0, s_sel)
        ev = _eval_bdpt(scene, tbl, lane_ids, seed_arr, sel=(s_sel, v_boot),
                        skip_dims=2)
        lum = ev["lum"] * nt_boot
        boot.append((tbl, ev, lum))

    lums_np = np.concatenate([np.asarray(lm) for _, _, lm in boot])
    v_np = np.tile(np.asarray(v_cycle), bootstrap_factor)
    b_v = {v: float(lums_np[v_np == v].mean()) for v in lengths}
    b_total = sum(b_v.values())
    if b_total <= 0:
        return None

    # ---- allocate chains per length proportional to b_V (>= 1 each) ----
    n_v = {}
    remaining = n_chains
    for v in lengths[:-1]:
        n_v[v] = max(1, int(round(n_chains * b_v[v] / b_total)))
        remaining -= n_v[v]
    n_v[lengths[-1]] = max(1, remaining)
    v_lane = np.concatenate([np.full(n_v[v], v, np.int32) for v in lengths])
    v_lane = v_lane[:n_chains]
    if len(v_lane) < n_chains:
        v_lane = np.pad(v_lane, (0, n_chains - len(v_lane)),
                        constant_values=lengths[-1])
    v_sel = jnp.asarray(v_lane)
    # per-lane normalization c = b_V * n_chains / n_V (see kelemen.py
    # _mlt_step_bdpt_impl derivation)
    bw = jnp.asarray(
        np.array([b_v[int(v)] * n_chains / max(n_v[int(v)], 1) for v in v_lane],
                 np.float32)
    )

    # ---- seed chains: luminance-proportional WITHIN each length ----
    rng = np.random.default_rng(seed)
    tables = jnp.stack([t for t, _, _ in boot])  # (F, N, D, 2)
    sel_f = np.zeros(n_chains, np.int64)
    sel_i = np.zeros(n_chains, np.int64)
    for v in lengths:
        pool = np.where(v_np == v)[0]  # indices into the flat bootstrap pool
        pl_ = lums_np[pool]
        lanes_v = np.where(v_lane == v)[0]
        if pl_.sum() <= 0:
            pick = rng.choice(pool, size=len(lanes_v))
        else:
            pick = rng.choice(pool, size=len(lanes_v), p=pl_ / pl_.sum())
        sel_f[lanes_v] = pick // n_chains
        sel_i[lanes_v] = pick % n_chains
    table = tables[sel_f, sel_i]
    evs = jax.tree.map(
        lambda *xs: jnp.stack(xs)[sel_f, sel_i], *[ev for _, ev, _ in boot]
    )
    nt_lane = jnp.where(v_sel <= 2, 1, v_sel).astype(jnp.float32)

    state = dict(
        table=table,
        eye=evs["eye"] * nt_lane[:, None],
        pix=evs["pix"],
        t1_val=evs["t1_val"] * nt_lane[:, None, None],
        t1_pixf=evs["t1_pixf"],
        lum=evs["lum"] * nt_lane,
    )
    return state, bw, v_sel


def render_mmlt(
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
    """Full MMLT render. Total mutations = spp * W * H, split across path
    lengths proportionally to the bootstrap per-length luminance
    (MultiplexedMltIntegrator.cpp:92-94)."""
    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    k_max = min(meta.max_bounces + 1, meta.bdpt_max_vertices)
    seed_arr = jnp.array([seed & 0xFFFFFFFF, 0x70000], jnp.uint32)
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
    chunk = 16
    it = globals_it0
    while it < steps:
        k = min(chunk, steps - it)
        state = mlt_steps_bdpt(
            scene, state, lane_ids, seed_arr, jnp.uint32(it), k,
            jnp.float32(p_large), bw, v_sel=v_sel, skip_dims=2,
        )
        it += k
        if verbose:
            print(f"  mmlt step {it}/{steps}")
    if resume_file:
        save_mlt_state(resume_file, scene_hash_value, state, it,
                       extras=dict(bw=bw, v_sel=v_sel))
    img = np.asarray(state["splat"]).reshape(h, w, 3) / steps
    return img * (w * h) / n_chains
