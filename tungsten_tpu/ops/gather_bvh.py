"""Per-lane gather BVH traversal: the intersector every integrator uses.

Every ray owns its traversal cursor, and the whole walk runs as dense XLA
operations over (N,) lane vectors [Aila & Laine 2009, per-ray traversal
with a private stack, written as gathers instead of per-thread loads]; it
replaces embree's packet traversal (thirdparty/embree,
Triangle4.hpp:13-54).

  * ONE row gather per lane per round. A node row packs all 8 child boxes
    and child links; a leaf row packs 8 whole triangles. Rows are stored
    row-major, (M, 81) float32, so a lane reads 324 contiguous bytes.
  * The tree is 8-ary (3 collapsed binary SAH levels, largest-area greedy)
    over 8-triangle leaves, so a full walk is ~8-16 rounds instead of ~30
    binary steps.
  * Per-lane traversal ORDER: the 8 children are box-tested from the
    gathered row, the nearest hit child becomes the cursor and the rest
    wait on a per-lane bitstack (see _phase).
  * Leaf rounds run 8 exact-f32 Moller-Trumbore tests straight from the
    gathered row. Node lanes and leaf lanes share every round's vector code
    (masked); divergence costs arithmetic, never extra gathers.
  * Straggler phases (_traverse) compact the lanes still walking into
    narrower buffers, so the tail of slow rays does not hold the full
    wavefront.

Cost is per ray visit, so incoherent bounce wavefronts pay the same per
visit as camera rays. Plain jnp: the same code runs on the CPU for the tests
and on the GPU. The row layout and the phase constants were chosen by
timing alternatives on an H100 (PERF.md, "Bring-up findings").
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.pytree import dataclass as pytree, field

from .intersect import Hit, INF

TRIS_PER_LEAF = 8
K_ROW = 81  # unified row width (see layout below)
COL_FLAG = 80

# node row:  [0:8]=minx [8:16]=miny [16:24]=minz [24:32]=maxx [32:40]=maxy
#            [40:48]=maxz [48:56]=child row ids (-1 none) [80]=0
# leaf row:  [0:8]=v0x [8:16]=v0y [16:24]=v0z [24:32]=e1x [32:40]=e1y
#            [40:48]=e1z [48:56]=e2x [56:64]=e2y [64:72]=e2z
#            [72:80]=prim ids (-1 empty) [80]=1


@pytree
class GatherBvhPack:
    rows: jnp.ndarray  # (M, K_ROW) f32 unified node/leaf rows
    root: int = field(pytree_node=False, default=0)
    n_rows: int = field(pytree_node=False, default=0)
    depth: int = field(pytree_node=False, default=8)  # 8-ary depth (stack bound)
    n_tris: int = field(pytree_node=False, default=0)


def build_gather_pack(v0, e1, e2, leaf_size: int = TRIS_PER_LEAF):
    """Host-side build: binary SAH (accel.bvh) -> 8-ary collapse -> rows."""
    from ..accel.bvh import build_bvh_cached

    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    t = len(v0)
    if t == 0:
        return None
    p1, p2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    bvh = build_bvh_cached(lo, hi, leaf_size=leaf_size)
    count, skip = bvh.count, bvh.skip
    nmin, nmax = bvh.node_min, bvh.node_max
    area = np.prod(np.maximum(nmax - nmin, 0.0), axis=1)

    leaf_mask = count > 0
    n_leaves = int(leaf_mask.sum())

    def children(b):
        left = b + 1
        return left, int(skip[left])

    # --- collapse to 8-ary (greedy largest-area expansion of inner slots) ---
    nodes8 = []  # binary ids per slot
    memo = {}

    def build8(b):
        if b in memo:
            return memo[b]
        id8 = len(nodes8)
        nodes8.append(None)
        memo[b] = id8
        if count[b] > 0:
            slots = [b]
        else:
            slots = list(children(b))
            while len(slots) < 8:
                inner = [s for s in slots if count[s] == 0]
                if not inner:
                    break
                s = max(inner, key=lambda x: area[x])
                slots.remove(s)
                slots.extend(children(s))
        nodes8[id8] = slots
        return id8

    build8(0)
    i = 0
    while i < len(nodes8):
        for s in list(nodes8[i]):
            if count[s] == 0:
                build8(s)
        i += 1
    m8 = len(nodes8)

    # row ids: nodes first [0, m8), then leaf rows [m8, m8 + n_leaves)
    leaf_row = np.cumsum(leaf_mask) - 1 + m8  # binary id -> leaf row id
    M = m8 + n_leaves
    assert M < (1 << 24) and t < (1 << 24)
    rows = np.zeros((M, K_ROW), np.float32)

    # node rows: slot c holds binary node slots[c] (absent: inverted box)
    slots = np.full((m8, 8), -1, np.int64)
    for id8, sl in enumerate(nodes8):
        slots[id8, :len(sl)] = sl
    has = slots >= 0
    s0 = np.maximum(slots, 0)
    for k in range(3):
        rows[:m8, 8 * k:8 * k + 8] = np.where(has, nmin[s0, k], 3e38)
        rows[:m8, 24 + 8 * k:32 + 8 * k] = np.where(has, nmax[s0, k], -3e38)
    inner_id = np.array([memo.get(int(b), -1) for b in s0.ravel()]).reshape(m8, 8)
    child = np.where(count[s0] > 0, leaf_row[s0], inner_id)
    rows[:m8, 48:56] = np.where(has, child, -1)
    # 8-ary depth (stack bound): children always have larger ids than
    # their parent, so one reverse sweep sees every child first
    depth8 = np.ones(m8, np.int32)
    inner_child = np.where(has & (count[s0] == 0), inner_id, -1)
    for id8 in range(m8 - 1, -1, -1):
        c = inner_child[id8]
        c = c[c >= 0]
        if len(c):
            depth8[id8] = 1 + depth8[c].max()

    # leaf rows: up to 8 triangles each, prim id -1 in empty slots
    leaves = np.where(leaf_mask)[0]
    rid = leaf_row[leaves]
    first, cnt = bvh.first[leaves], count[leaves]
    rows[rid, 72:80] = -1.0
    for i in range(TRIS_PER_LEAF):
        ok = i < cnt
        g = bvh.prim_order[np.minimum(first + i, t - 1)][ok]
        r = rid[ok]
        for k in range(3):
            rows[r, i + 8 * k] = v0[g, k]
            rows[r, 24 + i + 8 * k] = e1[g, k]
            rows[r, 48 + i + 8 * k] = e2[g, k]
        rows[r, 72 + i] = g
    rows[rid, COL_FLAG] = 1.0

    return GatherBvhPack(
        rows=jnp.asarray(rows),
        root=0,
        n_rows=M,
        depth=max(1, int(depth8[0])),
        n_tris=t,
    )


# lane state: cur >= 0 -> processing row `cur` next round; DEAD -> done
DEAD = jnp.int32(-1)


def _phase(
    rows, o, d, tnear, best_t, best_p, bu, bv, active, latch,
    root, m, depth, stop_n, max_rounds, state0=None,
):
    """Bitstack per-lane traversal.

    A full (code, tmin) entry stack would be D~56 parallel (N,) arrays,
    ~112 of them rewritten every round. This walk keeps a BITSTACK instead:
    per tree level just (node row id, pending-children bitmask) — <= 2*depth
    small int32 arrays. A pop re-gathers the parent row and re-tests its
    boxes against the CURRENT best_t (the re-test prunes), and the nearest pending
    child is picked exactly by min of slab tmin + equality one-hot — no
    octant permutation tables. A node whose remaining hit set is empty
    descends tail-call style without pushing, which removes most resume
    rounds.

    Selections use min + equality one-hot + masked sum rather than argmin
    or take_along_axis, so they fuse with the surrounding arithmetic.

    Runs rounds on ALL lanes until the LIVE count drops to `stop_n` (0 =
    drain completely) or `max_rounds` is hit. `active` selects the lanes
    that traverse at all; `latch` is a PER-LANE any-hit flag — latched
    lanes record the first hit found and die immediately (the embree
    rtcOccluded split), so shadow queries and closest-hit queries share
    one walk and one compile. best_t/p/u/v carry partial results in and
    out (restart semantics: a lane re-entering a later phase walks from
    the root again, pruned by its carried best_t). Returns
    (best_t, best_p, bu, bv, live_mask, rounds).
    """
    N = o.shape[0]
    L = depth + 2  # bitstack levels (one push max per visited level)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    idx = 1.0 / jnp.where(dx == 0.0, 1e-30, dx)
    idy = 1.0 / jnp.where(dy == 0.0, 1e-30, dy)
    idz = 1.0 / jnp.where(dz == 0.0, 1e-30, dz)
    j8 = jnp.arange(8, dtype=jnp.int32)[:, None]  # slot index column

    # bitstack levels live as (L, N) arrays: every push/pop/consume is ONE
    # vectorized op over all levels instead of an L-deep unrolled chain of
    # (N,) selects, and phase compaction gathers 4 arrays instead of 4L
    larange = jnp.arange(L, dtype=jnp.int32)[:, None]  # (L, 1)
    if state0 is None:
        cur0 = jnp.where(active, jnp.int32(root), DEAD)
        pend0 = jnp.full((N,), 0xFF, jnp.int32)
        lvl0 = jnp.zeros((N,), jnp.int32)
        pid0 = jnp.zeros((L, N), jnp.int32)
        pmask0 = jnp.zeros((L, N), jnp.int32)
        nc0 = jnp.full((L, N), -1, jnp.int32)
        nt0 = jnp.zeros((L, N), jnp.float32)
    else:
        cur0, pend0, lvl0, pid0, pmask0, nc0, nt0 = state0
    best_t0 = best_t
    best_p0 = best_p
    bu0 = bu
    bv0 = bv

    def body(state):
        (rounds, cur, pend, lvl, pid, pmask, nc, nt,
         best_t, best_p, bu, bv) = state
        live = cur >= 0
        # THE gather: one (N, K) row block, used as (K, N) column slices
        rT = rows[jnp.clip(cur, 0, m - 1)].T
        is_leaf = rT[COL_FLAG] > 0.5
        node_on = live & ~is_leaf
        leaf_on = live & is_leaf

        # ---- node: 8 pending child box tests; nearest by exact tmin ----
        t0x = (rT[0:8] - ox) * idx
        t1x = (rT[24:32] - ox) * idx
        t0y = (rT[8:16] - oy) * idy
        t1y = (rT[32:40] - oy) * idy
        t0z = (rT[16:24] - oz) * idz
        t1z = (rT[40:48] - oz) * idz
        blo = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        bhi = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        code = rT[48:56].astype(jnp.int32)  # (8, N)
        h = (
            node_on
            & ((pend >> j8) & 1 > 0)
            & (code >= 0)
            & (blo <= bhi)
            & (bhi >= tnear)
            & (blo < best_t)
        )
        hitbits = jnp.sum(
            jnp.where(h, jnp.left_shift(1, j8), 0), axis=0
        ).astype(jnp.int32)
        tj = jnp.where(h, blo, jnp.inf)
        tsel = jnp.min(tj, axis=0)  # (N,)
        sel = jnp.min(jnp.where(h & (tj == tsel), j8, 8), axis=0)
        one = j8 == sel  # one-hot column (all-false when sel == 8)
        child = jnp.sum(jnp.where(one, code, 0), axis=0)
        descend = node_on & (sel < 8)
        remaining = hitbits & ~jnp.left_shift(1, sel)
        # second-nearest hit child: stored on the stack level so the NEXT pop
        # descends to it directly instead of burning a round re-gathering the
        # parent (mean 2.5 pops/ray on the bench scene, nearly all of which
        # descend again — the direct pop removes that whole round class)
        tj2 = jnp.where(h & ~one, blo, jnp.inf)
        tsel2 = jnp.min(tj2, axis=0)
        sel2 = jnp.min(jnp.where(h & ~one & (tj2 == tsel2), j8, 8), axis=0)
        two = j8 == sel2
        child2 = jnp.sum(jnp.where(two, code, 0), axis=0)
        push = descend & (remaining != 0)  # remaining != 0 <=> sel2 < 8
        remaining2 = remaining & ~jnp.left_shift(1, jnp.minimum(sel2, 7))
        wsel = push[None, :] & (larange == lvl[None, :])  # (L, N) one-hot
        pid = jnp.where(wsel, cur[None, :], pid)
        pmask = jnp.where(wsel, remaining2[None, :], pmask)
        nc = jnp.where(wsel, child2[None, :], nc)
        nt = jnp.where(wsel, tsel2[None, :], nt)
        lvl = jnp.where(push, lvl + 1, lvl)

        # ---- leaf: 8 exact Moller-Trumbore tests from the row ----
        tid = rT[72:80]
        px = dy * rT[64:72] - dz * rT[56:64]
        py = dz * rT[48:56] - dx * rT[64:72]
        pz = dx * rT[56:64] - dy * rT[48:56]
        det = rT[24:32] * px + rT[32:40] * py + rT[40:48] * pz
        inv_det = jnp.where(
            jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0
        )
        tx, ty, tz = ox - rT[0:8], oy - rT[8:16], oz - rT[16:24]
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * rT[40:48] - tz * rT[32:40]
        qy = tz * rT[24:32] - tx * rT[40:48]
        qz = tx * rT[32:40] - ty * rT[24:32]
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (rT[48:56] * qx + rT[56:64] * qy + rT[64:72] * qz) * inv_det
        ok = (
            leaf_on
            & (tid >= 0.0)
            & (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (tt > tnear)
            & (tt < best_t)
        )
        ttm = jnp.where(ok, tt, jnp.inf)
        tk = jnp.min(ttm, axis=0)  # (N,) — ok already enforces < best_t
        ksel = jnp.min(jnp.where(ok & (ttm == tk), j8, 8), axis=0)
        kone = j8 == ksel
        lhit = ksel < 8
        best_p = jnp.where(
            lhit, jnp.sum(jnp.where(kone, tid, 0), axis=0).astype(jnp.int32),
            best_p,
        )
        bu = jnp.where(lhit, jnp.sum(jnp.where(kone, u, 0), axis=0), bu)
        bv = jnp.where(lhit, jnp.sum(jnp.where(kone, v, 0), axis=0), bv)
        best_t = jnp.where(lhit, tk, best_t)

        found = leaf_on & latch & (best_p >= 0)  # latched lanes end on 1st hit

        # ---- advance: descend, else pop one bitstack level ----
        cur = jnp.where(descend, child, cur)
        pend = jnp.where(descend, 0xFF, pend)
        need_pop = (leaf_on | (node_on & ~descend)) & ~found
        can = need_pop & (lvl > 0)
        tsl = larange == (lvl - 1)[None, :]  # (L, N) top-of-stack one-hot
        # lanes with lvl == 0 match nothing and sum to 0 — unused (can=False)
        top_c = jnp.sum(jnp.where(tsl, pid, 0), axis=0)
        top_m = jnp.sum(jnp.where(tsl, pmask, 0), axis=0)
        top_nc = jnp.sum(jnp.where(tsl, nc, 0), axis=0)
        top_nt = jnp.sum(jnp.where(tsl, nt, 0.0), axis=0)
        has_nc = can & (top_nc >= 0)
        direct = has_nc & (top_nt < best_t)   # descend straight to the child
        prune = has_nc & ~direct              # consume; re-pop next round (the
        # current row re-runs idempotently: strict < best_t blocks re-updates)
        parent = can & ~has_nc                # re-gather parent, test mask
        cur = jnp.where(direct, top_nc,
                        jnp.where(parent, top_c,
                                  jnp.where(need_pop & ~can, DEAD, cur)))
        pend = jnp.where(direct, 0xFF, jnp.where(parent, top_m, pend))
        # consume the stored child; drop the level when nothing remains on it
        consume = direct | prune
        empty = consume & (top_m == 0)
        nc = jnp.where(consume[None, :] & tsl, -1, nc)
        lvl = jnp.where(empty | parent, lvl - 1, lvl)
        cur = jnp.where(found, DEAD, cur)
        return (
            rounds + 1,
            cur,
            pend,
            lvl,
            pid,
            pmask,
            nc,
            nt,
            best_t,
            best_p,
            bu,
            bv,
        )

    def cond(state):
        rounds, cur = state[0], state[1]
        return (jnp.sum(cur != DEAD) > stop_n) & (rounds < max_rounds)

    state = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.int32(0),
            cur0,
            pend0,
            lvl0,
            pid0,
            pmask0,
            nc0,
            nt0,
            best_t0,
            best_p0,
            bu0,
            bv0,
        ),
    )
    rounds = state[0]
    live = state[1] != DEAD
    best_t, best_p, bu, bv = state[8], state[9], state[10], state[11]
    walk = (state[1], state[2], state[3], state[4], state[5], state[6],
            state[7])
    return best_t, best_p, bu, bv, live, rounds, walk


def _compact_indices(live, n_out):
    """Indices of live lanes packed to the front of an (n_out,) buffer,
    -1 padded. The caller guarantees live_count <= n_out (phase stop_n)."""
    n = live.shape[0]
    pos = jnp.cumsum(live.astype(jnp.int32)) - 1
    pos = jnp.where(live, jnp.minimum(pos, n_out), n_out)  # dump slot n_out
    lidx = jnp.full((n_out + 1,), -1, jnp.int32)
    lidx = lidx.at[pos].set(jnp.arange(n, dtype=jnp.int32))
    return lidx[:n_out]


# straggler compaction: a phase stops once live lanes fall under 1/PHASE_DIV
# of its width; survivors (with their walk state) re-gather into a
# width/PHASE_DIV buffer and resume. Phases shrink down to MIN_PHASE, then
# the last one drains.
PHASE_DIV = 8
MIN_PHASE = 4096


@functools.partial(
    jax.jit, static_argnames=("root", "m", "depth", "max_rounds")
)
def _traverse(
    rows, o, d, tnear, tfar, latch, root, m, depth, max_rounds=16384
):
    """Compacting traversal driver. The while_loop in `_phase` runs every
    lane through every round, so its cost is N x max-straggler-rounds; on
    measured materialtest wavefronts the straggler tail is ~88 rounds vs a
    ~hand-count mean of 10-20. Phases cut the tail: run all N lanes until
    only 1/8 are live, compact those into an N/8 buffer (one cumsum+scatter
    at N + seven cheap gathers at N/8), and continue; repeat once more at
    N/64, then drain. Restarting a compacted lane from the root re-does a
    few rounds of descent but its carried best_t prunes the re-walk."""
    N = o.shape[0]
    best_t = tfar
    best_p = jnp.full((N,), -1, jnp.int32)
    bu = jnp.zeros((N,), jnp.float32)
    bv = jnp.zeros((N,), jnp.float32)
    active = tfar > tnear

    args = dict(root=root, m=m, depth=depth, max_rounds=max_rounds)
    if N < 2 * MIN_PHASE:
        best_t, best_p, bu, bv, _, rounds, _ = _phase(
            rows, o, d, tnear, best_t, best_p, bu, bv, active, latch,
            stop_n=0, **args)
        return best_t, best_p, bu, bv, rounds

    # geometric phase schedule: run until <= width/PHASE_DIV stragglers
    # remain, compact to that width, repeat until the floor, then drain
    # the final (smallest) width completely. Compaction carries the WALK
    # STATE (cursor, pending mask, bitstack) through the gather, so a
    # compacted lane RESUMES mid-walk instead of restarting from the root
    # (the old restart re-descended and re-tested on every phase change).
    targets = []
    w = N
    while w > MIN_PHASE:
        w = max(w // PHASE_DIV, MIN_PHASE // 8)
        targets.append(w)

    rounds = jnp.int32(0)
    # current working set: lane ids into the ORIGINAL arrays (-1 = pad)
    cur_ids = None
    oc, dc, tnc = o, d, tnear
    btc, bpc, buc, bvc = best_t, best_p, bu, bv
    act = active
    ltc = latch
    walk = None
    for nw in targets + [0]:  # stop targets; 0 = final full drain
        btc, bpc, buc, bvc, live, r, walk = _phase(
            rows, oc, dc, tnc, btc, bpc, buc, bvc, act, ltc,
            stop_n=nw, state0=walk, **args)
        rounds = rounds + r
        if cur_ids is None:
            best_t, best_p, bu, bv = btc, bpc, buc, bvc
        else:
            # NB: negative scatter indices WRAP numpy-style before the
            # bounds check — remap -1 pads to an OOB sentinel to drop
            wids = jnp.where(cur_ids >= 0, cur_ids, N)
            best_t = best_t.at[wids].set(btc, mode="drop")
            best_p = best_p.at[wids].set(bpc, mode="drop")
            bu = bu.at[wids].set(buc, mode="drop")
            bv = bv.at[wids].set(bvc, mode="drop")
        if nw == 0:
            break
        c = _compact_indices(live, nw)  # slot in current buffers, -1 pad
        sc = jnp.maximum(c, 0)
        act = c >= 0
        wc, wp, wl, wpid, wpm, wnc, wnt = walk
        # gather COUNT dominates compaction cost (each gather is latency-
        # bound): pack the per-lane f32/i32 state into one wide row each,
        # so a transition is 5 gathers (f32 pack, i32 pack, bitstack i32
        # pack, bitstack f32, ids) instead of ~20
        L = wpid.shape[0]
        fpack = jnp.concatenate(
            [oc, dc, tnc[:, None], btc[:, None], buc[:, None], bvc[:, None]],
            axis=1,
        )[sc]
        oc, dc = fpack[:, 0:3], fpack[:, 3:6]
        tnc, btc, buc, bvc = (fpack[:, 6], fpack[:, 7], fpack[:, 8],
                              fpack[:, 9])
        ids = cur_ids if cur_ids is not None else jnp.arange(
            live.shape[0], dtype=jnp.int32)
        ipack = jnp.stack(
            [ids, bpc, wc, wp, wl, ltc.astype(jnp.int32)], axis=1)[sc]
        cur_ids = jnp.where(act, ipack[:, 0], -1)
        bpc = ipack[:, 1]
        ltc = ipack[:, 5].astype(bool)
        wstk_i = jnp.concatenate([wpid, wpm, wnc], axis=0)[:, sc]
        walk = (
            jnp.where(act, ipack[:, 2], DEAD), ipack[:, 3], ipack[:, 4],
            wstk_i[0:L], wstk_i[L:2 * L], wstk_i[2 * L:3 * L], wnt[:, sc],
        )
    return best_t, best_p, bu, bv, rounds


def intersect_bvh_gather(pack: GatherBvhPack, o, d, tnear, tfar) -> Hit:
    """Closest-hit query; Hit.prim are scene triangle ids."""
    latch = jnp.zeros(o.shape[:-1], bool)
    return intersect_bvh_gather_mixed(pack, o, d, tnear, tfar, latch)


def intersect_bvh_gather_mixed(pack: GatherBvhPack, o, d, tnear, tfar,
                               latch) -> Hit:
    """Mixed query: lanes with latch=True are any-hit (first hit latches,
    lane leaves the walk — only Hit.prim >= 0 is meaningful there); lanes
    with latch=False are closest-hit. One walk, one compile — shadow and
    continuation rays of a wavefront bounce share the straggler phases."""
    best_t, best_p, bu, bv, _ = _traverse(
        pack.rows, o, d, tnear, tfar, latch, root=pack.root, m=pack.n_rows,
        depth=pack.depth,
    )
    miss = best_p < 0
    return Hit(
        t=jnp.where(miss, INF, best_t),
        prim=best_p,
        u=jnp.where(miss, 0.0, bu),
        v=jnp.where(miss, 0.0, bv),
    )


def occluded_bvh_gather(pack: GatherBvhPack, o, d, tnear, tfar) -> jnp.ndarray:
    """Any-hit query -> bool per ray (lanes latch and die on first hit)."""
    latch = jnp.ones(o.shape[:-1], bool)
    _, best_p, _, _, _ = _traverse(
        pack.rows, o, d, tnear, tfar, latch, root=pack.root, m=pack.n_rows,
        depth=pack.depth,
    )
    return best_p >= 0
