"""Wavefront sample generator.

The reference threads a stateful per-path PathSampleGenerator (PCG32 /
Sobol, src/core/sampling/UniformSampler.hpp:38, SobolPathSampler.hpp) through
the recursive tracer. The wavefront equivalent is a *stateless, counter-based*
generator: every random number is a pure function of

    (seed, lane id, dimension index)

hashed with PCG4D [Jarzynski & Olano 2020, "Hash Functions for GPU Rendering"]
— a handful of vector integer ops per draw across the whole wavefront, no state
to thread, no sequential dependence. Each call site consumes one dimension;
the dimension counter lives in the Sampler pytree as a traced int32, so replay
(needed by MLT bootstrap, checkpoint resume, debugging) is exact: the same
(seed, lane, dim) always yields the same float, independent of device count,
sharding, or execution order — a stronger determinism guarantee than the
reference's thread-scheduled PCG streams.

Lane ids are *global* (pixel-major across the full image), so a render sharded
over 8 chips produces bitwise the same image as a single-chip render.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.pytree import dataclass as pytree, field

_INV_2_24 = jnp.float32(1.0 / (1 << 24))


def pcg4d(v0, v1, v2, v3):
    """PCG4D hash: 4 uint32 in -> 4 decorrelated uint32 out."""
    m = jnp.uint32(1664525)
    a = jnp.uint32(1013904223)
    v0 = v0 * m + a
    v1 = v1 * m + a
    v2 = v2 * m + a
    v3 = v3 * m + a
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def _to_unit_float(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * _INV_2_24


def _reverse_bits32(v):
    v = ((v >> 1) & jnp.uint32(0x55555555)) | ((v & jnp.uint32(0x55555555)) << 1)
    v = ((v >> 2) & jnp.uint32(0x33333333)) | ((v & jnp.uint32(0x33333333)) << 2)
    v = ((v >> 4) & jnp.uint32(0x0F0F0F0F)) | ((v & jnp.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & jnp.uint32(0x00FF00FF)) | ((v & jnp.uint32(0x00FF00FF)) << 8)
    return (v >> 16) | (v << 16)


def _lk_hash(x, seed):
    """Laine-Karras permutation [Burley 2020, "Practical Hash-based Owen
    Scrambling"]: a base-2 Owen scramble of the reversed-bit domain."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def owen_scramble_u32(v, key):
    """Owen-scramble a radical-inverse value (bits MSB-first)."""
    return _reverse_bits32(_lk_hash(_reverse_bits32(v), key))


def owen_shuffle_index(i, key):
    """Owen-shuffled sample index (nested uniform shuffle of the sequence)."""
    return _lk_hash(i, key)


_SOBOL_MAT = None


def sobol_matrices():
    """Grünschloss 1024-dim Sobol' direction numbers (32 bits of index),
    extracted from the reference's vendored table (thirdparty/sobol/sobol.h:
    29-50 layout; published data by Leonhard Grünschloss, MIT license — a
    constants table, same category as the metal IOR data)."""
    global _SOBOL_MAT
    if _SOBOL_MAT is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "data", "sobol_matrices.npz")
        # cache as NUMPY: a jnp array built inside a jit trace would cache a
        # tracer and poison every later trace (UnexpectedTracerError). jit
        # lifts the numpy constant per-trace instead.
        _SOBOL_MAT = np.load(path)["matrices"]  # (1024, 32) u32
    return _SOBOL_MAT


SOBOL_DIMS = 1024

# Per-pixel Sobol index bits kept EXACT: samples 0..2^S-1 of each pixel get
# true Owen-scrambled Sobol' points; past that the low-bit points repeat with
# a different Owen key folded from the high index bits (unbiased, random-
# padding-quality — the stratified prefix covers any practical spp).
SOBOL_LOW_BITS = 8

_SOBOL_PAIRS = None


def sobol_pair_table():
    """(512, 2*S) u32 — row j holds the first S direction numbers of Sobol'
    dims (2j, 2j+1) side by side, so one row gather serves both dims of a
    2D draw (the hot-loop layout; full matrices stay in sobol_matrices)."""
    global _SOBOL_PAIRS
    if _SOBOL_PAIRS is None:
        M = sobol_matrices()
        S = SOBOL_LOW_BITS
        P = np.concatenate([M[0::2, :S], M[1::2, :S]], axis=1)
        # rows are stored BIT-REVERSED: rev(a^b) = rev(a)^rev(b), so the XOR
        # accumulation happens in the reversed domain and the Owen scramble
        # skips its inner _reverse_bits32 (one less 16-op pass per dim)
        v = P.astype(np.uint32)
        v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
        v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
        v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
        v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
        _SOBOL_PAIRS = ((v >> 16) | (v << 16)).astype(np.uint32)
    return _SOBOL_PAIRS


_SOBOL_WIN = {}


def sobol_window_table(K):
    """(512, 2S*K) u32 — row j holds pair rows j..j+K-1 of sobol_pair_table
    concatenated (end rows edge-pad), so ONE gather at a bounce's base pair
    index prefetches every direction-number row the bounce will draw
    (gathers are latency-bound per op at wavefront widths; the per-bounce
    draw sites sit at STATIC pair offsets from the base, so each serves
    itself from a static slice of the window)."""
    if K not in _SOBOL_WIN:
        P = sobol_pair_table()  # (512, 2S)
        idx = np.minimum(np.arange(512)[:, None] + np.arange(K)[None, :], 511)
        _SOBOL_WIN[K] = P[idx].reshape(512, -1).astype(np.uint32)
    return _SOBOL_WIN[K]


def sobol_sample(dim, index):
    """sobol::sample (sobol.h:40-52), vectorized: XOR the matrix columns of
    `dim` selected by the set bits of `index`. dim (N,) int32, index (N,) u32."""
    rows = jnp.take(sobol_matrices(), jnp.clip(dim, 0, SOBOL_DIMS - 1), axis=0)  # (N, 32)
    res = jnp.zeros(index.shape, jnp.uint32)
    idx = index
    for i in range(32):
        bit = (idx >> jnp.uint32(i)) & jnp.uint32(1)
        res = res ^ jnp.where(bit == 1, rows[..., i], jnp.uint32(0))
    return res


@pytree
class Sampler:
    """Per-lane counter-based sample stream.

    seed:     (2,) uint32 — render seed (e.g. folded from 0xBA5EBA11 + pass).
    lane_id:  (N,) uint32 — globally unique lane ids (stable under sharding).
    dim:      ()   int32  — next dimension to consume (traced).
    table:    optional (N, D, 2) float32 primary-sample table — when present,
              draws read table[:, dim] instead of hashing (the MLT
              WritablePathSampleGenerator analog: mutations edit the table,
              replay is exact). Dims beyond D fall back to the hash.
    """

    seed: jnp.ndarray
    lane_id: jnp.ndarray
    dim: jnp.ndarray
    table: jnp.ndarray = None
    samp_idx: jnp.ndarray = None  # (N,) u32 per-pixel sample number (sobol)
    pix_key: jnp.ndarray = None  # (N,) u32 pixel id (sobol scramble key)
    strat: bool = field(pytree_node=False, default=False)
    # second component of the last pair draw, awaiting the next next_1d()
    # call (two 1D sites share one _draw; None-ness is static per trace
    # position, so the pairing costs no runtime branching)
    pending: jnp.ndarray = None
    # prefetched direction-number window (N, 2S*K): pair rows base..base+K-1
    # fetched in ONE gather by prefetch(); draw sites read static slices.
    # stat_off counts pair draws since construction — a PYTHON int (every
    # _advance passes a literal), so the window offset is trace-static.
    win: jnp.ndarray = None
    stat_off: int = field(pytree_node=False, default=0)

    @staticmethod
    def create(seed, lane_ids: jnp.ndarray, table=None, samp_idx=None,
               pix_key=None, strat=False) -> "Sampler":
        if isinstance(seed, int):
            seed = jnp.array([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF], jnp.uint32)
        seed = jnp.asarray(seed).astype(jnp.uint32).reshape(2)
        return Sampler(
            seed=seed, lane_id=lane_ids.astype(jnp.uint32), dim=jnp.int32(0),
            table=table, samp_idx=samp_idx, pix_key=pix_key,
            strat=bool(strat) and table is None and samp_idx is not None,
        )

    def _draw(self):
        d = self.dim.astype(jnp.uint32)
        r0, r1, _, _ = pcg4d(
            self.lane_id,
            jnp.broadcast_to(d, self.lane_id.shape),
            jnp.broadcast_to(self.seed[0], self.lane_id.shape),
            jnp.broadcast_to(self.seed[1], self.lane_id.shape),
        )
        u0, u1 = _to_unit_float(r0), _to_unit_float(r1)
        if self.strat:
            # true multi-dim Sobol' QMC (SobolPathSampler.hpp:20-72 analog):
            # draw #d reads Grünschloss dimensions (2d, 2d+1) at the pixel's
            # per-sample index (same index across all dims of one sample —
            # the property that makes it a Sobol' point, not just a per-pair
            # net), then Owen-scrambles each dimension with a (pixel, dim)
            # key [Burley 2020] — net-preserving, stronger than the
            # reference's XOR scramble, and the sole pixel decorrelator (a
            # per-pixel index block jump would be redundant with it). Hot-
            # loop layout: only the low SOBOL_LOW_BITS of the index select
            # direction numbers (one paired-row gather + an S-step XOR);
            # index bits above that fold into the Owen key (unbiased point
            # reuse past 2^S spp). Past 1024 dims the draw falls back to a
            # per-(pixel,dim,sample) hash (the reference falls back to plain
            # PCG there too, UniformSampler.hpp).
            S = SOBOL_LOW_BITS
            shp = self.pix_key.shape
            db = jnp.broadcast_to(d, shp)
            di = db.astype(jnp.int32)
            use_qmc = 2 * di + 1 < SOBOL_DIMS
            # ONE hash serves both roles: in qmc mode the 3rd input is
            # forced to 0 so (v1, v2) are samp-independent Owen KEYS; in the
            # hash fallback it is the sample index so (v0, v3) are fresh
            # per-(pixel, dim, sample) uniforms.
            h0, k1, k2, h1 = pcg4d(
                self.pix_key, db,
                jnp.where(use_qmc, jnp.uint32(0), self.samp_idx),
                jnp.broadcast_to(self.seed[0] ^ jnp.uint32(0x50B07), shp),
            )
            o = self.stat_off
            if self.win is not None and 0 <= o < self.win.shape[-1] // (2 * S):
                # served from the prefetched window: a STATIC slice, no gather
                rows = self.win[..., 2 * S * o: 2 * S * (o + 1)]
            else:
                rows = jnp.take(
                    jnp.asarray(sobol_pair_table()),
                    jnp.clip(di, 0, SOBOL_DIMS // 2 - 1), axis=0,
                )  # (N, 2S): bit-reversed dims (2d, 2d+1) side by side
            x = jnp.zeros(shp, jnp.uint32)
            y = jnp.zeros(shp, jnp.uint32)
            for i in range(S):
                bit = (self.samp_idx >> jnp.uint32(i)) & jnp.uint32(1)
                on = bit == 1
                x = x ^ jnp.where(on, rows[..., i], jnp.uint32(0))
                y = y ^ jnp.where(on, rows[..., S + i], jnp.uint32(0))
            hi = (self.samp_idx >> jnp.uint32(S)) * jnp.uint32(0x9E3779B9)
            # x/y are already bit-reversed: finish the Owen scramble with
            # lk_hash + one outer reverse
            u0 = jnp.where(
                use_qmc, _to_unit_float(_reverse_bits32(_lk_hash(x, k1 ^ hi))),
                _to_unit_float(h0),
            )
            u1 = jnp.where(
                use_qmc, _to_unit_float(_reverse_bits32(_lk_hash(y, k2 ^ hi))),
                _to_unit_float(h1),
            )
        if self.table is not None:
            dmax = self.table.shape[1]
            idx = jnp.clip(self.dim, 0, dmax - 1)
            row = jax.lax.dynamic_slice_in_dim(self.table, idx, 1, axis=1)[:, 0]
            in_table = self.dim < dmax
            u0 = jnp.where(in_table, row[:, 0], u0)
            u1 = jnp.where(in_table, row[:, 1], u1)
        return u0, u1

    def next_1d(self) -> Tuple[jnp.ndarray, "Sampler"]:
        if self.pending is not None:
            return self.pending, self._advance(0, pending=None)
        u0, u1 = self._draw()
        return u0, self._advance(1, pending=u1)

    def next_2d(self) -> Tuple[jnp.ndarray, "Sampler"]:
        u0, u1 = self._draw()
        u = jnp.stack([u0, u1], axis=-1)
        return u, self._advance(1, pending=self.pending)

    def next_bool(self, p) -> Tuple[jnp.ndarray, "Sampler"]:
        """Bernoulli(p) per lane (PathSampleGenerator::nextBoolean)."""
        u, s = self.next_1d()
        return u < p, s

    def next_discrete(self, n) -> Tuple[jnp.ndarray, "Sampler"]:
        u, s = self.next_1d()
        return jnp.minimum((u * n).astype(jnp.int32), jnp.asarray(n, jnp.int32) - 1), s

    def skip(self, n) -> "Sampler":
        """Advance the dimension counter; keeps lax.while bounce iterations
        consuming a fixed dimension budget so streams stay aligned. Drops
        any pending half-draw (skip means skip)."""
        return self._advance(n, pending=None)

    def prefetch(self, K=8) -> "Sampler":
        """ONE gather prefetching direction-number pair rows dim..dim+K-1
        (sobol_window_table); subsequent draws at static offsets < K read
        the window with no gather of their own. No-op outside strat mode."""
        if not self.strat:
            return self
        base = jnp.clip(self.dim.astype(jnp.int32), 0, 511)
        win = jnp.take(jnp.asarray(sobol_window_table(K)), base, axis=0)
        return Sampler(
            self.seed, self.lane_id, self.dim, self.table,
            self.samp_idx, self.pix_key, self.strat, self.pending,
            win, 0,
        )

    def _advance(self, n, pending=None):
        # stat_off is static pytree metadata: keep it 0 whenever there is no
        # window so windowless Samplers share one treedef (loop carries in
        # BDPT/MLT would otherwise change structure across iterations)
        ni = n if isinstance(n, (int, np.integer)) else None
        win = self.win if ni is not None else None
        return Sampler(
            self.seed, self.lane_id, self.dim + n, self.table,
            self.samp_idx, self.pix_key, self.strat, pending,
            win, self.stat_off + ni if win is not None else 0,
        )


def sobol02(index):
    """Kollig-Keller (0,2)-sequence point for a scalar sample index:
    (van-der-Corput radical inverse, Sobol' second dimension). The
    stand-in for the reference's SobolPathSampler on the image/lens dims —
    per-lane Cranley-Patterson rotations decorrelate pixels
    (SobolPathSampler.hpp:20-23 uses per-pixel scrambles the same way)."""
    i = jnp.asarray(index, jnp.uint32)
    # dim 1: bit reversal
    v = i
    v = ((v >> 1) & jnp.uint32(0x55555555)) | ((v & jnp.uint32(0x55555555)) << 1)
    v = ((v >> 2) & jnp.uint32(0x33333333)) | ((v & jnp.uint32(0x33333333)) << 2)
    v = ((v >> 4) & jnp.uint32(0x0F0F0F0F)) | ((v & jnp.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & jnp.uint32(0x00FF00FF)) | ((v & jnp.uint32(0x00FF00FF)) << 8)
    d1 = (v >> 16) | (v << 16)
    # dim 2: Sobol' direction-number recurrence (Kollig & Keller Sample02)
    res = jnp.uint32(0)
    vdir = jnp.uint32(1 << 31)
    n = i
    for _ in range(32):
        res = jnp.where((n & 1) == 1, res ^ vdir, res)
        n = n >> 1
        vdir = vdir ^ (vdir >> 1)
    return d1, res


def stratified_cam_2d(lane_id, pass_index):
    """Stratified AA sample: (0,2)-sequence over passes + per-lane rotation.
    The rotation is pass-independent so a pixel's spp samples stratify."""
    d1, d2 = sobol02(pass_index)
    r0, r1, _, _ = pcg4d(
        lane_id,
        jnp.full(lane_id.shape, 0xC0FFEE, jnp.uint32),
        jnp.full(lane_id.shape, 0x5EED5EED, jnp.uint32),
        jnp.full(lane_id.shape, 0x12345678, jnp.uint32),
    )
    # Cranley-Patterson rotation in float (wrap)
    b0 = _to_unit_float(jnp.broadcast_to(d1, lane_id.shape))
    b1 = _to_unit_float(jnp.broadcast_to(d2, lane_id.shape))
    o0 = _to_unit_float(r0)
    o1 = _to_unit_float(r1)
    u0 = b0 + o0
    u1 = b1 + o1
    u0 = u0 - jnp.floor(u0)
    u1 = u1 - jnp.floor(u1)
    return jnp.stack([u0, u1], axis=-1)
