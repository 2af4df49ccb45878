"""Device-side discrete distributions (CDF warps).

Wavefront analogs of src/core/sampling/Distribution1D.hpp and
Distribution2D.hpp:11-60: CDFs are built host-side (numpy) at scene-flatten
time and sampled on device with vectorized binary search
(jnp.searchsorted over the whole wavefront).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils.pytree import dataclass as pytree


@pytree
class Distribution1D:
    """cdf: (n+1,) with cdf[0]=0, cdf[-1]=1;  pdf: (n,) discrete prob."""

    pdf: jnp.ndarray
    cdf: jnp.ndarray

    @staticmethod
    def build(weights: np.ndarray) -> "Distribution1D":
        w = np.asarray(weights, np.float64).ravel()
        total = w.sum()
        if total <= 0.0:
            w = np.ones_like(w)
            total = w.sum()
        p = w / total
        cdf = np.concatenate([[0.0], np.cumsum(p)])
        cdf[-1] = 1.0
        return Distribution1D(pdf=jnp.asarray(p, jnp.float32), cdf=jnp.asarray(cdf, jnp.float32))

    def sample(self, u):
        """u: (...,) -> (idx, pdf, u_remapped). u is reused within the bin
        (matches Distribution1D::warp's reuse for a fresh uniform)."""
        idx = jnp.clip(jnp.searchsorted(self.cdf, u, side="right") - 1, 0, self.pdf.shape[0] - 1)
        lo = self.cdf[idx]
        p = self.pdf[idx]
        u_re = jnp.where(p > 0, (u - lo) / jnp.maximum(p, 1e-38), 0.0)
        return idx, p, jnp.clip(u_re, 0.0, 1.0)

    def prob(self, idx):
        return self.pdf[idx]


@pytree
class Distribution2D:
    """Row-major 2D distribution (marginal over rows, conditional over
    columns) with an O(1) Walker/Vose ALIAS TABLE for sampling.

    Mirrors Distribution2D.hpp:11-60 semantics: sample() returns integer
    cell (x, y) plus the discrete pdf; continuous uv is
    (cell + remapped u) / res. The reference samples by two binary
    searches, ~22 serialized gather rounds per lane on a 2k envmap, while
    the alias method is exactly two bundled gathers. The CDF arrays are kept
    for pdf_at lookups (env_direct_pdf)."""

    marginal_pdf: jnp.ndarray  # (h,)
    marginal_cdf: jnp.ndarray  # (h+1,)
    cond_pdf: jnp.ndarray  # (h, w)
    cond_cdf: jnp.ndarray  # (h, w+1)
    alias_prob: jnp.ndarray = None  # (h*w,) stay-probability
    alias_idx: jnp.ndarray = None  # (h*w,) alias cell
    joint_pdf: jnp.ndarray = None  # (h*w,) discrete cell prob
    # (h*w, 4) packed [stay-prob, alias-cell, joint_pdf(cell), joint_pdf
    # (alias)] — one row gather answers the whole alias draw (cell ids
    # < 2^20 are exact in f32)
    alias_pack: jnp.ndarray = None

    @property
    def shape(self):
        return self.cond_pdf.shape

    @staticmethod
    def build(weights: np.ndarray) -> "Distribution2D":
        w = np.asarray(weights, np.float64)
        # cap the importance map at ~1M cells (block means): the sampler's
        # pdf is the DISTRIBUTION's own cell pdf, so a coarser map stays
        # exactly unbiased (the intra-cell uv remap spans the bigger cell);
        # it only importance-matches high-frequency envmaps slightly worse,
        # while the alias build and the sampling gathers get 4-20x smaller
        MAX_CELLS = 1 << 20
        while w.shape[0] * w.shape[1] > MAX_CELLS and w.shape[0] % 2 == 0 and w.shape[1] % 2 == 0:
            w = 0.25 * (w[0::2, 0::2] + w[1::2, 0::2] + w[0::2, 1::2] + w[1::2, 1::2])
        h, width = w.shape
        row_sums = w.sum(axis=1)
        total = row_sums.sum()
        if total <= 0.0:
            w = np.ones_like(w)
            row_sums = w.sum(axis=1)
            total = row_sums.sum()
        marg = row_sums / total
        mcdf = np.concatenate([[0.0], np.cumsum(marg)])
        mcdf[-1] = 1.0
        safe_rows = np.where(row_sums > 0, row_sums, 1.0)[:, None]
        cond = np.where(row_sums[:, None] > 0, w / safe_rows, 1.0 / width)
        ccdf = np.concatenate([np.zeros((h, 1)), np.cumsum(cond, axis=1)], axis=1)
        ccdf[:, -1] = 1.0
        joint = (marg[:, None] * cond).ravel()
        prob, alias = _build_alias(joint)
        apack = np.stack(
            [prob, alias.astype(np.float64), joint, joint[alias]], axis=1
        ).astype(np.float32)
        return Distribution2D(
            marginal_pdf=jnp.asarray(marg, jnp.float32),
            marginal_cdf=jnp.asarray(mcdf, jnp.float32),
            cond_pdf=jnp.asarray(cond, jnp.float32),
            cond_cdf=jnp.asarray(ccdf, jnp.float32),
            alias_prob=jnp.asarray(prob, jnp.float32),
            alias_idx=jnp.asarray(alias, jnp.int32),
            joint_pdf=jnp.asarray(joint, jnp.float32),
            alias_pack=jnp.asarray(apack),
        )

    def sample(self, u):
        """u: (..., 2) -> (x, y, pdf_discrete, uv_remapped (..., 2)).

        Walker alias method: k = floor(u0*N) picks a column of the alias
        table; u1 against its stay-probability picks cell k or its alias.
        The residuals of both uniforms are themselves fresh uniforms, so
        they become the intra-texel (vx, vy) remap — same signature and
        distribution as the CDF version, two gathers instead of ~22."""
        h, w = self.shape
        n_cells = h * w
        u0 = jnp.clip(u[..., 0], 0.0, 1.0 - 1e-7)
        u1 = jnp.clip(u[..., 1], 0.0, 1.0 - 1e-7)
        k = jnp.minimum((u0 * n_cells).astype(jnp.int32), n_cells - 1)
        r0 = u0 * n_cells - k.astype(jnp.float32)  # fresh uniform
        row = self.alias_pack[k]  # ONE gather: prob, alias, pdf(k), pdf(alias)
        pk = row[..., 0]
        stay = u1 < pk
        cell = jnp.where(stay, k, row[..., 1].astype(jnp.int32))
        pdf = jnp.where(stay, row[..., 2], row[..., 3])
        r1 = jnp.where(
            stay,
            u1 / jnp.maximum(pk, 1e-20),
            (u1 - pk) / jnp.maximum(1.0 - pk, 1e-20),
        )
        x = cell % w
        y = cell // w
        vx = jnp.clip(r0, 0.0, 1.0)
        vy = jnp.clip(r1, 0.0, 1.0)
        return x, y, pdf, jnp.stack([vx, vy], axis=-1)

    def prob(self, x, y):
        """Discrete probability of cell (x, y) — one joint-table gather."""
        h, w = self.shape
        return self.joint_pdf[jnp.clip(y, 0, h - 1) * w + jnp.clip(x, 0, w - 1)]


def _build_alias(p: np.ndarray):
    """Walker alias-table construction for a discrete distribution p (sums
    to 1). Returns (prob (N,), alias (N,)): sample k ~ U{0..N-1}, then
    cell = k if u < prob[k] else alias[k].

    Vectorized wave variant of Vose's method (a pure-python pairing loop
    takes tens of seconds on multi-megapixel envmaps): each wave pairs the
    current under-full cells with a prefix of donor cells whose cumulative
    surplus covers them (one sort + cumsum per wave); donors left partially
    drained re-enter the next wave. Converges in O(log N) waves."""
    n = p.shape[0]
    scaled = np.asarray(p, np.float64) * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    for _ in range(64):
        small = np.where(scaled < 1.0 - 1e-12)[0]
        large = np.where(scaled >= 1.0 + 1e-12)[0]
        if small.size == 0 or large.size == 0:
            break
        surplus = scaled[large] - 1.0
        cum = np.cumsum(surplus)
        deficit = 1.0 - scaled[small]
        dcum = np.cumsum(deficit)
        # small[i] is paired with the donor whose cumulative surplus first
        # reaches dcum[i] (each donor may cover several smalls in one wave)
        donor_pos = np.searchsorted(cum, dcum - 1e-15, side="left")
        ok = donor_pos < large.size
        s_ok = small[ok]
        d_ok = large[donor_pos[ok]]
        prob[s_ok] = scaled[s_ok]
        alias[s_ok] = d_ok
        scaled[s_ok] = 1.0  # resolved
        # drain the donors by what their assigned smalls consumed
        consumed = np.bincount(
            donor_pos[ok], weights=deficit[ok], minlength=large.size
        )
        scaled[large] -= consumed
    return prob.astype(np.float32), alias.astype(np.int32)


def _searchsorted_strided(flat, base, u, row_len, max_len=None):
    """'right' searchsorted of u in flat[base : base+row_len], per lane.

    flat: concatenated sorted rows; base, u: (...,); row_len: int or per-lane
    array. Branchless binary search with ceil(log2(max_len)) scalar gathers —
    vector- and gather-friendly.
    """
    import math

    if max_len is None:
        max_len = int(row_len)
    steps = max(1, math.ceil(math.log2(max_len + 1)))
    lo = jnp.zeros_like(base)  # invariant: flat[base+lo] <= u (cdf[0] == 0)
    width = jnp.broadcast_to(jnp.asarray(row_len, base.dtype), base.shape)
    for _ in range(steps):
        half = width // 2
        mid = lo + half
        val = flat[jnp.clip(base + mid, 0, flat.shape[0] - 1)]
        go_right = val <= u
        lo = jnp.where(go_right, mid, lo)
        width = jnp.where(go_right, width - half, half)
    return lo + 1
