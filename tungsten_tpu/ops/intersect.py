"""Ray-triangle intersection: the Hit record, Möller-Trumbore, and the
brute-force query.

Replaces embree's rtcIntersect/rtcOccluded (SURVEY.md §2.3, L4) together
with ops.gather_bvh, the BVH walk. `intersect_brute` is tiled all-pairs
Möller-Trumbore, scanned over triangle chunks: O(N*T), fully dense, used
for scenes of at most 64 triangles or with `scene_bvh: false`, and the
reference the walk is tested against. The geometry arrays come
pre-permuted in BVH leaf order; hit.prim is the *global* triangle index
after permutation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils.pytree import dataclass as pytree

from ..math import vecops as vo

INF = jnp.float32(3.0e38)


@pytree
class TriangleSoA:
    v0: jnp.ndarray  # (T, 3)
    e1: jnp.ndarray  # (T, 3)  p1 - p0
    e2: jnp.ndarray  # (T, 3)  p2 - p0


@pytree
class Hit:
    t: jnp.ndarray  # (N,) hit distance (INF if miss)
    prim: jnp.ndarray  # (N,) int32 triangle index, -1 if miss
    u: jnp.ndarray  # (N,) barycentric of e1 vertex
    v: jnp.ndarray  # (N,) barycentric of e2 vertex

    @property
    def hit_mask(self):
        return self.prim >= 0


def ray_tri(o, d, v0, e1, e2, tnear, tfar):
    """Möller-Trumbore. All args broadcastable to (..., 3) / (...,).
    Returns (t, u, v, hit)."""
    pvec = jnp.cross(d, e2)
    det = vo.dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = vo.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = vo.dot(d, qvec) * inv_det
    t = vo.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tnear)
        & (t < tfar)
    )
    return t, u, v, hit


def intersect_brute(tris: TriangleSoA, o, d, tnear, tfar, chunk: int = 512) -> Hit:
    """Chunked all-pairs intersection: scan over triangle chunks keeping the
    nearest hit. Memory is O(N * chunk)."""
    n = o.shape[0]
    t_count = tris.v0.shape[0]
    chunk = min(chunk, -(-t_count // 8) * 8)  # don't pad tiny scenes to 512
    pad = (-t_count) % chunk
    v0 = jnp.pad(tris.v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(tris.e1, ((0, pad), (0, 0)))
    e2 = jnp.pad(tris.e2, ((0, pad), (0, 0)), constant_values=0.0)
    n_chunks = (t_count + pad) // chunk

    def body(carry, ci):
        bt, bp, bu, bv = carry
        s = ci * chunk
        cv0 = jax.lax.dynamic_slice_in_dim(v0, s, chunk, 0)
        ce1 = jax.lax.dynamic_slice_in_dim(e1, s, chunk, 0)
        ce2 = jax.lax.dynamic_slice_in_dim(e2, s, chunk, 0)
        t, u, v, hit = ray_tri(
            o[:, None, :], d[:, None, :], cv0[None], ce1[None], ce2[None],
            tnear[:, None], tfar[:, None],
        )
        t = jnp.where(hit, t, INF)
        j = jnp.argmin(t, axis=1)
        tbest = jnp.take_along_axis(t, j[:, None], 1)[:, 0]
        better = tbest < bt
        idx = s + j
        bt = jnp.where(better, tbest, bt)
        bp = jnp.where(better, idx, bp)
        bu = jnp.where(better, jnp.take_along_axis(u, j[:, None], 1)[:, 0], bu)
        bv = jnp.where(better, jnp.take_along_axis(v, j[:, None], 1)[:, 0], bv)
        return (bt, bp, bu, bv), None

    init = (
        jnp.full((n,), INF),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,)),
        jnp.zeros((n,)),
    )
    (bt, bp, bu, bv), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    bp = jnp.where(bt < INF, bp, -1)
    return Hit(t=bt, prim=bp, u=bu, v=bv)
