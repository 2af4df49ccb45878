"""Device-side batched vector math (jnp, float32, SoA-last layout).

All functions operate on arrays whose last axis is the 3-vector, i.e. shape
(..., 3), so a wavefront of N rays is (N, 3). This is the wavefront analog of
the reference's Vec3f (src/core/math/Vec.hpp): one lane per ray instead of one
struct per ray.
"""
from __future__ import annotations

import jax.numpy as jnp

F32_MAX = jnp.finfo(jnp.float32).max


def dot(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims=False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def length_sq(v, keepdims=False):
    return dot(v, v, keepdims=keepdims)


def normalize(v, eps=0.0):
    n = length(v, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def reflect(wi_z_up):
    """Mirror reflection in the local frame (normal = +z): (-x, -y, z)."""
    return wi_z_up * jnp.array([-1.0, -1.0, 1.0], jnp.float32)


def lerp(a, b, t):
    return a + (b - a) * t


def avg3(v):
    return jnp.mean(v, axis=-1)


def max3(v):
    return jnp.max(v, axis=-1)


def tangent_frame(n):
    """Orthonormal basis from a normal, (..., 3) -> (t, b).

    [Duff et al. 2017], matching the reference's TangentFrame
    (src/core/math/TangentFrame.hpp:23-31) so shading frames agree bitwise-ish.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def to_local(t, b, n, v):
    """World -> tangent space: (v.t, v.b, v.n)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_global(t, b, n, v):
    """Tangent -> world: t*x + b*y + n*z."""
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def where3(mask, a, b):
    """Select on a (...,) mask applied to (..., 3) operands."""
    return jnp.where(mask[..., None], a, b)


def safe_rsqrt(x, eps=1e-20):
    return jnp.where(x > eps, 1.0 / jnp.sqrt(jnp.maximum(x, eps)), 0.0)


def safe_div(a, b, eps=0.0):
    """a/b with 0 where b == 0 (pdf guards)."""
    return jnp.where(b != 0.0, a / jnp.where(b != 0.0, b, 1.0), eps)
