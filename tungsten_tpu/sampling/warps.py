"""Sampling warps (batched jnp), mirroring src/core/sampling/SampleWarp.hpp.

All take u: (..., 2) or (...,) uniforms and return directions in the local
frame (+z = normal) or pdf values. Inverse warps (needed by RJ-MLT) live next
to their forward warp.
"""
from __future__ import annotations

import jax.numpy as jnp

INV_PI = 1.0 / jnp.pi
INV_TWO_PI = 1.0 / (2.0 * jnp.pi)
INV_FOUR_PI = 1.0 / (4.0 * jnp.pi)


def cosine_hemisphere(u):
    phi = u[..., 0] * (2.0 * jnp.pi)
    r = jnp.sqrt(u[..., 1])
    z = jnp.sqrt(jnp.maximum(1.0 - u[..., 1], 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def cosine_hemisphere_pdf(w):
    return jnp.maximum(w[..., 2], 0.0) * INV_PI


def uniform_hemisphere(u):
    phi = (2.0 * jnp.pi) * u[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - u[..., 1] * u[..., 1], 0.0))
    return jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, u[..., 1]], axis=-1)


def uniform_hemisphere_pdf(w):
    return INV_TWO_PI * jnp.ones(w.shape[:-1], jnp.float32)


def uniform_sphere(u):
    phi = u[..., 0] * (2.0 * jnp.pi)
    z = u[..., 1] * 2.0 - 1.0
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf(w):
    return INV_FOUR_PI * jnp.ones(w.shape[:-1], jnp.float32)


def uniform_spherical_cap(u, cos_theta_max):
    """Cone around +z with cos(theta) in [cos_theta_max, 1]."""
    phi = u[..., 0] * (2.0 * jnp.pi)
    z = u[..., 1] * (1.0 - cos_theta_max) + cos_theta_max
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, z], axis=-1)


def uniform_spherical_cap_pdf(cos_theta_max):
    return INV_TWO_PI / (1.0 - cos_theta_max)


def uniform_triangle_uv(u):
    """Uniform barycentric (u, v) on a triangle (SampleWarp::uniformTriangleUv)."""
    u1 = jnp.sqrt(u[..., 0])
    a = 1.0 - u1
    b = u[..., 1] * u1
    return jnp.stack([a, b], axis=-1)


def uniform_disk(u):
    phi = u[..., 0] * (2.0 * jnp.pi)
    r = jnp.sqrt(u[..., 1])
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def power_heuristic(pdf0, pdf1):
    """Veach power heuristic with beta=2 (SampleWarp.hpp:189)."""
    p0 = pdf0 * pdf0
    p1 = pdf1 * pdf1
    return p0 / jnp.maximum(p0 + p1, 1e-38)


def phi_theta_to_dir(phi, theta):
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def tent_filter_sample(u):
    """Analytic inverse-CDF sample of the tent (triangle) filter on [-1, 1].

    The reference importance-samples a 31-bin tabulated CDF of the filter
    (ReconstructionFilter.hpp:19-33); the exact analytic inverse needs no
    table and is strictly better stratified.
    """
    return jnp.where(u < 0.5, jnp.sqrt(2.0 * u) - 1.0, 1.0 - jnp.sqrt(jnp.maximum(2.0 - 2.0 * u, 0.0)))


def gaussian_filter_sample(u0, u1, width=2.0, alpha=2.0):
    """Box-Muller sample of the (truncated-ish) gaussian filter."""
    r = jnp.sqrt(-jnp.log(jnp.maximum(1e-7, 1.0 - u0 * (1.0 - jnp.exp(-alpha * width * width)))) / alpha)
    phi = 2.0 * jnp.pi * u1
    return r * jnp.cos(phi), r * jnp.sin(phi)


# ---- inverse warps (RJ-MLT path inversion, SampleWarp.hpp:17-146) ---------
# Each invert_* is a right-inverse of its forward warp: forward(invert(w))
# reproduces w up to fp rounding. `mu` supplies the free uniform for
# degenerate (measure-zero) inputs, mirroring the reference's untracked1D().

def invert_phi(w, mu=0.5):
    """Azimuth of w as a [0,1) uniform (SampleWarp::invertPhi)."""
    degen = (w[..., 0] == 0.0) & (w[..., 1] == 0.0)
    res = jnp.where(
        degen, mu * INV_TWO_PI * (2.0 * jnp.pi),
        jnp.arctan2(w[..., 1], w[..., 0]) * INV_TWO_PI,
    )
    return jnp.where(res < 0.0, res + 1.0, res)


def invert_cosine_hemisphere(w, mu=0.5):
    return jnp.stack(
        [invert_phi(w, mu), jnp.maximum(1.0 - w[..., 2] * w[..., 2], 0.0)],
        axis=-1,
    )


def invert_uniform_hemisphere(w, mu=0.5):
    return jnp.stack([invert_phi(w, mu), w[..., 2]], axis=-1)


def invert_uniform_sphere(w, mu=0.5):
    return jnp.stack([invert_phi(w, mu), (w[..., 2] + 1.0) * 0.5], axis=-1)


def invert_uniform_disk(p, mu=0.5):
    return jnp.stack(
        [invert_phi(p, mu), p[..., 0] ** 2 + p[..., 1] ** 2], axis=-1
    )


def invert_uniform_spherical_cap(w, cos_theta_max, mu=0.5):
    """Returns (u2, ok) — ok False when w lies outside the cap."""
    y = (w[..., 2] - cos_theta_max) / jnp.maximum(1.0 - cos_theta_max, 1e-20)
    ok = (y >= 0.0) & (y < 1.0)
    return jnp.stack([invert_phi(w, mu), jnp.clip(y, 0.0, 1.0)], axis=-1), ok


def invert_uniform_triangle_uv(bary):
    """Inverse of uniform_triangle_uv: barycentric (a, b) -> u2."""
    u1 = 1.0 - bary[..., 0]
    u0 = u1 * u1
    ub = bary[..., 1] / jnp.maximum(u1, 1e-20)
    return jnp.stack([u0, jnp.clip(ub, 0.0, 1.0)], axis=-1)
