"""Shared BSDF machinery: lobe flags and the batched sample record.

Lobe bitmask mirrors src/core/bsdfs/BsdfLobes.hpp:13-34 so the integrator's
lobe-dependent logic (two-sided flip, specular MIS skips, transparency
lottery, dirac handling) has identical semantics.

Conventions (matching the reference's Bsdf interface, Bsdf.hpp:29-142):
 - directions are in the local shading frame, +z = shading normal;
 - wi points *away* from the surface toward the incoming ray origin;
 - eval() returns f * |cos(theta_o)| for *radiance* transport with the
   non-adjoint eta^2 factor folded in (Bsdf.hpp eval(event, adjoint=false));
 - sample() returns weight = f*cos/pdf (same conventions) and a solid-angle
   pdf; dirac lobes report pdf as a discrete probability and eval()/pdf()
   exclude them (they never take part in MIS).
All functions are batched over the wavefront: params (N, P), wi/wo (N, 3).
"""
from __future__ import annotations

import jax.numpy as jnp
from ...utils.pytree import dataclass as pytree


class Lobes:
    NULL = 0
    GLOSSY_R = 1 << 0
    GLOSSY_T = 1 << 1
    DIFFUSE_R = 1 << 2
    DIFFUSE_T = 1 << 3
    SPECULAR_R = 1 << 4
    SPECULAR_T = 1 << 5
    ANISOTROPIC = 1 << 6
    FORWARD = 1 << 7

    GLOSSY = GLOSSY_R | GLOSSY_T
    DIFFUSE = DIFFUSE_R | DIFFUSE_T
    SPECULAR = SPECULAR_R | SPECULAR_T
    TRANSMISSIVE = GLOSSY_T | DIFFUSE_T | SPECULAR_T
    REFLECTIVE = GLOSSY_R | DIFFUSE_R | SPECULAR_R
    ALL = TRANSMISSIVE | REFLECTIVE | ANISOTROPIC

    @staticmethod
    def is_transmissive(lobes):
        return (lobes & Lobes.TRANSMISSIVE) != 0

    @staticmethod
    def is_pure_specular(lobes):
        return (lobes != 0) & ((lobes & ~Lobes.SPECULAR) == 0)

    @staticmethod
    def has_specular(lobes):
        return (lobes & Lobes.SPECULAR) != 0

    @staticmethod
    def has_forward(lobes):
        return (lobes & Lobes.FORWARD) != 0

    @staticmethod
    def is_forward(lobes):
        return lobes == Lobes.FORWARD


@pytree
class BsdfSample:
    """Batched BSDF sample: wo (N,3) local, weight (N,3) = f*cos/pdf,
    pdf (N,), lobe (N,) int32 sampled-lobe flags, valid (N,) bool."""

    wo: jnp.ndarray
    weight: jnp.ndarray
    pdf: jnp.ndarray
    lobe: jnp.ndarray
    valid: jnp.ndarray

    @staticmethod
    def invalid(n):
        z3 = jnp.zeros((n, 3), jnp.float32)
        z = jnp.zeros((n,), jnp.float32)
        return BsdfSample(
            wo=z3.at[:, 2].set(1.0),
            weight=z3,
            pdf=z,
            lobe=jnp.zeros((n,), jnp.int32),
            valid=jnp.zeros((n,), bool),
        )


def pack_roughness(spec, key, default, tex_builder):
    """Roughness parameter slot: scalar value, or -(tex_id + 2) when the
    scene drives it with a texture (the reference's roughness is a
    Texture, e.g. RoughConductorBsdf::_roughness). Decode at eval time
    with resolve_roughness."""
    r = spec.get(key, default)
    if isinstance(r, (int, float)):
        return float(r)
    from ..textures import texture_from_spec

    tid = texture_from_spec(r, tex_builder, spec.get("_resolve_path"))
    tex_builder.rough_ids.append(tid)
    return -(float(tid) + 2.0)


def resolve_roughness(ctx, rough_param, uv):
    """Per-lane roughness: scalar slots pass through; negative-encoded
    texture ids evaluate the texture's first channel at uv."""
    import jax.numpy as jnp

    from ..textures import eval_texture

    mats, textures = ctx
    kinds = getattr(mats, "rough_kinds", None)
    if kinds is not None and len(kinds) == 0:
        return rough_param  # STATIC: no textured roughness in this scene
    tid = jnp.maximum((-rough_param - 2.0).astype(jnp.int32), 0)
    tex_r = eval_texture(textures, tid, uv, may=kinds)[..., 0]
    return jnp.where(rough_param < -1.0, tex_r, rough_param)
