"""Material table + batched masked BSDF dispatch.

The reference dispatches through virtual Bsdf* calls (BsdfFactory.cpp:29-52).
The wavefront equivalent: materials live in a SoA table (type id, lobe mask,
16-float parameter row, albedo texture id); the wavefront evaluates each BSDF
type *present in the scene* (a static set known at trace time) over all lanes
and selects by mask. With material-sorted queues (later optimization) the
masked work collapses to near-zero waste; for typical scenes (2-5 types) the
overhead is already small.

Nesting: wrapper BSDFs (smooth_coat/rough_coat/mixed/transparency) reference a
substrate material by table index and re-enter the dispatcher with
nested=True, which restricts the type loop to non-wrapper types — one level
of nesting, matching every scene the reference ships (coat-on-coat would need
a second level and is rejected at pack time).

Impl module interface (all batched over lanes; ctx = (MaterialTable,
TextureTable)):
    NAME: str; LOBES: int or lobes_for(spec); IS_WRAPPER: bool (default False)
    pack(spec, params, tex_builder) -> params
    eval(ctx, params, albedo, uv, wi, wo, nonspecular_only) -> (N, 3)
    pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only) -> (N,)
    sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only) -> BsdfSample
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import jax.numpy as jnp
from ...utils.pytree import dataclass as pytree, field

from .common import BsdfSample, Lobes
from . import lambert, null, mirror, rough_conductor, smooth_coat, oren_nayar, phong
from . import dielectric, rough_dielectric, conductor, plastic, rough_plastic
from . import thinsheet, transparency, forward, mixed, diffuse_transmission, rough_coat
from . import hair, lambertian_fiber, rough_wire

N_PARAMS = 16

# type-name -> (type_id, module). Order defines the stable type-id space.
_MODULES = [
    lambert, null, mirror, rough_conductor, smooth_coat, oren_nayar, phong,
    dielectric, rough_dielectric, conductor, plastic, rough_plastic,
    thinsheet, transparency, forward, mixed, diffuse_transmission, rough_coat,
    hair, lambertian_fiber, rough_wire,
]


def _registry() -> Dict[str, tuple]:
    return {m.NAME: (i, m) for i, m in enumerate(_MODULES)}


def module_for_id(type_id: int):
    return _MODULES[type_id]


def is_wrapper(mod) -> bool:
    return getattr(mod, "IS_WRAPPER", False)


@pytree
class MaterialTable:
    type: jnp.ndarray  # (M,) int32
    lobes: jnp.ndarray  # (M,) int32
    params: jnp.ndarray  # (M, 16) float32
    albedo_tex: jnp.ndarray  # (M,) int32

    # (M, 18) packed [params | type | albedo_tex] — the dispatch gather is
    # ONE row fetch (XLA gathers are latency-bound per op, so count rules)
    gpack: jnp.ndarray = None

    # (M, 28) [params | type | albedo_tex | lobes | albedo tpack row(9)]:
    # built in flatten once textures exist — the dispatch gather ALSO serves
    # the lobe mask and the albedo texture header, and albedo_kinds narrows
    # the albedo eval to the texture types materials actually reference
    # (the envmap's bitmap branch no longer taxes every albedo eval)
    gpack2: jnp.ndarray = None
    albedo_kinds: tuple = field(pytree_node=False, default=None)
    # STATIC texture kinds reachable from bsdf roughness slots (() = none)
    rough_kinds: tuple = field(pytree_node=False, default=None)

    # (M,) substrate/base material index of single-substrate wrappers
    # (smooth_coat/rough_coat/transparency), -1 otherwise; gpack3 = gpack2
    # row concatenated with the substrate's gpack2 row, so the nested
    # dispatch inside a wrapper needs NO gather of its own. sub_pre is the
    # per-lane decoded substrate pre-tuple, stashed by the integrator body
    # and picked up by nested bsdf_eval/pdf/sample calls. Only built when
    # no multi-substrate wrapper (mixed) is in the scene.
    sub_of: jnp.ndarray = None
    gpack3: jnp.ndarray = None
    sub_pre: tuple = None

    # hair BCSDF azimuthal tables (one slab per hair material; None when
    # the scene has no hair): see models/bsdfs/hair.py precompute
    hair_tables: jnp.ndarray = None  # (H, 3, 64, 64, 3)
    hair_cdf: jnp.ndarray = None  # (H, 3, 64, 65)
    hair_sums: jnp.ndarray = None  # (H, 3, 64)

    present: tuple = field(pytree_node=False, default=())  # static type-id set


def _albedo_tex_for(spec, tex_builder) -> int:
    from ..textures import texture_from_spec

    return texture_from_spec(
        spec.get("albedo", 1.0), tex_builder, spec.get("_resolve_path")
    )


def pack_materials(bsdf_specs: List[dict], tex_builder) -> MaterialTable:
    """bsdf_specs: resolved JSON dicts (one per material instance, in scene
    order; nested refs pre-resolved to "_substrate_index" etc. by load.py)."""
    # all three fiber BCSDFs are the real far-field models (hair.py,
    # lambertian_fiber.py, rough_wire.py), shading the tessellated tubes
    # through the fiber-tangent frame (path_tracer._shading_frame). hair's
    # azimuthal tables are precomputed here.
    bsdf_specs = [dict(b) for b in bsdf_specs]
    hair_tabs, hair_cdfs, hair_sums = [], [], []
    for b in bsdf_specs:
        t = b.get("type")
        if t == "hair":
            # melanin mixture -> sigma_a (HairBcsdf.cpp:433-440: lerp from
            # eumelanin to pheomelanin by melanin_ratio)
            if "sigma_a" in b:
                sa = b["sigma_a"]
                sigma = np.asarray(sa if isinstance(sa, list) else [sa] * 3, np.float64)
            else:
                c = float(b.get("melanin_concentration", 0.25))
                ratio = float(b.get("melanin_ratio", 0.5))
                eu = np.array([0.419, 0.697, 1.37])
                ph = np.array([0.187, 0.4, 1.05])
                sigma = c * ((1.0 - ratio) * eu + ratio * ph)
            beta_r = max(np.pi / 2 * float(b.get("roughness", 0.1)), 0.04)
            tab, cdf, sums = hair.precompute_azimuthal(sigma, beta_r)
            b["_hair_index"] = len(hair_tabs)
            b["_beta_r"] = beta_r
            b["_scale_rad"] = float(np.deg2rad(float(b.get("scale_angle", 2.0))))
            hair_tabs.append(tab)
            hair_cdfs.append(cdf)
            hair_sums.append(sums)
    reg = _registry()
    n = len(bsdf_specs)
    types = [0] * n
    lobes = [0] * n
    params = [np.zeros(N_PARAMS, np.float32)] * n
    albedo = [0] * n
    subs = [-1] * n

    def lobes_of(i, depth=0):
        spec = bsdf_specs[i]
        tname = spec.get("type", "lambert")
        if tname not in reg:
            raise NotImplementedError(f"bsdf type '{tname}' not implemented yet")
        tid, mod = reg[tname]
        if hasattr(mod, "lobes_for"):
            if depth > 1:
                raise NotImplementedError("bsdf nesting deeper than one level")
            return mod.lobes_for(spec, lambda j: lobes_of(j, depth + 1))
        return mod.LOBES

    for i, spec in enumerate(bsdf_specs):
        tname = spec.get("type", "lambert")
        if tname not in reg:
            raise NotImplementedError(f"bsdf type '{tname}' not implemented yet")
        tid, mod = reg[tname]
        if is_wrapper(mod):
            for key in ("_substrate_index", "_bsdf0_index", "_bsdf1_index"):
                j = spec.get(key, -1)
                if j >= 0 and is_wrapper(reg[bsdf_specs[j].get("type", "lambert")][1]):
                    raise NotImplementedError("nested wrapper bsdfs (coat-on-coat)")
        p = np.zeros(N_PARAMS, np.float32)
        p = mod.pack(spec, p, tex_builder)
        types[i] = tid
        lobes[i] = lobes_of(i)
        params[i] = p
        albedo[i] = _albedo_tex_for(spec, tex_builder)
        subs[i] = spec.get("_substrate_index", spec.get("_base_index", -1))

    if not types:
        types, lobes, params, albedo, subs = (
            [0], [0], [np.zeros(N_PARAMS, np.float32)], [0], [-1])
    gpack = np.concatenate(
        [np.stack(params),
         np.asarray(types, np.float32)[:, None],
         np.asarray(albedo, np.float32)[:, None]], axis=1,
    ).astype(np.float32)
    return MaterialTable(
        type=jnp.asarray(np.asarray(types, np.int32)),
        lobes=jnp.asarray(np.asarray(lobes, np.int32)),
        params=jnp.asarray(np.stack(params)),
        albedo_tex=jnp.asarray(np.asarray(albedo, np.int32)),
        gpack=jnp.asarray(gpack),
        sub_of=jnp.asarray(np.asarray(subs, np.int32)),
        hair_tables=jnp.asarray(np.stack(hair_tabs)) if hair_tabs else None,
        hair_cdf=jnp.asarray(np.stack(hair_cdfs)) if hair_cdfs else None,
        hair_sums=jnp.asarray(np.stack(hair_sums)) if hair_sums else None,
        present=tuple(sorted(set(types))),
    )


def _present(ctx, nested):
    mats, _ = ctx
    if not nested:
        return mats.present
    return tuple(t for t in mats.present if not is_wrapper(module_for_id(t)))


def _gather(ctx, mat_id, uv):
    from ..textures import eval_texture

    mats, texs = ctx
    if mats.gpack3 is not None:
        row = mats.gpack3[mat_id]  # ONE gather: self row + substrate row
        half = row.shape[-1] // 2

        def parse(r):
            params = r[..., :N_PARAMS]
            mtype = r[..., N_PARAMS].astype(jnp.int32)
            tex_id = r[..., N_PARAMS + 1].astype(jnp.int32)
            lobes = r[..., N_PARAMS + 2].astype(jnp.int32)
            hdr = r[..., N_PARAMS + 3:]
            albedo = eval_texture(
                texs, tex_id, uv, may=mats.albedo_kinds,
                pre=(hdr[..., :-1], hdr[..., -1].astype(jnp.int32)),
            )
            return params, mtype, albedo, lobes

        return parse(row[..., :half]) + (parse(row[..., half:]),)
    if mats.gpack2 is not None:
        row = mats.gpack2[mat_id]  # ONE gather: params+type+tex+lobes+header
        params = row[..., :N_PARAMS]
        mtype = row[..., N_PARAMS].astype(jnp.int32)
        tex_id = row[..., N_PARAMS + 1].astype(jnp.int32)
        lobes = row[..., N_PARAMS + 2].astype(jnp.int32)
        hdr = row[..., N_PARAMS + 3:]
        albedo = eval_texture(
            texs, tex_id, uv, may=mats.albedo_kinds,
            pre=(hdr[..., :-1], hdr[..., -1].astype(jnp.int32)),
        )
        return params, mtype, albedo, lobes
    if mats.gpack is not None:
        row = mats.gpack[mat_id]  # ONE gather for params + type + albedo id
        params = row[..., : row.shape[-1] - 2]
        mtype = row[..., -2].astype(jnp.int32)
        albedo = eval_texture(texs, row[..., -1].astype(jnp.int32), uv)
    else:
        params = mats.params[mat_id]
        mtype = mats.type[mat_id]
        albedo = eval_texture(texs, mats.albedo_tex[mat_id], uv)
    return params, mtype, albedo, mats.lobes[mat_id]


def bsdf_eval(ctx, mat_id, uv, wi, wo, nonspecular_only=False, nested=False,
              pre=None):
    if pre is None and nested and ctx[0].sub_pre is not None:
        pre = ctx[0].sub_pre  # substrate row pre-fetched by the wrapper's own gather
    params, mtype, albedo = (pre if pre is not None else _gather(ctx, mat_id, uv))[:3]
    out = jnp.zeros(wi.shape[:-1] + (3,), jnp.float32)
    for tid in _present(ctx, nested):
        f = module_for_id(tid).eval(ctx, params, albedo, uv, wi, wo, nonspecular_only)
        out = jnp.where((mtype == tid)[..., None], f, out)
    return out


def bsdf_pdf(ctx, mat_id, uv, wi, wo, nonspecular_only=False, nested=False,
             pre=None):
    if pre is None and nested and ctx[0].sub_pre is not None:
        pre = ctx[0].sub_pre  # substrate row pre-fetched by the wrapper's own gather
    params, mtype, albedo = (pre if pre is not None else _gather(ctx, mat_id, uv))[:3]
    out = jnp.zeros(wi.shape[:-1], jnp.float32)
    for tid in _present(ctx, nested):
        p = module_for_id(tid).pdf(ctx, params, albedo, uv, wi, wo, nonspecular_only)
        out = jnp.where(mtype == tid, p, out)
    return out


def bsdf_sample(ctx, mat_id, uv, wi, u2, u1, nonspecular_only=False,
                nested=False, pre=None) -> BsdfSample:
    if pre is None and nested and ctx[0].sub_pre is not None:
        pre = ctx[0].sub_pre  # substrate row pre-fetched by the wrapper's own gather
    params, mtype, albedo = (pre if pre is not None else _gather(ctx, mat_id, uv))[:3]
    res = BsdfSample.invalid(wi.shape[0])
    for tid in _present(ctx, nested):
        s = module_for_id(tid).sample(ctx, params, albedo, uv, wi, u2, u1, nonspecular_only)
        m = mtype == tid
        res = BsdfSample(
            wo=jnp.where(m[..., None], s.wo, res.wo),
            weight=jnp.where(m[..., None], s.weight, res.weight),
            pdf=jnp.where(m, s.pdf, res.pdf),
            lobe=jnp.where(m, s.lobe, res.lobe),
            valid=jnp.where(m, s.valid, res.valid),
        )
    return res


def bsdf_eta_sq(ctx, mat_id, uv, wi, wo):
    """sqr(Bsdf::eta(event)) — the non-adjoint radiance factor that eval/sample
    fold in (Bsdf.hpp:87). Adjoint transport divides it back out. Only
    dielectrics/rough dielectrics have eta != 1."""
    params, mtype = _gather(ctx, mat_id, uv)[:2]
    out = jnp.ones(wi.shape[:-1], jnp.float32)
    for tid in ctx[0].present:
        mod = module_for_id(tid)
        if hasattr(mod, "eta_sq"):
            out = jnp.where(mtype == tid, mod.eta_sq(params, wi, wo), out)
    return out
