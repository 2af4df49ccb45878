"""Scene flattening: SceneDocument -> device-resident FlatScene tables.

The wavefront analog of TraceableScene (src/core/renderer/TraceableScene.hpp:25-274):
pointer-based scene objects become index-based SoA tables — triangle soup with
per-triangle material/light ids, a flat skip-pointer BVH, a material parameter
table, a texture table, an area-light table with per-light triangle CDFs, and
an optional environment light with a 2D importance distribution
(InfiniteSphere.cpp:117-230 semantics).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax.numpy as jnp
from ..utils.pytree import dataclass as pytree, field

from ..accel.bvh import build_bvh_cached
from ..io.meshio import load_mesh, compute_smooth_normals
from ..math import transform as tf
from ..models.bsdfs import MaterialTable, pack_materials
from ..models.media import MediumTable, pack_media
from ..models.primitives import analytic, tessellate
from ..models.textures import TextureBuilder, TextureTable
from ..ops.intersect import TriangleSoA
from ..sampling.distributions import Distribution2D
from .load import SceneDocument

DEFAULT_EPSILON = 5e-4  # TraceableScene.hpp:39


@pytree
class CameraParams:
    rot: jnp.ndarray  # (3, 3) camera-to-world rotation (columns = x, y, z)
    pos: jnp.ndarray  # (3,)
    plane_dist: jnp.ndarray  # ()
    aperture_size: jnp.ndarray = None  # () thinlens
    focus_dist: jnp.ndarray = None  # () thinlens
    ap_angle: jnp.ndarray = None  # () blade-aperture rotation (radians)
    cateye: jnp.ndarray = None  # () cat-eye vignetting strength
    ap_dist: object = None  # Distribution2D over a bitmap aperture (or None)


@pytree
class LightTable:
    """Area lights: per-light triangle sets with area CDFs."""

    offset: jnp.ndarray  # (L,) start into tri_idx
    count: jnp.ndarray  # (L,)
    cdf_offset: jnp.ndarray  # (L,) start into cdf (count+1 entries per light)
    area: jnp.ndarray  # (L,) total area
    tex: jnp.ndarray  # (L,) emission texture id
    is_env: jnp.ndarray  # (L,) bool
    cone_cos: jnp.ndarray  # (L,) emission-cone cos (disk cone_angle; 0 = none)
    is_dirac: jnp.ndarray  # (L,) bool (point lights)
    tri_idx: jnp.ndarray  # (LT,) global triangle index (post BVH permutation)
    cdf: jnp.ndarray  # (LT + L,)
    ana_prim: jnp.ndarray = None  # (L,) analytic prim index, -1 = triangles
    pt_slot: jnp.ndarray = None  # (L,) PointLight row, -1 = not a point light
    env_slot: jnp.ndarray = None  # (L,) FlatScene.envs slot, -1 = not an env
    cap_slot: jnp.ndarray = None  # (L,) CapLight row, -1 = not a cap light
    # approximateRadiance geometry (TraceBase::chooseLight weighting):
    apx_avg: jnp.ndarray = None  # (L,) emission average().max() / const value
    apx_base: jnp.ndarray = None  # (L, 3) quad base / sphere+disk center / point pos
    apx_e0: jnp.ndarray = None  # (L, 3) quad edge0 / disk tangent*r / (r,0,0) sphere
    apx_e1: jnp.ndarray = None  # (L, 3) quad edge1 / disk bitangent*r
    apx_n: jnp.ndarray = None  # (L, 3) quad/disk plane normal
    apx_cbase: jnp.ndarray = None  # (L, 3) disk emission-cone base

    max_count: int = field(pytree_node=False, default=1)
    # per-light approximateRadiance kind ("none" = -1/uniform share):
    apx_kind: tuple = field(pytree_node=False, default=())
    # STATIC: any surface (area/analytic) light exists — gates the whole
    # hit-emitter block (e_hit texture eval, cone test, area direct pdf)
    # out of scenes lit only by infinite/point lights
    has_surface: bool = field(pytree_node=False, default=True)
    # STATIC: texture kinds reachable from surface-light emission textures
    # (the eval_texture `may` hint for e_hit / NEE radiance evals)
    emit_kinds: tuple = field(pytree_node=False, default=None)


@pytree
class EnvLight:
    rot: jnp.ndarray  # (3, 3)
    inv_rot: jnp.ndarray  # (3, 3)
    tex: jnp.ndarray  # () int32 emission texture
    dist: Distribution2D  # over the emission bitmap (sin-weighted, dilated)
    # STATIC texture kind of `tex` — the eval_texture `may` hint, so the env
    # radiance eval builds only the one dispatch branch it can ever take
    tex_kind: int = field(pytree_node=False, default=-1)


@pytree
class CapLight:
    """Directional spherical-cap lights (InfiniteSphereCap.cpp:233-249) —
    a TABLE of C caps (the reference's light list is unbounded,
    TraceableScene.hpp:79-102): cap axis = transform-rotated +Y, uniform
    radiance inside the cone. LightTable.cap_slot maps light index -> row."""

    dir: jnp.ndarray  # (C, 3)
    cos_angle: jnp.ndarray  # (C,)
    radiance: jnp.ndarray  # (C, 3)


@pytree
class PointLight:
    """Dirac point lights (Point.cpp): intensity = power/(4 pi). The
    reference's light list is unbounded (TraceableScene.hpp:79-102), so
    this is a TABLE of P points; LightTable.pt_slot maps light index ->
    row (-1 for non-point lights)."""

    pos: jnp.ndarray  # (P, 3)
    intensity: jnp.ndarray  # (P, 3)


def _default_point():
    return PointLight(pos=jnp.zeros((1, 3), jnp.float32),
                      intensity=jnp.zeros((1, 3), jnp.float32))


def _default_cap():
    return CapLight(
        dir=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        cos_angle=jnp.ones((1,), jnp.float32),
        radiance=jnp.zeros((1, 3), jnp.float32),
    )


@dataclass(frozen=True)
class SceneMeta:
    """Static (trace-time) scene facts."""

    res_x: int
    res_y: int
    camera_type: str
    tonemap: str
    filter: str
    fov_deg: float
    n_lights: int
    has_env: bool
    env_light_index: int  # index in light list, -1 if none
    env_is_constant: bool
    min_bounces: int
    max_bounces: int
    enable_light_sampling: bool
    enable_volume_light_sampling: bool
    low_order_scattering: bool
    include_surfaces: bool
    enable_two_sided: bool
    has_media: bool
    has_forward: bool
    camera_medium: int
    spp: int
    spp_step: int
    use_bvh: bool
    aovs: tuple = ()  # ((type, ldr_file, hdr_file), ...) from renderer output_buffers
    stratified: bool = False  # renderer "stratified_sampler" -> sobol mode
    has_cap: bool = False
    cap_light_index: int = -1  # index in light list, -1 if unsamplable/absent
    cap_after_env: bool = False  # some cap listed after the last env/skydome
    # multiple infinite lights (the reference's light list is unbounded,
    # TraceableScene.hpp:79-102; the LAST listed infinite that intersects a
    # direction wins the escape, TraceableScene.hpp:194-209):
    n_envs: int = 0  # env primitives (infinite_sphere/skydome) in prim order
    env_const: tuple = ()  # per env slot: constant-emission flag
    env_light_idx: tuple = ()  # per env slot: light index, -1 = unsamplable
    n_caps: int = 0
    cap_light_idx: tuple = ()  # per cap slot: light index, -1 = unsamplable
    esc_caps: tuple = ()  # cap slots that can win the escape (listed after
    # the last env primitive), ascending primitive order
    point_light_index: int = -1  # dirac point light, -1 if absent
    # thinlens aperture (ThinlensCamera.cpp:55-100): the lens point is
    # sampled THROUGH a texture (disk default; blade/bitmap bokeh), with
    # optional cat-eye diaphragm vignetting
    aperture_kind: str = "disk"  # disk | blade | bitmap | const
    ap_blades: int = 6
    cateye: float = 0.0
    has_fiber_tan: bool = False  # curve prims present -> tri_tan populated
    has_analytic: bool = False  # analytic sphere/disk/cylinder prims present
    # BDPT subpath vertex cap: the reference allocates maxBounces+1 vertices
    # per subpath (BidirectionalPathTracer.cpp:14-15); we cap the static
    # (s,t) family unroll. Memory/compile curve per doubling of the cap:
    # vertex SoA bytes scale ~K (N*K*~40 f32), connection batches ~K^2/2
    # (each a full wavefront visibility walk) — K=16 is ~134 batches vs
    # K=8's ~40. Override with integrator "bdpt_max_vertices".
    bdpt_max_vertices: int = 16


@pytree
class FlatScene:
    tris: TriangleSoA
    tri_ng: jnp.ndarray  # (T, 3) geometric normal (winding)
    tri_n0: jnp.ndarray  # (T, 3) shading normals at the 3 verts
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray  # (T, 2)
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    tri_mat: jnp.ndarray  # (T,) int32
    tri_light: jnp.ndarray  # (T,) int32 (-1 = not emissive)
    tri_med_int: jnp.ndarray  # (T,) int32 interior medium (-1 = vacuum)
    tri_med_ext: jnp.ndarray  # (T,) int32 exterior medium
    tri_med_override: jnp.ndarray  # (T,) bool (Primitive::overridesMedia)
    tri_tan: jnp.ndarray  # (T, 3) fiber tangent for curve tris ((1,3) zeros
    # when the scene has no curves — gated by meta.has_fiber_tan)
    # (T, 20) packed shading row [ng | n0 n1 n2 | uv0 uv1 uv2 | mat | light]
    # so hit shading is ONE gather (gathers are latency-bound per op)
    shade_pack: jnp.ndarray
    bounds: jnp.ndarray  # (2, 3) [min; max] over all triangles
    gbvh: "GatherBvhPack | None"  # gen-5 per-lane gather traversal (default)
    ana: "analytic.AnalyticTable | None"  # analytic sphere/disk/cylinder prims
    materials: MaterialTable
    media: MediumTable
    textures: TextureTable
    lights: LightTable
    env: EnvLight
    cap: CapLight
    point: PointLight
    camera: CameraParams
    meta: SceneMeta = field(pytree_node=False, default=None)
    # ALL env lights in primitive order (env = envs[-1], the escape winner);
    # earlier envs are NEE-sampled via LightTable.env_slot but can never be
    # seen by an escaping ray (the last env masks them everywhere)
    envs: tuple = ()



# default ceiling for the BDPT/MLT subpath vertex cap when the scene does
# not set "bdpt_max_vertices": K=16 is ~134 unrolled connection families
# (each a full wavefront visibility walk); the (s,t) unroll scales ~K^2/2
# in both compile time and per-sample cost, so tracking max_bounces=128
# scenes exactly (K=129 -> ~8.3k families) is not a sane default.
_BDPT_DEFAULT_CEIL = 16


def _bdpt_cap(integ) -> int:
    """BDPT/MLT subpath vertex cap.

    The reference allocates maxBounces+1 vertices per subpath
    (BidirectionalPathTracer.cpp:14-15) — transport is never truncated.
    Here the static (s, t) family unroll makes the cap a real compile/memory
    knob, so: track max_bounces+1 exactly up to _BDPT_DEFAULT_CEIL, let the
    scene raise it explicitly via integrator "bdpt_max_vertices", and WARN
    LOUDLY when a deep scene is being truncated instead of doing it
    silently (round-3 verdict weak #3)."""
    import warnings

    want = int(integ.get("max_bounces", 64)) + 1
    explicit = integ.get("bdpt_max_vertices")
    if explicit is not None:
        return int(explicit)
    cap = min(want, _BDPT_DEFAULT_CEIL)
    if want > cap and integ.get("type") in (
            "bidirectional_path_tracer", "kelemen_mlt", "multiplexed_mlt",
            "reversible_jump_mlt"):
        warnings.warn(
            f"BDPT subpath vertices capped at {cap} (< max_bounces+1 = "
            f"{want}): transport beyond {cap - 1} bounces is truncated. "
            "Set integrator 'bdpt_max_vertices' to raise the cap "
            "(compile/sample cost grows ~K^2/2).", stacklevel=2)
    return cap


def flatten_scene(doc: SceneDocument) -> FlatScene:
    import os as _os

    tex_builder = TextureBuilder()
    # analytic sphere/disk/cylinder intersectors are the default (exact
    # silhouettes + spherical-cap light sampling, Sphere.cpp:97-191);
    # TUNGSTEN_TESSELLATE=1 reverts to the round-1..3 tessellated meshes
    use_analytic = _os.environ.get("TUNGSTEN_TESSELLATE", "") != "1"

    # ---- geometry ---------------------------------------------------------
    pos_l, n_l, uv_l, idx_l, mat_l, prim_l = [], [], [], [], [], []
    tan_l = []  # per-prim fiber tangents (curves) or None
    med_int_l, med_ext_l, med_ov_l = [], [], []
    emissive_prims = []  # (prim_index, emission_spec)
    ana_entries = []  # analytic prim dicts (+ per-entry mat/media/prim id)
    ana_prim_of = {}  # scene prim index -> analytic index
    prim_apx = {}  # scene prim index -> approximateRadiance geometry
    extra_prims = {}  # pseudo prim index -> synthetic spec (minecraft blocks)
    env_specs = []  # (prim, m, pi, is_sky) in primitive order
    cap_specs = []  # (prim, m, pi) in primitive order
    point_specs = []
    prim_cone_cos = {}
    vert_base = 0

    for pi, prim in enumerate(doc.primitives):
        ptype = prim.get("type", "mesh")
        m = tf.mat4_from_json(prim.get("transform"))

        if ptype == "infinite_sphere":
            if "emission" in prim or "power" in prim:
                env_specs.append((prim, m, pi, False))
            continue
        if ptype == "skydome":
            env_specs.append((prim, m, pi, True))
            continue
        if ptype == "point":
            point_specs.append((prim, m))
            continue
        if ptype == "infinite_sphere_cap":
            cap_specs.append((prim, m, pi))
            continue

        if ("emission" in prim or "power" in prim) and ptype in (
                "quad", "sphere", "disk"):
            # approximateRadiance geometry for radiance-weighted chooseLight
            # (TraceBase.cpp:416-459; Quad.cpp:256-281, Sphere.cpp:266-271,
            # Disk.cpp:268-295). Other prim types return -1 (uniform share),
            # exactly like the reference's TriangleMesh/Curves/Cylinder.
            r3 = m[:3, :3]
            if ptype == "quad":
                e0 = r3 @ np.array([1.0, 0.0, 0.0])
                e1 = r3 @ np.array([0.0, 0.0, 1.0])
                base = m[:3, 3] - 0.5 * e0 - 0.5 * e1
                nq = np.cross(e1, e0)
                nq = nq / max(np.linalg.norm(nq), 1e-30)
                prim_apx[pi] = dict(kind="quad", base=base, e0=e0, e1=e1,
                                    n=nq, cbase=np.zeros(3))
            elif ptype == "sphere":
                scale = np.linalg.norm(r3, axis=0)
                prim_apx[pi] = dict(
                    kind="sphere", base=m[:3, 3],
                    e0=np.array([float(scale.max()), 0.0, 0.0]),
                    e1=np.zeros(3), n=np.zeros(3), cbase=np.zeros(3))
            else:  # disk
                scale = np.linalg.norm(r3, axis=0)
                r = float(max(scale[0], scale[2]))
                nd = r3 @ np.array([0.0, 1.0, 0.0])
                nd = nd / max(np.linalg.norm(nd), 1e-30)
                ca = np.deg2rad(float(prim.get("cone_angle", 90.0)))
                td, bd = analytic._tangent_frame(nd)
                prim_apx[pi] = dict(
                    kind="disk", base=m[:3, 3], e0=td * r, e1=bd * r, n=nd,
                    cbase=m[:3, 3] - nd / max(np.sin(ca), 1e-9))

        if ptype == "minecraft_map":
            # staged mc-loader (TraceableMinecraftMap.cpp): exact NBT/Anvil
            # world decode, exposed faces as quads; with "resource_packs"
            # the stage-2 model resolver (mc_resources.py analog of
            # ResourcePackLoader.cpp) assigns REAL per-face textures + uv
            # and emitters.json emission; without packs the stage-1
            # built-in palette applies
            from ..models.primitives import minecraft as mc

            packs = prim.get("resource_packs", [])
            if isinstance(packs, str):
                packs = [packs]
            pos, indices, fids, pk, fax, fsg, quv = mc.load_minecraft_map(
                doc.resolve_path(prim["map_path"]), with_faces=True)
            if packs:
                from ..models.primitives.mc_resources import (
                    ResourcePack, block_materials_pack)

                rp = ResourcePack([doc.resolve_path(p) for p in packs])
                specs, mat_of_face, emis = block_materials_pack(
                    pk, fax, fsg, rp, tex_builder)
            else:
                specs, mat_of_face, emis = mc.block_materials(fids)
            base_bsdf = len(doc.bsdfs)
            doc.bsdfs.extend(specs)
            wpos = tf.transform_point(m, pos).astype(np.float32)
            for j, (spec, e) in enumerate(zip(specs, emis)):
                sel = mat_of_face == j
                if not np.any(sel):
                    continue
                sub_idx = indices[sel]
                # compact the vertex set per block type
                used, inv = np.unique(sub_idx, return_inverse=True)
                pos_l.append(wpos[used])
                n_l.append(None)
                tan_l.append(None)
                uv_l.append(quv[used])
                idx_l.append(inv.reshape(-1, 3).astype(np.int32) + vert_base)
                nt = len(sub_idx)
                mat_l.append(np.full(nt, base_bsdf + j, np.int32))
                pseudo_pi = 1_000_000 + len(extra_prims)
                prim_l.append(np.full(nt, pseudo_pi, np.int32))
                med_int_l.append(np.full(nt, -1, np.int32))
                med_ext_l.append(np.full(nt, -1, np.int32))
                med_ov_l.append(np.zeros(nt, bool))
                vert_base += len(used)
                if e is not None:
                    extra_prims[pseudo_pi] = {"emission": e}
                    emissive_prims.append(pseudo_pi)
                else:
                    extra_prims[pseudo_pi] = {}
            continue

        if use_analytic and ptype in ("sphere", "disk", "cylinder"):
            if ptype == "disk":
                ca = float(prim.get("cone_angle", 90.0))
                if ca < 90.0:
                    prim_cone_cos[pi] = float(np.cos(np.deg2rad(ca)))
            entry = analytic.extract_params(ptype, m, prim)
            entry["_mat"] = prim["_bsdf_index"]
            entry["_med_int"] = prim.get("_int_medium", -1)
            entry["_med_ext"] = prim.get("_ext_medium", -1)
            entry["_pi"] = pi
            ana_prim_of[pi] = len(ana_entries)
            ana_entries.append(entry)
            if "emission" in prim or "power" in prim:
                emissive_prims.append(pi)
            continue

        if ptype == "quad":
            soup = tessellate.quad()
        elif ptype == "disk":
            soup = tessellate.disk()
            ca = float(prim.get("cone_angle", 90.0))
            if ca < 90.0:
                prim_cone_cos[pi] = float(np.cos(np.deg2rad(ca)))
        elif ptype == "cylinder":
            soup = tessellate.cylinder(capped=bool(prim.get("capped", True)))
        elif ptype == "curves":
            from ..io.curveio import load_curves

            ends, cnodes = load_curves(doc.resolve_path(prim["file"]))
            cw = prim.get("curve_thickness")
            if cw is not None:
                cnodes = cnodes.copy()
                cnodes[:, 3] = float(cw)
            soup = tessellate.curve_tubes(
                ends, cnodes,
                taper=bool(prim.get("curve_taper", False)),
                subsample=float(prim.get("subsample", 1.0)),
            )
        elif ptype == "cube":
            soup = tessellate.cube()
        elif ptype == "sphere":
            soup = tessellate.sphere_mesh()
        elif ptype == "mesh":
            mesh = load_mesh(doc.resolve_path(prim["file"]))
            smooth = prim.get("smooth", True)
            if prim.get("recompute_normals", False) or (
                smooth and not np.any(mesh.normal)
            ):
                compute_smooth_normals(mesh)
            soup = tessellate.TriSoup(
                pos=mesh.pos,
                normal=mesh.normal if smooth else None,
                uv=mesh.uv,
                indices=mesh.indices,
            )
        else:
            raise NotImplementedError(f"primitive type '{ptype}' not implemented yet")

        wpos = tf.transform_point(m, soup.pos).astype(np.float32)
        if soup.normal is not None:
            wn = tf.transform_normal(m, soup.normal)
            lens = np.linalg.norm(wn, axis=-1, keepdims=True)
            wn = np.where(lens > 1e-20, wn / np.maximum(lens, 1e-20), 0.0).astype(np.float32)
        else:
            wn = None

        pos_l.append(wpos)
        n_l.append(wn)
        if getattr(soup, "tangent", None) is not None:
            wt = tf.transform_vector(m, soup.tangent)
            lt = np.linalg.norm(wt, axis=-1, keepdims=True)
            tan_l.append((wt / np.maximum(lt, 1e-20)).astype(np.float32))
        else:
            tan_l.append(None)
        uv_l.append(soup.uv.astype(np.float32))
        idx_l.append(soup.indices + vert_base)
        mat_l.append(np.full(len(soup.indices), prim["_bsdf_index"], np.int32))
        prim_l.append(np.full(len(soup.indices), pi, np.int32))
        nt = len(soup.indices)
        med_int_l.append(np.full(nt, prim.get("_int_medium", -1), np.int32))
        med_ext_l.append(np.full(nt, prim.get("_ext_medium", -1), np.int32))
        med_ov_l.append(np.full(nt, prim.get("_int_medium", -1) >= 0 or prim.get("_ext_medium", -1) >= 0, bool))
        vert_base += len(wpos)

        if "emission" in prim or "power" in prim:
            emissive_prims.append(pi)

    if not idx_l:
        if not ana_entries:
            raise ValueError("scene has no finite geometry")
        # all-analytic scene: one degenerate far-away triangle keeps the
        # triangle tables/BVH machinery well-formed (never hit)
        pos_l.append(np.full((3, 3), 2.0e37, np.float32))
        n_l.append(None)
        tan_l.append(None)
        uv_l.append(np.zeros((3, 2), np.float32))
        idx_l.append(np.arange(3, dtype=np.int32)[None, :])
        mat_l.append(np.zeros(1, np.int32))
        prim_l.append(np.full(1, -1, np.int32))
        med_int_l.append(np.full(1, -1, np.int32))
        med_ext_l.append(np.full(1, -1, np.int32))
        med_ov_l.append(np.zeros(1, bool))

    # assemble vertex/triangle arrays (normals: fill flat prims after)
    all_pos = np.concatenate(pos_l)
    all_uv = np.concatenate(uv_l)
    indices = np.concatenate(idx_l)
    tri_mat = np.concatenate(mat_l)
    tri_prim = np.concatenate(prim_l)
    tri_med_int = np.concatenate(med_int_l)
    tri_med_ext = np.concatenate(med_ext_l)
    tri_med_ov = np.concatenate(med_ov_l)

    p0 = all_pos[indices[:, 0]]
    p1 = all_pos[indices[:, 1]]
    p2 = all_pos[indices[:, 2]]
    face_n = np.cross(p1 - p0, p2 - p0)
    face_area = 0.5 * np.linalg.norm(face_n, axis=-1)
    norm = np.linalg.norm(face_n, axis=-1, keepdims=True)
    tri_ng = (face_n / np.maximum(norm, 1e-30)).astype(np.float32)

    # shading normals: vertex normals where present, face normal otherwise
    all_n = np.zeros_like(all_pos)
    all_tan = np.zeros_like(all_pos)
    has_fiber_tan = any(wt is not None for wt in tan_l)
    off = 0
    for wpos, wn, wt in zip(pos_l, n_l, tan_l):
        if wn is not None:
            all_n[off : off + len(wpos)] = wn
        if wt is not None:
            all_tan[off : off + len(wpos)] = wt
        off += len(wpos)
    tri_tan = all_tan[indices[:, 0]]  # fiber tangent, constant per tri
    n0 = all_n[indices[:, 0]]
    n1 = all_n[indices[:, 1]]
    n2 = all_n[indices[:, 2]]
    missing = (np.linalg.norm(n0, axis=-1) < 0.5)[:, None]
    n0 = np.where(missing, tri_ng, n0)
    n1 = np.where(missing, tri_ng, n1)
    n2 = np.where(missing, tri_ng, n2)

    # ---- BVH + permutation ------------------------------------------------
    bb_min = np.minimum(np.minimum(p0, p1), p2)
    bb_max = np.maximum(np.maximum(p0, p1), p2)
    bvh = build_bvh_cached(bb_min, bb_max)
    perm = bvh.prim_order
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(len(perm), dtype=np.int32)

    def permute(a):
        return np.ascontiguousarray(a[perm])

    p0, p1, p2 = permute(p0), permute(p1), permute(p2)
    tri_ng = permute(tri_ng)
    n0, n1, n2 = permute(n0), permute(n1), permute(n2)
    uv0 = permute(all_uv[indices[:, 0]])
    uv1 = permute(all_uv[indices[:, 1]])
    uv2 = permute(all_uv[indices[:, 2]])
    tri_mat = permute(tri_mat)
    tri_prim = permute(tri_prim)
    face_area = permute(face_area)
    tri_med_int = permute(tri_med_int)
    tri_med_ext = permute(tri_med_ext)
    tri_med_ov = permute(tri_med_ov)
    tri_tan = permute(tri_tan) if has_fiber_tan else np.zeros((1, 3), np.float32)

    # ---- materials, media & textures ---------------------------------------
    materials = pack_materials(doc.bsdfs, tex_builder)
    def _prim_origin(name):
        """Transform origin of the named primitive (atmosphere 'pivot',
        AtmosphericMedium.cpp:63-70); None when absent (reference DBGs)."""
        for p in doc.primitives:
            if p.get("name") == name:
                return tf.mat4_from_json(p.get("transform"))[:3, 3]
        return None

    media = pack_media(doc.media, resolve=doc.resolve_path,
                       prim_origin=_prim_origin)

    # ---- lights ------------------------------------------------------------
    tri_light = np.full(len(tri_mat), -1, np.int32)
    l_offset, l_count, l_cdf_off, l_area, l_tex, l_env = [], [], [], [], [], []
    l_cone, l_dirac, l_ana = [], [], []
    l_pt = []  # PointLight row per light, -1 for non-point
    l_envslot = []  # envs slot per light, -1 for non-env
    l_capslot = []  # CapLight row per light, -1 for non-cap
    l_apx = []  # (kind, avg, base, e0, e1, n, cbase) per light row
    tri_idx_list, cdf_list = [], []
    cur_off = 0
    cur_cdf = 0

    _Z3 = np.zeros(3)

    def apx_row(pi, tex_id):
        """approximateRadiance row for an area light: geometry captured in
        the primitive loop + the emission texture's average().max()."""
        info = prim_apx.get(pi)
        if info is None:
            l_apx.append(("none", 0.0, _Z3, _Z3, _Z3, _Z3, _Z3))
            return
        avg = float(np.max(tex_builder.average(tex_id)))
        l_apx.append((info["kind"], avg, info["base"], info["e0"],
                      info["e1"], info["n"], info["cbase"]))

    def emission_tex(prim, area=None):
        if "power" in prim:
            # emission = power * powerToRadianceFactor (Primitive.cpp:111-116);
            # area lights: 1/(pi * area)
            p = np.asarray(prim["power"], np.float64)
            if p.ndim == 0:
                p = np.repeat(p, 3)
            return tex_builder.add_constant((p / (np.pi * area)).astype(np.float32))
        from ..models.textures import texture_from_spec

        return texture_from_spec(prim["emission"], tex_builder, doc.resolve_path)

    for pi in emissive_prims:
        prim = extra_prims[pi] if pi in extra_prims else doc.primitives[pi]
        if pi in ana_prim_of:
            # analytic emitter: no triangle set; sampling dispatches on
            # ana_prim (spherical cap / uniform disk / uniform cylinder)
            k = ana_prim_of[pi]
            total = float(ana_entries[k]["area"])
            light_id = len(l_offset)
            ana_entries[k]["_light"] = light_id
            l_offset.append(cur_off)
            l_count.append(0)
            l_cdf_off.append(cur_cdf)
            l_area.append(total)
            l_tex.append(emission_tex(prim, total))
            l_env.append(False)
            l_cone.append(prim_cone_cos.get(pi, 0.0))
            l_dirac.append(False)
            l_ana.append(k)
            l_pt.append(-1)
            l_envslot.append(-1)
            l_capslot.append(-1)
            apx_row(pi, l_tex[-1])
            continue
        sel = np.nonzero(tri_prim == pi)[0].astype(np.int32)
        if len(sel) == 0:
            continue
        areas = face_area[sel]
        total = float(areas.sum())
        if total <= 0:
            continue
        light_id = len(l_offset)
        tri_light[sel] = light_id
        cdf = np.concatenate([[0.0], np.cumsum(areas / total)]).astype(np.float32)
        cdf[-1] = 1.0
        l_offset.append(cur_off)
        l_count.append(len(sel))
        l_cdf_off.append(cur_cdf)
        l_area.append(total)
        l_tex.append(emission_tex(prim, total))
        l_env.append(False)
        l_cone.append(prim_cone_cos.get(pi, 0.0))
        l_dirac.append(False)
        l_ana.append(-1)
        l_pt.append(-1)
        l_envslot.append(-1)
        l_capslot.append(-1)
        apx_row(pi, l_tex[-1])
        tri_idx_list.append(sel)
        cdf_list.append(cdf)
        cur_off += len(sel)
        cur_cdf += len(sel) + 1

    # environment lights (infinite_sphere, or a skydome baked to a bitmap the
    # way the reference does at prepareForRender — Skydome.cpp:292-318). The
    # list is unbounded; the LAST one is the escape winner (it masks every
    # earlier env for all directions, TraceableScene.hpp:194-209), earlier
    # ones remain individually NEE-samplable via their light rows.
    env_index = -1
    env_is_constant = True
    env_prim_index = -1
    env = _default_env(tex_builder)
    envs = []
    env_const_l, env_light_idx = [], []
    for slot, (prim, m, env_pi, is_sky) in enumerate(env_specs):
        rot = m[:3, :3].astype(np.float64)
        # extractRotation: normalize columns
        rot = rot / np.maximum(np.linalg.norm(rot, axis=0, keepdims=True), 1e-30)
        samplable = prim.get("sample", True)
        if is_sky:
            from ..models.primitives.sky import bake_skydome

            sun = rot @ np.array([0.0, 1.0, 0.0])
            img = bake_skydome(
                sun,
                turbidity=float(prim.get("turbidity", 3.0)),
                intensity=float(prim.get("intensity", 2.0)),
                temperature=float(prim.get("temperature", 5777.0)),
                gamma_scale=float(prim.get("gamma_scale", 1.0)),
            )
            etex = tex_builder.add_bitmap(img, path_key=f"__skydome_{env_pi}")
            # the skydome's uv mapping ignores the prim transform (the sun
            # direction carries the orientation) — Skydome.cpp:37-41
            rot = np.eye(3)
            is_const = False
            dist = Distribution2D.build(_env_weights(img))
        else:
            etex = emission_tex(prim, 1.0)
            e = prim.get("emission")
            is_const = not isinstance(e, str)
            if is_const:
                dist = Distribution2D.build(np.ones((1, 1), np.float32))
            else:
                img = tex_builder.image(etex)
                dist = Distribution2D.build(_env_weights(img))
        envs.append(EnvLight(
            rot=jnp.asarray(rot, jnp.float32),
            inv_rot=jnp.asarray(rot.T, jnp.float32),
            tex=jnp.int32(etex),
            dist=dist,
            tex_kind=tex_builder.types[etex],
        ))
        env_const_l.append(is_const)
        if samplable:
            env_light_idx.append(len(l_offset))
            l_offset.append(cur_off)
            l_count.append(0)
            l_cdf_off.append(cur_cdf)
            l_area.append(1.0)
            l_tex.append(etex)
            l_env.append(True)
            l_cone.append(0.0)
            l_dirac.append(False)
            l_ana.append(-1)
            l_pt.append(-1)
            l_envslot.append(slot)
            l_capslot.append(-1)
            # InfiniteSphere::approximateRadiance = 2 pi * avg max
            l_apx.append(("const",
                          float(2.0 * np.pi * np.max(tex_builder.average(etex))),
                          _Z3, _Z3, _Z3, _Z3, _Z3))
        else:
            env_light_idx.append(-1)
    if envs:
        env = envs[-1]
        env_is_constant = env_const_l[-1]
        env_index = env_light_idx[-1]
        env_prim_index = env_specs[-1][2]

    # spherical-cap lights (sun) — also a table; a cap can win the escape
    # only if it is listed after the last env primitive
    cap_index = -1
    cap_prim_index = -1
    cap = _default_cap()
    cap_dirs, cap_coss, cap_rads = [], [], []
    cap_light_idx, esc_caps = [], []
    for slot, (prim, m, cap_pi) in enumerate(cap_specs):
        rot = m[:3, :3].astype(np.float64)
        rot = rot / np.maximum(np.linalg.norm(rot, axis=0, keepdims=True), 1e-30)
        cap_dir = rot @ np.array([0.0, 1.0, 0.0])
        cap_dir = cap_dir / max(np.linalg.norm(cap_dir), 1e-30)
        cap_angle = np.deg2rad(float(prim.get("cap_angle", 10.0)))
        cos_cap = float(np.cos(cap_angle))
        if "power" in prim:
            # power * powerToRadianceFactor = power/(2pi (1-cos))
            pw = np.asarray(prim["power"], np.float64)
            if pw.ndim == 0:
                pw = np.repeat(pw, 3)
            rad = pw / (2.0 * np.pi * max(1.0 - cos_cap, 1e-9))
        else:
            rad = np.asarray(prim.get("emission", 1.0), np.float64)
            if rad.ndim == 0:
                rad = np.repeat(rad, 3)
        cap_dirs.append(cap_dir)
        cap_coss.append(cos_cap)
        cap_rads.append(rad)
        if prim.get("sample", True):
            li_c = len(l_offset)
            cap_light_idx.append(li_c)
            if cap_index < 0:
                cap_index = li_c
            l_offset.append(cur_off)
            l_count.append(0)
            l_cdf_off.append(cur_cdf)
            l_area.append(1.0)
            l_tex.append(0)
            l_env.append(False)
            l_cone.append(0.0)
            l_dirac.append(False)
            l_ana.append(-1)
            l_pt.append(-1)
            l_envslot.append(-1)
            l_capslot.append(slot)
            # InfiniteSphereCap::approximateRadiance = 2 pi (1-cos) avg max
            l_apx.append(("const",
                          float(2.0 * np.pi * (1.0 - cos_cap) * np.max(rad)),
                          _Z3, _Z3, _Z3, _Z3, _Z3))
        else:
            cap_light_idx.append(-1)
        if cap_pi > env_prim_index:
            esc_caps.append(slot)
        cap_prim_index = max(cap_prim_index, cap_pi)
    if cap_specs:
        cap = CapLight(
            dir=jnp.asarray(np.asarray(cap_dirs), jnp.float32),
            cos_angle=jnp.asarray(np.asarray(cap_coss), jnp.float32),
            radiance=jnp.asarray(np.asarray(cap_rads), jnp.float32),
        )

    # dirac point lights — one light entry + one PointLight row each
    # (the reference's light list is unbounded, TraceableScene.hpp:79-102)
    point_index = -1
    point = _default_point()
    if point_specs:
        pt_pos, pt_int = [], []
        for prim, m in point_specs:
            ppos = (m @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
            pw = np.asarray(
                prim.get("power", prim.get("emission", 1.0)), np.float64)
            if pw.ndim == 0:
                pw = np.repeat(pw, 3)
            if point_index < 0:
                point_index = len(l_offset)
            l_pt.append(len(pt_pos))
            pt_pos.append(ppos)
            pt_int.append(pw / (4.0 * np.pi))
            l_offset.append(cur_off)
            l_count.append(0)
            l_cdf_off.append(cur_cdf)
            l_area.append(1.0)
            l_tex.append(0)
            l_env.append(False)
            l_cone.append(0.0)
            l_dirac.append(True)
            l_ana.append(-1)
            l_envslot.append(-1)
            l_capslot.append(-1)
            # Point::approximateRadiance = intensity.max / r^2
            l_apx.append(("point", float(np.max(pw / (4.0 * np.pi))),
                          ppos, _Z3, _Z3, _Z3, _Z3))
        point = PointLight(
            pos=jnp.asarray(np.asarray(pt_pos), jnp.float32),
            intensity=jnp.asarray(np.asarray(pt_int), jnp.float32),
        )

    n_lights = len(l_offset)
    if not tri_idx_list:
        tri_idx_list = [np.zeros(1, np.int32)]
        cdf_list = [np.array([0.0, 1.0], np.float32)]
    lights = LightTable(
        offset=jnp.asarray(np.asarray(l_offset or [0], np.int32)),
        count=jnp.asarray(np.asarray(l_count or [0], np.int32)),
        cdf_offset=jnp.asarray(np.asarray(l_cdf_off or [0], np.int32)),
        area=jnp.asarray(np.asarray(l_area or [1.0], np.float32)),
        tex=jnp.asarray(np.asarray(l_tex or [0], np.int32)),
        is_env=jnp.asarray(np.asarray(l_env or [False], bool)),
        cone_cos=jnp.asarray(np.asarray(l_cone or [0.0], np.float32)),
        is_dirac=jnp.asarray(np.asarray(l_dirac or [False], bool)),
        tri_idx=jnp.asarray(np.concatenate(tri_idx_list)),
        cdf=jnp.asarray(np.concatenate(cdf_list)),
        ana_prim=jnp.asarray(np.asarray(l_ana or [-1], np.int32)),
        pt_slot=jnp.asarray(np.asarray(l_pt or [-1], np.int32)),
        env_slot=jnp.asarray(np.asarray(l_envslot or [-1], np.int32)),
        cap_slot=jnp.asarray(np.asarray(l_capslot or [-1], np.int32)),
        apx_avg=jnp.asarray(np.asarray(
            [a[1] for a in l_apx] or [0.0], np.float32)),
        apx_base=jnp.asarray(np.asarray(
            [a[2] for a in l_apx] or [_Z3], np.float32)),
        apx_e0=jnp.asarray(np.asarray(
            [a[3] for a in l_apx] or [_Z3], np.float32)),
        apx_e1=jnp.asarray(np.asarray(
            [a[4] for a in l_apx] or [_Z3], np.float32)),
        apx_n=jnp.asarray(np.asarray(
            [a[5] for a in l_apx] or [_Z3], np.float32)),
        apx_cbase=jnp.asarray(np.asarray(
            [a[6] for a in l_apx] or [_Z3], np.float32)),
        apx_kind=tuple(a[0] for a in l_apx),
        max_count=max([c for c in (l_count or [1])] + [1]),
        has_surface=any(
            es < 0 and cs < 0 and ps < 0
            for es, cs, ps in zip(
                l_envslot or [], l_capslot or [], l_pt or [])),
        emit_kinds=tex_builder.kinds_of([
            t for t, es, cs, ps in zip(
                l_tex or [], l_envslot or [], l_capslot or [], l_pt or [])
            if es < 0 and cs < 0 and ps < 0]),
    )

    # ---- analytic prim table + virtual-id rows -----------------------------
    # analytic prims occupy virtual triangle ids [T, T+A): every per-triangle
    # attribute table grows by A rows so existing gathers work unchanged;
    # position-dependent rows (ng/ns/uv) are zeros and overridden at the
    # shading-data merge (models/primitives/analytic.py docstring)
    ana_table = analytic.build_table(ana_entries)
    if ana_entries:
        A = len(ana_entries)
        tri_mat = np.concatenate(
            [tri_mat, np.array([e["_mat"] for e in ana_entries], np.int32)])
        tri_light = np.concatenate(
            [tri_light,
             np.array([e.get("_light", -1) for e in ana_entries], np.int32)])
        a_mi = np.array([e["_med_int"] for e in ana_entries], np.int32)
        a_me = np.array([e["_med_ext"] for e in ana_entries], np.int32)
        tri_med_int = np.concatenate([tri_med_int, a_mi])
        tri_med_ext = np.concatenate([tri_med_ext, a_me])
        tri_med_ov = np.concatenate([tri_med_ov, (a_mi >= 0) | (a_me >= 0)])
        z3 = np.zeros((A, 3), np.float32)
        z2 = np.zeros((A, 2), np.float32)
        tri_ng = np.concatenate([tri_ng, z3])
        n0, n1, n2 = (np.concatenate([x, z3]) for x in (n0, n1, n2))
        uv0, uv1, uv2 = (np.concatenate([x, z2]) for x in (uv0, uv1, uv2))
        if has_fiber_tan:
            tri_tan = np.concatenate([tri_tan, z3])

    # ---- camera ------------------------------------------------------------
    cam = doc.camera
    cam_m = tf.mat4_from_json(cam.get("transform"))
    # cameras negate their x axis after loading (Camera.cpp:63
    # `_transform.setRight(-_transform.right())`) so +x_local maps to
    # image-right in world space
    cam_m[:3, 0] = -cam_m[:3, 0]
    fov = float(cam.get("fov", 60.0))
    plane_dist = 1.0 / np.tan(np.deg2rad(fov) * 0.5)

    # thinlens extras (ThinlensCamera.cpp:55-100): aperture texture,
    # cat-eye vignetting, focus pivot (focus distance from a named
    # primitive's transform origin, ThinlensCamera.cpp:206-217)
    focus_dist = float(cam.get("focus_distance", 1.0))
    pivot = cam.get("focus_pivot")
    if pivot:
        cam_pos_np = cam_m[:3, 3]
        for p in doc.primitives:
            if p.get("name") == pivot:
                pm = tf.mat4_from_json(p.get("transform"))
                focus_dist = float(np.linalg.norm(pm[:3, 3] - cam_pos_np))
                break
    ap_spec = cam.get("aperture")
    aperture_kind, ap_blades, ap_angle, ap_dist = "disk", 6, 0.593412, None
    if isinstance(ap_spec, str):
        from ..io.imageio import load_image

        img = np.asarray(load_image(doc.resolve_path(ap_spec)), np.float32)
        lum = img.mean(-1) if img.ndim == 3 else img
        ap_dist = Distribution2D.build(np.maximum(lum, 0.0))
        aperture_kind = "bitmap"
    elif isinstance(ap_spec, dict):
        t = ap_spec.get("type", "disk")
        if t == "blade":
            aperture_kind = "blade"
            ap_blades = int(ap_spec.get("blades", 6))
            ap_angle = float(ap_spec.get("angle", 0.593412))
        elif t == "constant":
            aperture_kind = "const"
        # any other texture type keeps the uniform-disk default
    elif isinstance(ap_spec, (int, float)):
        aperture_kind = "const"
    cateye = float(cam.get("cateye", 0.0))

    camera = CameraParams(
        rot=jnp.asarray(cam_m[:3, :3], jnp.float32),
        pos=jnp.asarray(cam_m[:3, 3], jnp.float32),
        plane_dist=jnp.float32(plane_dist),
        aperture_size=jnp.float32(cam.get("aperture_size", 0.001)),
        focus_dist=jnp.float32(focus_dist),
        ap_angle=jnp.float32(ap_angle),
        cateye=jnp.float32(cateye),
        ap_dist=ap_dist,
    )

    res = cam.get("resolution", [1000, 563])
    if isinstance(res, (int, float)):
        res = [int(res), int(res)]
    integ = doc.integrator
    meta = SceneMeta(
        res_x=int(res[0]),
        res_y=int(res[1]),
        camera_type=cam.get("type", "pinhole"),
        tonemap=cam.get("tonemap", "gamma"),
        filter=cam.get("reconstruction_filter", "tent"),
        fov_deg=fov,
        n_lights=n_lights,
        has_env=len(env_specs) > 0,
        env_light_index=env_index,
        env_is_constant=env_is_constant,
        stratified=bool(doc.renderer.get("stratified_sampler", False)),
        has_cap=len(cap_specs) > 0,
        cap_light_index=cap_index,
        cap_after_env=len(esc_caps) > 0,
        n_envs=len(envs),
        env_const=tuple(env_const_l),
        env_light_idx=tuple(env_light_idx),
        n_caps=len(cap_specs),
        cap_light_idx=tuple(cap_light_idx),
        esc_caps=tuple(esc_caps),
        point_light_index=point_index,
        aperture_kind=aperture_kind,
        ap_blades=ap_blades,
        cateye=cateye,
        min_bounces=int(integ.get("min_bounces", 0)),
        max_bounces=int(integ.get("max_bounces", 64)),
        enable_light_sampling=bool(integ.get("enable_light_sampling", True)),
        enable_volume_light_sampling=bool(integ.get("enable_volume_light_sampling", True)),
        low_order_scattering=bool(integ.get("low_order_scattering", True)),
        include_surfaces=bool(integ.get("include_surfaces", True)),
        enable_two_sided=bool(integ.get("enable_two_sided_shading", True)),
        has_media=len(doc.media) > 0,
        has_forward=bool(np.any(np.asarray(materials.lobes) & 0x80)),
        camera_medium=int(doc.medium_names.get(cam.get("medium"), -1)) if isinstance(cam.get("medium"), str) else -1,
        spp=int(doc.renderer.get("spp", 32)),
        spp_step=int(doc.renderer.get("spp_step", 16)),
        use_bvh=bool(doc.renderer.get("scene_bvh", True)),
        bdpt_max_vertices=_bdpt_cap(integ),
        has_fiber_tan=bool(has_fiber_tan),
        has_analytic=bool(ana_entries),
        aovs=tuple(
            (
                b.get("type"),
                b.get("output_file", ""),
                b.get("hdr_output_file", ""),
            )
            for b in doc.renderer.get("output_buffers", [])
            if b.get("type") in ("depth", "normal", "albedo")
        ),
    )

    tris_soa = TriangleSoA(
        v0=jnp.asarray(p0), e1=jnp.asarray(p1 - p0), e2=jnp.asarray(p2 - p0)
    )
    # the BVH walk's pack, for the scenes that take the walk (see
    # integrators.path_tracer._walks_bvh)
    _gb = None
    if meta.use_bvh and len(p0) > 64:
        from ..ops.gather_bvh import build_gather_pack

        _gb = build_gather_pack(p0, p1 - p0, p2 - p0)
    # one wide shading row per triangle: the hit-shading gathers (ng, n0-2,
    # uv0-2, mat, light) collapse into a SINGLE latency-bound XLA gather
    # (ids < 2^24 are exact in f32)
    shade_pack = jnp.asarray(np.concatenate(
        [tri_ng, n0, n1, n2, uv0, uv1, uv2,
         np.asarray(tri_mat, np.float32)[:, None],
         np.asarray(tri_light, np.float32)[:, None]],
        axis=1,
    ).astype(np.float32))
    textures = tex_builder.build()
    # widen the material dispatch row with the lobe mask + the albedo
    # texture HEADER so the hot-loop material fetch is one gather and the
    # albedo eval skips its header gather; albedo_kinds statically narrows
    # the albedo dispatch to kinds materials actually reference
    if materials.gpack is not None and textures.tpack is not None:
        _at = np.asarray(materials.albedo_tex)
        _g2 = np.concatenate(
            [np.asarray(materials.gpack),
             np.asarray(materials.lobes, np.float32)[:, None],
             np.asarray(textures.tpack)[
                 np.clip(_at, 0, textures.tpack.shape[0] - 1)]],
            axis=1).astype(np.float32)
        _sub = np.asarray(materials.sub_of)
        _g3 = None
        from ..models.bsdfs.dispatch import _registry as _breg
        _mixed_id = _breg()["mixed"][0]
        if (_sub >= 0).any() and _mixed_id not in materials.present:
            # single-substrate wrappers only: append the substrate's row so
            # the nested dispatch never gathers (rows with no substrate
            # carry their own row — unused)
            _g3 = np.concatenate(
                [_g2, _g2[np.clip(_sub, 0, _g2.shape[0] - 1)]], axis=1)
        materials = materials.replace(
            gpack2=jnp.asarray(_g2),
            gpack3=jnp.asarray(_g3) if _g3 is not None else None,
            albedo_kinds=tex_builder.kinds_of(_at.tolist()),
            rough_kinds=tex_builder.kinds_of(tex_builder.rough_ids),
        )
    return FlatScene(
        shade_pack=shade_pack,
        tris=tris_soa,
        tri_ng=jnp.asarray(tri_ng),
        tri_n0=jnp.asarray(n0),
        tri_n1=jnp.asarray(n1),
        tri_n2=jnp.asarray(n2),
        tri_uv0=jnp.asarray(uv0),
        tri_uv1=jnp.asarray(uv1),
        tri_uv2=jnp.asarray(uv2),
        tri_mat=jnp.asarray(tri_mat),
        tri_light=jnp.asarray(tri_light),
        tri_med_int=jnp.asarray(tri_med_int),
        tri_med_ext=jnp.asarray(tri_med_ext),
        tri_med_override=jnp.asarray(tri_med_ov),
        tri_tan=jnp.asarray(tri_tan),
        bounds=jnp.asarray(np.stack([bvh.node_min[0], bvh.node_max[0]])),
        gbvh=_gb,
        ana=ana_table,
        materials=materials,
        media=media,
        textures=textures,
        lights=lights,
        env=env,
        cap=cap,
        point=point,
        camera=camera,
        meta=meta,
        envs=tuple(envs),
    )


def _default_env(tex_builder) -> EnvLight:
    etex = tex_builder.add_constant([0.0, 0.0, 0.0])
    return EnvLight(
        rot=jnp.eye(3),
        inv_rot=jnp.eye(3),
        tex=jnp.int32(etex),
        dist=Distribution2D.build(np.ones((1, 1), np.float32)),
        tex_kind=tex_builder.types[etex],
    )


def _env_weights(img: np.ndarray) -> np.ndarray:
    """Env importance weights: max-channel luminance * sin(theta), dilated by a
    1-px 3x3 max filter with wraparound (BitmapTexture::makeSamplable,
    BitmapTexture.cpp:400-431) so bilinear-interpolated bright texels keep
    nonzero pdf."""
    h = img.shape[0]
    w = img.max(axis=-1)
    row_theta = np.sin(np.arange(h) * np.pi / h)
    w = w * row_theta[:, None]
    w = np.maximum(np.maximum(np.roll(w, 1, 1), np.roll(w, -1, 1)), w)
    w = np.maximum(np.maximum(np.roll(w, 1, 0), np.roll(w, -1, 0)), w)
    return w.astype(np.float32)
