#!/usr/bin/env python
"""Bring-up smoke test: the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-4 on one card
    python chip_smoke.py --devices 4  # only the sharded render, on 4 cards

Phases (one card, one process):
  1. intersector parity at real width: the BVH walk against brute force on
     a seeded scene of >= 1M triangles, camera and bounce rays;
  2. golden image: the committed cornell box at 256x144, 64 spp, against
     the C++ reference render tests/golden/cornell_256.pfm;
  3. main path at full width: the seeded scene through tools/tungsten.py's
     main() at materialtest's renderer settings (1000x563, 32 spp,
     adaptive, Sobol, tent, filmic), then a BVH-vs-brute-force image check;
  4. every other integrator once on the cornell box.
With --devices 4 the phase-3 scene renders sharded over a 1-D mesh of four
cards and is compared with the one-card render of the same program.

Generated data goes to .smoke_data/ in the checkout. The last line of
standard output is one JSON object with the device JAX found; any failed
phase exits non-zero before it is printed. Without a GPU the script exits
non-zero and runs nothing.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from tungsten_tpu.io.imageio import load_pfm  # noqa: E402
from tungsten_tpu.io.meshio import MeshData, compute_smooth_normals, save_wo3  # noqa: E402
from tungsten_tpu.utils.compare import golden_agreement  # noqa: E402

DATA_DIR = os.path.join(ROOT, ".smoke_data")
CORNELL = os.path.join(ROOT, "scenes", "cornell-box", "scene.json")
GOLDEN = os.path.join(ROOT, "tests", "golden", "cornell_256.pfm")
SEED = 0x5EED

# phase-3 scene at full size: a 500x500-cell height field (500,000
# triangles) and four displaced spheres of 6 x 2 x 104^2 = 129,792 each
GROUND_CELLS = 500
SPHERE_CELLS = 104

# materialtest.json's renderer and camera blocks (BASELINE.md)
RENDERER = {
    "spp": 32, "spp_step": 16, "adaptive_sampling": True,
    "stratified_sampler": True, "scene_bvh": True,
}
CAMERA = {
    "type": "pinhole", "tonemap": "filmic", "resolution": [1000, 563],
    "reconstruction_filter": "tent", "fov": 35,
    "transform": {"position": [0, 2.6, 9.5], "look_at": [0, 0.7, 0], "up": [0, 1, 0]},
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def build_native() -> str:
    """Build native/ from its tracked sources; name the BVH builder in use."""
    subprocess.run(["make", "-C", os.path.join(ROOT, "native")], check=False,
                   capture_output=True, timeout=300)
    from tungsten_tpu.accel.bvh import _load_native

    return "native C++ (native/bvh_builder.cpp)" if _load_native() else "numpy fallback"


# --------------------------------------------------------------------------
# seeded geometry
# --------------------------------------------------------------------------

def _grid_indices(nu: int, nv: int) -> np.ndarray:
    """Two triangles per cell of an (nu+1) x (nv+1) vertex grid."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).ravel()
    b, c, d = a + (nv + 1), a + 1, a + (nv + 1) + 1
    return np.stack([np.stack([a, c, b], 1), np.stack([c, d, b], 1)], 1).reshape(-1, 3)


def _mesh(pos, idx) -> MeshData:
    m = MeshData(pos=pos.astype(np.float32), normal=np.zeros_like(pos, np.float32),
                 uv=np.zeros((len(pos), 2), np.float32),
                 indices=idx.astype(np.int32), material=np.full(len(idx), -1, np.int32))
    compute_smooth_normals(m)
    return m


def height_field(rng, cells: int, half: float = 9.0) -> MeshData:
    """A cells x cells height field over [-half, half]^2, a sum of seeded
    sinusoids."""
    x, z = np.meshgrid(np.linspace(-half, half, cells + 1),
                       np.linspace(-half, half, cells + 1), indexing="ij")
    y = np.zeros_like(x)
    for _ in range(6):
        k = rng.normal(0.0, 1.2, 2)
        y += rng.uniform(0.02, 0.08) * np.sin(k[0] * x + k[1] * z + rng.uniform(0, 2 * np.pi))
    pos = np.stack([x, y - 0.2, z], -1).reshape(-1, 3)
    return _mesh(pos, _grid_indices(cells, cells))


def displaced_sphere(rng, cells: int, center, radius: float) -> MeshData:
    """A cube with cells x cells quads per face, projected to a sphere and
    displaced along the radius by seeded sinusoids of the direction."""
    g = np.linspace(-1.0, 1.0, cells + 1)
    u, v = np.meshgrid(g, g, indexing="ij")
    one = np.ones_like(u)
    faces = [(one, u, v), (-one, v, u), (u, one, v), (v, -one, u), (u, v, one), (v, u, -one)]
    pos, idx = [], []
    tri = _grid_indices(cells, cells)
    for f, (a, b, c) in enumerate(faces):
        pos.append(np.stack([a, b, c], -1).reshape(-1, 3))
        idx.append(tri + f * (cells + 1) ** 2)
    d = np.concatenate(pos)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.ones(len(d))
    for _ in range(5):
        w = rng.normal(size=3)
        r += rng.uniform(0.01, 0.04) * np.sin(rng.uniform(3, 9) * d @ (w / np.linalg.norm(w))
                                              + rng.uniform(0, 2 * np.pi))
    return _mesh(np.asarray(center) + d * (radius * r)[:, None], np.concatenate(idx))


def write_smoke_scene(out_dir: str, seed: int = SEED, ground_cells: int = GROUND_CELLS,
                      sphere_cells: int = SPHERE_CELLS) -> str:
    """Write the phase-3 scene (meshes as .wo3 plus scene.json) into out_dir;
    everything is a function of `seed`. Returns the scene path."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    meshes = {"ground": height_field(rng, ground_cells)}
    bsdfs = ["lambert_sphere", "plastic", "conductor", "glass"]
    for k, x in enumerate([-3.3, -1.1, 1.1, 3.3]):
        meshes[bsdfs[k]] = displaced_sphere(rng, sphere_cells, [x, 0.8, 0.0], 1.0)
    for name, m in meshes.items():
        save_wo3(os.path.join(out_dir, f"{name}.wo3"), m)
    raw = {
        "bsdfs": [
            {"name": "ground", "type": "lambert", "albedo": [0.55, 0.5, 0.45]},
            {"name": "lambert_sphere", "type": "lambert", "albedo": [0.7, 0.7, 0.75]},
            {"name": "plastic", "type": "rough_plastic", "albedo": [0.8, 0.25, 0.1],
             "roughness": 0.15, "ior": 1.5},
            {"name": "conductor", "type": "rough_conductor", "material": "Au",
             "roughness": 0.2},
            {"name": "glass", "type": "dielectric", "ior": 1.5},
            {"name": "light", "type": "null"},
        ],
        "primitives": [
            {"type": "mesh", "file": f"{name}.wo3", "bsdf": name, "smooth": True}
            for name in meshes
        ] + [
            {"type": "quad", "bsdf": "light", "emission": [12, 11, 9],
             "transform": {"position": [0, 5, 2], "scale": [3, 1, 2],
                           "rotation": [0, 0, 180]}},
            {"type": "skydome", "temperature": 5777, "gamma_scale": 1,
             "turbidity": 3, "intensity": 2, "sample": True,
             "transform": {"rotation": [-35, 20, 0]}},
        ],
        "camera": copy.deepcopy(CAMERA),
        "integrator": {"type": "path_tracer", "min_bounces": 0, "max_bounces": 64,
                       "enable_light_sampling": True},
        "renderer": dict(RENDERER, output_file="smoke.png", hdr_output_file="smoke.pfm"),
    }
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)
    return path


def load_variant(path: str, res=None, integrator=None, **renderer):
    """Flatten a scene file with its camera resolution, integrator and
    renderer blocks overridden."""
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import load_scene

    doc = load_scene(path)
    if res is not None:
        doc.camera["resolution"] = list(res)
    doc.integrator.update(integrator or {})
    doc.renderer.update(renderer)
    return flatten_scene(doc)


# --------------------------------------------------------------------------
# phase 1: intersector parity
# --------------------------------------------------------------------------

def smoke_rays(scene, seed: int = SEED):
    """Camera rays through every pixel centre, and as many bounce rays:
    from each camera hit (or, for a miss, a point of the scene's box) in a
    uniformly random direction. Returns ((o, d), (o, d)) as device arrays."""
    import jax.numpy as jnp

    from tungsten_tpu.models.cameras import camera_rays
    from tungsten_tpu.ops.gather_bvh import intersect_bvh_gather

    meta = scene.meta
    n = meta.res_x * meta.res_y
    px = jnp.asarray(np.arange(n, dtype=np.int32) % meta.res_x)
    py = jnp.asarray(np.arange(n, dtype=np.int32) // meta.res_x)
    o, d = camera_rays(scene.camera, meta, px, py, jnp.full((n, 2), 0.5, jnp.float32))
    h = intersect_bvh_gather(scene.gbvh, o, d, jnp.full((n,), 1e-4), jnp.full((n,), 3e38))
    rng = np.random.default_rng(seed)
    v0 = np.asarray(scene.tris.v0)
    lo, hi = v0.min(0), v0.max(0)
    hit = np.asarray(h.prim) >= 0
    p = np.where(hit[:, None], np.asarray(o + d * h.t[:, None]),
                 rng.uniform(lo, hi, (n, 3)))
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return (o, d), (jnp.asarray(p, jnp.float32), jnp.asarray(w, jnp.float32))


def parity(scene, o, d, n_sub: int, seed: int = SEED) -> dict:
    """The BVH walk against intersect_brute on n_sub rays of (o, d):
    closest hit on unbounded rays and any-hit on random finite segments."""
    import jax.numpy as jnp

    from tungsten_tpu.ops.gather_bvh import intersect_bvh_gather, occluded_bvh_gather
    from tungsten_tpu.ops.intersect import intersect_brute

    rng = np.random.default_rng(seed)
    sel = jnp.asarray(np.sort(rng.choice(o.shape[0], n_sub, replace=False)))
    o, d = o[sel], d[sel]
    tnear = jnp.full((n_sub,), 5e-4)
    tfar = jnp.full((n_sub,), 3e38)
    hb = intersect_brute(scene.tris, o, d, tnear, tfar)
    hg = intersect_bvh_gather(scene.gbvh, o, d, tnear, tfar)
    mb, mg = np.asarray(hb.prim) >= 0, np.asarray(hg.prim) >= 0
    both = mb & mg
    tb, tg = np.asarray(hb.t)[both], np.asarray(hg.t)[both]
    t_rel = float(np.max(np.abs(tg - tb) / np.maximum(np.abs(tb), 1e-30))) if both.any() else 0.0
    prim_same = float(np.mean(np.asarray(hb.prim)[both] == np.asarray(hg.prim)[both])) \
        if both.any() else 1.0
    seg = jnp.asarray(rng.uniform(0.05, 4.0, n_sub), jnp.float32)
    occ_b = np.asarray(intersect_brute(scene.tris, o, d, tnear, seg).prim) >= 0
    occ_g = np.asarray(occluded_bvh_gather(scene.gbvh, o, d, tnear, seg))
    return {
        "rays": n_sub, "hits": int(mb.sum()),
        "mask_mismatch": int(np.sum(mb != mg)), "t_max_rel": t_rel,
        "prim_agree": prim_same, "occluded": int(occ_b.sum()),
        "anyhit_mismatch": int(np.sum(occ_b != occ_g)),
    }


def check_parity(r: dict, what: str) -> None:
    check(r["mask_mismatch"] == 0, f"{what}: hit masks differ on {r['mask_mismatch']} rays")
    check(r["t_max_rel"] <= 1e-4, f"{what}: t differs by {r['t_max_rel']:.3g} relative")
    check(r["prim_agree"] >= 0.999, f"{what}: closest prim agrees on {r['prim_agree']:.5f}")
    check(r["anyhit_mismatch"] == 0,
          f"{what}: any-hit differs from brute force on {r['anyhit_mismatch']} segments")


def phase_parity(scene, n_sub: int, tag: str) -> dict:
    (oc, dc), (ob, db) = smoke_rays(scene)
    out = {}
    for kind, o, d in (("camera", oc, dc), ("bounce", ob, db)):
        r = parity(scene, o, d, min(n_sub, o.shape[0]))
        print(f"[phase 1] {kind} rays: {json.dumps(r)} [{tag}]", flush=True)
        check_parity(r, f"{kind} rays")
        out[kind] = r
    return out


# --------------------------------------------------------------------------
# phase 2: golden image
# --------------------------------------------------------------------------

def render_cornell(res, spp: int, seed: int = 0xBA5EBA11, integrator=None, **kw):
    from tungsten_tpu.renderer.render import render_flat

    scene = load_variant(CORNELL, res, integrator)
    return scene, render_flat(scene, spp=spp, seed=seed, **kw)


def phase_golden(tag: str) -> dict:
    golden = load_pfm(GOLDEN)
    t0 = time.time()
    _, img = render_cornell((256, 144), 64, samples_per_pass=4, passes_per_batch=4)
    dt = time.time() - t0
    ratio, s = golden_agreement(img, golden)
    r = {"flux_ratio": [float(x) for x in ratio], "ssim_4x": s, "seconds_incl_compile": dt}
    print(f"[phase 2] cornell 256x144 64 spp vs C++ golden: {json.dumps(r)} [{tag}]", flush=True)
    check(np.all(np.abs(ratio - 1.0) < 0.02), f"golden flux ratio {ratio}")
    check(s > 0.97, f"golden 4x-downsampled SSIM {s:.4f}")
    return r


# --------------------------------------------------------------------------
# phase 3: main path at full width
# --------------------------------------------------------------------------

def run_cli(scene_path: str, out_png: str, extra=()) -> np.ndarray:
    """Render through tools/tungsten.py's main() in this process; return
    the linear HDR image it wrote next to the PNG."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tungsten_cli", os.path.join(ROOT, "tools", "tungsten.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out_pfm = os.path.splitext(out_png)[0] + ".pfm"
    cli.main([scene_path, "-o", out_png, "-e", out_pfm, "-q", *extra])
    check(os.path.getsize(out_png) > 0, f"{out_png} is empty")
    return load_pfm(out_pfm)


def bvh_vs_brute(scene_path: str, res, spp: int, seed: int = 7) -> dict:
    """The same render with the BVH walk and with brute force: the sampler
    is stateless, so both trace the same paths."""
    from tungsten_tpu.renderer.render import render_flat

    imgs = [render_flat(load_variant(scene_path, res, scene_bvh=b, adaptive_sampling=False),
                        spp=spp, seed=seed) for b in (True, False)]
    a, b = imgs
    ratio = a.reshape(-1, 3).mean(0) / np.maximum(b.reshape(-1, 3).mean(0), 1e-12)
    close = np.abs(a - b) <= 1e-3 * np.maximum(np.abs(b), 1e-6)
    return {"flux_ratio": [float(x) for x in ratio],
            "pixels_within_1e-3": float(np.mean(np.all(close, axis=-1)))}


def phase_main_path(scene_path: str, tag: str, check_res=(100, 56), check_spp: int = 4) -> dict:
    import jax

    from tungsten_tpu.renderer.render import render_buffers

    t0 = time.time()
    scene = load_variant(scene_path)
    t_setup = time.time() - t0
    meta = scene.meta
    t0 = time.time()
    img = run_cli(scene_path, os.path.join(DATA_DIR, "smoke.png"))
    t_cli = time.time() - t0
    check(img.shape == (meta.res_y, meta.res_x, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "non-finite pixels in the main-path render")
    check(img.max() > 0.0, "the main-path render is black")
    # the same render again, compiled: what the CLI spent beyond set-up and
    # this is (mostly) compilation
    t0 = time.time()
    render_buffers(scene, adaptive=True, passes_per_batch=16).color()
    t_render = time.time() - t0
    stats = jax.devices()[0].memory_stats() or {}
    r = {
        "triangles": int(scene.tris.v0.shape[0]), "resolution": [meta.res_x, meta.res_y],
        "spp": meta.spp, "mean": [float(x) for x in img.reshape(-1, 3).mean(0)],
        "setup_s": t_setup, "cli_total_s": t_cli, "render_s_compiled": t_render,
        "compile_s_approx": t_cli - t_setup - t_render,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
    print(f"[phase 3] bring-up timings, not benchmark numbers: {json.dumps(r)} [{tag}]",
          flush=True)
    c = bvh_vs_brute(scene_path, check_res, check_spp)
    print(f"[phase 3] {check_res[0]}x{check_res[1]} {check_spp} spp, BVH walk vs brute "
          f"force: {json.dumps(c)} [{tag}]", flush=True)
    check(np.all(np.abs(np.asarray(c["flux_ratio"]) - 1.0) < 0.01),
          f"BVH vs brute-force flux ratio {c['flux_ratio']}")
    check(c["pixels_within_1e-3"] >= 0.99,
          f"only {c['pixels_within_1e-3']:.4f} of pixels agree within 1e-3")
    r["bvh_vs_brute"] = c
    return r


# --------------------------------------------------------------------------
# phase 4: every integrator once
# --------------------------------------------------------------------------

def integrator_renders(res, spp: int, mlt_chains: int, max_bounces: int, photons: int) -> dict:
    """Each integrator once on the cornell box; returns linear HDR images."""
    from tungsten_tpu.integrators.kelemen import render_kelemen_bdpt
    from tungsten_tpu.integrators.multiplexed import render_mmlt
    from tungsten_tpu.integrators.rjmlt import render_rjmlt
    from tungsten_tpu.renderer.render import render_bdpt, render_light_traced, render_sppm

    scene, pt = render_cornell(res, spp, seed=1, integrator={"max_bounces": max_bounces})
    mlt = dict(spp=spp, seed=2, n_chains=mlt_chains, bootstrap_factor=4)
    return {
        "path_tracer": pt,
        "light_tracer": render_light_traced(scene, spp=spp, seed=3),
        "bidirectional_path_tracer": render_bdpt(scene, spp=spp, seed=4),
        "progressive_photon_map": render_sppm(scene, spp=4, seed=5, photons_per_iter=photons),
        "kelemen_mlt": render_kelemen_bdpt(scene, **mlt),
        "multiplexed_mlt": render_mmlt(scene, **mlt),
        "reversible_jump_mlt": render_rjmlt(scene, **mlt),
    }


def emitter_pixels(res) -> np.ndarray:
    """Pixels of the cornell box whose footprint (the centre ray and its
    8 neighbours, the tent filter's reach) sees the light directly. A light
    tracer never renders an emitter seen directly (Tungsten's area lights
    have no directional emission toward the camera), so flux comparisons
    leave these out."""
    import jax.numpy as jnp

    from tungsten_tpu.models.cameras import camera_rays
    from tungsten_tpu.ops.intersect import intersect_brute

    scene = load_variant(CORNELL, res)
    w, h = res
    px = jnp.asarray(np.arange(w * h, dtype=np.int32) % w)
    py = jnp.asarray(np.arange(w * h, dtype=np.int32) // w)
    o, d = camera_rays(scene.camera, scene.meta, px, py, jnp.full((w * h, 2), 0.5))
    hit = intersect_brute(scene.tris, o, d, jnp.full((w * h,), 1e-4), jnp.full((w * h,), 3e38))
    prim = np.asarray(hit.prim)
    lit = (prim >= 0) & (np.asarray(scene.tri_light)[np.maximum(prim, 0)] >= 0)
    lit = np.pad(lit.reshape(h, w), 1)
    return np.max([lit[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)


def integrator_fluxes(res, spp: int, mlt_chains: int, max_bounces: int, photons: int) -> dict:
    """Each integrator's image must be finite and non-zero; returns its
    per-channel flux over the PT render's, over the pixels that do not see
    the light."""
    imgs = integrator_renders(res, spp, mlt_chains, max_bounces, photons)
    keep = ~emitter_pixels(res)
    pt_flux = imgs["path_tracer"][keep].mean(0)
    out = {}
    for name, img in imgs.items():
        check(img.shape == (res[1], res[0], 3), f"{name}: image shape {img.shape}")
        check(np.isfinite(img).all(), f"{name}: non-finite pixels")
        check(img.max() > 0.0, f"{name}: black image")
        out[name] = [float(x) for x in img[keep].mean(0) / pt_flux]
    return out


def phase_integrators(tag: str, res=(128, 72), spp: int = 16, mlt_chains: int = 1 << 13,
                      max_bounces: int = 4, photons: int = 1 << 18) -> dict:
    t0 = time.time()
    out = integrator_fluxes(res, spp, mlt_chains, max_bounces, photons)
    print(f"[phase 4] cornell {res[0]}x{res[1]}, max_bounces {max_bounces}: per-channel flux "
          f"/ PT over the pixels that do not see the light: {json.dumps(out)} "
          f"({time.time() - t0:.1f} s incl. compile) [{tag}]", flush=True)
    for name in ("light_tracer", "bidirectional_path_tracer"):
        check(np.all(np.abs(np.asarray(out[name]) - 1.0) < 0.05),
              f"{name} flux / PT = {out[name]}")
    return out


# --------------------------------------------------------------------------
# --devices 4: the sharded render
# --------------------------------------------------------------------------

def phase_sharded(scene_path: str, n_dev: int, tag: str, res=(320, 180), spp: int = 8) -> dict:
    import jax

    from tungsten_tpu.parallel.mesh import make_mesh
    from tungsten_tpu.renderer.render import render_flat

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, JAX has {len(devs)}")
    scene = load_variant(scene_path, res, adaptive_sampling=False)
    t0 = time.time()
    one = render_flat(scene, spp=spp, wavefront="lockstep")
    t_one = time.time() - t0
    t0 = time.time()
    multi = render_flat(scene, spp=spp, mesh=make_mesh(devs[:n_dev]))
    t_multi = time.time() - t0
    check(np.isfinite(multi).all() and multi.max() > 0.0, "sharded render is not finite/positive")
    ratio = multi.reshape(-1, 3).mean(0) / np.maximum(one.reshape(-1, 3).mean(0), 1e-12)
    r = {"devices": n_dev, "resolution": list(res), "spp": spp,
         "bitwise_equal": bool(np.array_equal(one, multi)),
         "max_abs_diff": float(np.max(np.abs(one - multi))),
         "flux_ratio": [float(x) for x in ratio],
         "one_card_s_incl_compile": t_one, "sharded_s_incl_compile": t_multi}
    print(f"[devices {n_dev}] sharded vs one-card lockstep render: {json.dumps(r)} [{tag}]",
          flush=True)
    check(np.all(np.abs(ratio - 1.0) < 0.005), f"sharded flux ratio {ratio}")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded render over four cards")
    args = ap.parse_args(argv)

    from tungsten_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r}); nothing run",
              file=sys.stderr)
        return 2
    tag = card()
    print(f"card: {tag}")
    print(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    print(f"BVH builder: {build_native()}", flush=True)

    os.makedirs(DATA_DIR, exist_ok=True)
    t0 = time.time()
    scene_path = write_smoke_scene(DATA_DIR)
    print(f"scene generated in {time.time() - t0:.1f} s: {scene_path}", flush=True)
    if args.devices == 1:
        t0 = time.time()
        scene = load_variant(scene_path)
        print(f"[phase 1] {scene.tris.v0.shape[0]} triangles flattened in "
              f"{time.time() - t0:.1f} s [{tag}]", flush=True)
        phase_parity(scene, 65536, tag)
        del scene
        phase_golden(tag)
        phase_main_path(scene_path, tag)
        phase_integrators(tag)
    else:
        phase_sharded(scene_path, args.devices, tag)
    print(tag)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
