#!/usr/bin/env python
"""Secondary benchmarks: every BASELINE.json eval config, one JSON line each
(VERDICT r4 item 2 — regressions in non-PT integrators must be visible).

Writes/prints a JSON array; `python bench_all.py --out BENCH_ALL_rNN.json`
records the round artifact. The headline bench (bench.py) stays the driver
contract; this file tracks the wider matrix:

  pt_materialtest  path_tracer, materialtest 250x141 @64 spp
  pt_cornell       path_tracer, cornell-box 256x144 @128 spp
  bdpt_caustic     BDPT, volumetric-caustic 160x90 @16 spp
  sppm_caustic     SPPM, water-caustic 160x90, 8 iters x 2^17 photons
  kelemen_vdb      Kelemen PSSMLT, voxel-medium (VDB) 120x68, small budget
  nonexp           path_tracer, non-exponential medium 160x90 @16 spp

Throughput unit is Mpaths/s (paths = pixel samples for PT/BDPT/MLT;
camera-gather rays + photons for SPPM) — self-consistent across rounds,
compile excluded, median of trials.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

EX = "/root/reference/data/example-scenes"


def _load(path, res):
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import load_scene

    doc = load_scene(path)
    doc.camera["resolution"] = list(res)
    return flatten_scene(doc)


def _timed(fn, n_paths, trials):
    fn()  # warmup/compile
    rates = []
    for _ in range(trials):
        t0 = time.time()
        fn()
        rates.append(n_paths / (time.time() - t0) / 1e6)
    return rates


def bench_pt(path, res, spp, trials):
    from tungsten_tpu.renderer.render import render_flat

    scene = _load(path, res)
    n = res[0] * res[1] * spp
    return _timed(lambda: render_flat(scene, spp=spp), n, trials)


def bench_bdpt(path, res, spp, trials):
    from tungsten_tpu.renderer.render import render_bdpt

    scene = _load(path, res)
    n = res[0] * res[1] * spp
    return _timed(lambda: render_bdpt(scene, spp=spp), n, trials)


def bench_sppm(path, res, iters, photons, trials):
    from tungsten_tpu.renderer.render import render_sppm

    scene = _load(path, res)
    n = iters * (res[0] * res[1] + photons)
    return _timed(
        lambda: render_sppm(scene, spp=iters, photons_per_iter=photons),
        n, trials)


def bench_kelemen(path, res, spp, trials):
    # the reference repo does not SHIP fire.vdb (assets excluded from git);
    # synthesize a smoke ball with the byte-exact test writer so the
    # Kelemen+VDB ratio-tracking config still runs end-to-end
    import importlib.util
    import json
    import tempfile

    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "vdb_writer", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "tests", "test_vdb.py"))
    tv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tv)
    vpath = os.path.join(tempfile.gettempdir(), "bench_fire.vdb")
    if not os.path.exists(vpath):
        g = np.mgrid[0:24, 0:24, 0:24].astype(np.float32)
        r = np.linalg.norm(g - 11.5, axis=0)
        dens = np.maximum(1.0 - r / 10.0, 0.0) ** 2
        xs, ys, zs = np.nonzero(dens > 1e-4)
        dvox = {(int(x), int(y), int(z)): float(dens[x, y, z])
                for x, y, z in zip(xs, ys, zs)}
        cvox = {k: (2.0 * v, 1.2 * v, 0.5 * v) for k, v in dvox.items()}
        tv.write_vdb(vpath, [
            {"name": "density", "type": "float", "voxels": dvox},
            {"name": "Cd", "type": "vec3s", "voxels": cvox},
        ])
    with open(path) as f:
        raw = json.load(f)
    raw["media"][0]["grid"]["file"] = vpath
    raw["camera"]["resolution"] = list(res)
    from tungsten_tpu.integrators.kelemen import render_kelemen
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import parse_scene

    scene = flatten_scene(parse_scene(raw, path=path))
    n = res[0] * res[1] * spp
    return _timed(lambda: render_kelemen(scene, spp=spp), n, trials)


CONFIGS = [
    ("pt_materialtest", lambda t: bench_pt(
        "/root/reference/data/materialtest/materialtest.json", (250, 141), 64, t)),
    ("pt_cornell", lambda t: bench_pt(
        f"{EX}/cornell-box/scene.json", (256, 144), 128, t)),
    ("bdpt_caustic", lambda t: bench_bdpt(
        f"{EX}/volumetric-caustic/scene.json", (160, 90), 16, t)),
    ("sppm_caustic", lambda t: bench_sppm(
        f"{EX}/water-caustic/scene.json", (160, 90), 8, 1 << 17, t)),
    ("kelemen_vdb", lambda t: bench_kelemen(
        f"{EX}/voxel-medium/scene.json", (120, 68), 16, t)),
    ("nonexp", lambda t: bench_pt(
        f"{EX}/non-exponential/scene.json", (160, 90), 16, t)),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--only", default=None, help="comma-separated config names")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from tungsten_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    only = set(args.only.split(",")) if args.only else None
    results = []
    for name, fn in CONFIGS:
        if only and name not in only:
            continue
        try:
            rates = fn(args.trials)
            med = statistics.median(rates)
            row = {"metric": name, "value": round(med, 4), "unit": "Mpaths/sec/chip",
                   "trials": [round(r, 4) for r in rates]}
        except Exception as e:  # a config must never take down the matrix
            row = {"metric": name, "value": 0, "unit": "Mpaths/sec/chip",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"backend": jax.default_backend(), "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
