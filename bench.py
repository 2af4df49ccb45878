#!/usr/bin/env python
"""Benchmark entry point — prints ONE JSON line with the headline metric.

Metric: path-tracing throughput (Mpaths/sec/chip) on the BASELINE.json
primary config (materialtest at 250x141; cornell-box fallback), measured
steady-state (compile excluded).

Protocol: one warmup render (compiles + first-D2H), then TRIALS timed
renders; the headline value is the MEDIAN and the spread (min/max) is
reported alongside so run-to-run noise cannot hide regressions.

Baseline: the C++ reference (embree, SSE4.2) was built in this image and
measured on the same host (single hardware core):
  - materialtest 250x141 @ 256 spp: 20.0 s  -> 0.451 Mpaths/s/core
  - cornell-box  256x144 @ 512 spp: 14.1 s  -> 1.34  Mpaths/s/core
BASELINE.json's target is >=10x a *32-core* build; assuming linear embree
scaling, the 32-core references are 14.4 (materialtest) and 42.9 (cornell)
Mpaths/s. vs_baseline below is my_throughput / reference_32core.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_32CORE = {
    "materialtest": 14.4,  # Mpaths/s, 32x single-core measurement
    "cornell": 42.9,
}

SCENES = {
    "materialtest": ("/root/reference/data/materialtest/materialtest.json", [250, 141]),
    "cornell": ("/root/reference/data/example-scenes/cornell-box/scene.json", [256, 144]),
}

TRIALS = 5


def main():
    from tungsten_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    from tungsten_tpu.renderer.render import render_flat
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import load_scene

    name = None
    scene = None
    for cand in ["materialtest", "cornell"]:
        path, res = SCENES[cand]
        try:
            doc = load_scene(path)
            doc.camera["resolution"] = res
            scene = flatten_scene(doc)
            name = cand
            break
        except NotImplementedError as e:
            print(f"# {cand} unsupported ({e}); falling back", file=sys.stderr)
    if scene is None:
        print(json.dumps({"metric": "error", "value": 0, "unit": "", "vs_baseline": 0}))
        return

    n_pix = scene.meta.res_x * scene.meta.res_y
    # one sample per pixel per pass, all 64 passes fused into one dispatch
    spp_meas, m, ppb = 64, 1, 64

    # intersector parity gate: the BVH walk the bench exercises must agree
    # with the brute-force reference on this device before any number is
    # reported
    if scene.gbvh is not None:
        import numpy as _np
        import jax.numpy as jnp
        from tungsten_tpu.ops.gather_bvh import intersect_bvh_gather
        from tungsten_tpu.ops.intersect import intersect_brute

        rng = _np.random.default_rng(0)
        lo = _np.asarray(scene.tris.v0).min(0) - 0.5
        hi = (_np.asarray(scene.tris.v0)
              + _np.maximum(_np.asarray(scene.tris.e1), 0)
              + _np.maximum(_np.asarray(scene.tris.e2), 0)).max(0) + 0.5
        o = jnp.asarray(rng.uniform(lo, hi, (4096, 3)), jnp.float32)
        d = rng.normal(size=(4096, 3))
        d = jnp.asarray(d / _np.linalg.norm(d, axis=-1, keepdims=True), jnp.float32)
        tn = jnp.full((4096,), 1e-4, jnp.float32)
        tf = jnp.full((4096,), 3.0e38, jnp.float32)
        hg = intersect_bvh_gather(scene.gbvh, o, d, tn, tf)
        hb = intersect_brute(scene.tris, o, d, tn, tf)
        agree = float(_np.mean(_np.asarray(hg.prim) == _np.asarray(hb.prim)))
        if agree < 0.999:
            print(json.dumps({
                "metric": "error: BVH walk parity failed on this device",
                "value": 0, "unit": "", "vs_baseline": 0,
                "parity": agree,
            }))
            return
        print(f"# BVH walk parity: {agree * 100:.3f}% agree", file=sys.stderr)

    # warmup at the MEASURED config: a different spp/batch shape compiles a
    # different program, so a 16-spp warmup left trial 1 paying a fresh
    # compile (observed 0.128 vs 0.237 Mpaths/s steady state)
    render_flat(scene, spp=spp_meas, samples_per_pass=m, passes_per_batch=ppb)
    rates = []
    for trial in range(TRIALS):
        t0 = time.time()
        render_flat(scene, spp=spp_meas, samples_per_pass=m, passes_per_batch=ppb)
        dt = time.time() - t0
        rates.append(n_pix * spp_meas / dt / 1e6)
        print(f"# trial {trial + 1}/{TRIALS}: {rates[-1]:.3f} Mpaths/s", file=sys.stderr)

    med = statistics.median(rates)
    result = {
        "metric": f"{name} path-tracing throughput per chip",
        "value": round(med, 4),
        "unit": "Mpaths/sec/chip",
        "vs_baseline": round(med / REF_32CORE[name], 4),
        "trials": [round(r, 4) for r in rates],
        "spread": [round(min(rates), 4), round(max(rates), 4)],
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
