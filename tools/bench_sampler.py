#!/usr/bin/env python
"""Microbenchmark: cost of one bounce's worth of sampler draws (PCG4D vs
Sobol strat mode) at wavefront width, on the real device. The regen tracer
consumes ~12 draws/bounce; this times 12 chained next_2d calls feeding a
trivial reduction so nothing is DCE'd."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from tungsten_tpu.sampling import Sampler
from tungsten_tpu.utils.cache import setup_compile_cache

N = 141_000
DRAWS = 12


def run(strat):
    lane = jnp.arange(N, dtype=jnp.uint32)
    seed = jnp.array([1234, 5678], jnp.uint32)
    samp = jnp.full((N,), 7, jnp.uint32) if strat else None
    pix = lane % jnp.uint32(35_000) if strat else None
    bounce = (lane % jnp.uint32(8)).astype(jnp.int32)  # per-lane dims like regen

    @jax.jit
    def f(seed, lane, bounce, samp, pix):
        s = Sampler(seed, lane, jnp.int32(2) + bounce * 24, None, samp, pix, strat)
        acc = jnp.zeros((N,))
        for _ in range(DRAWS):
            u, s = s.next_2d()
            acc = acc + u[:, 0] + u[:, 1]
        return acc

    r = f(seed, lane, bounce, samp, pix)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(10):
        r = f(seed, lane, bounce, samp, pix)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / 10
    print(f"strat={strat}: {dt*1e3:8.3f} ms for {DRAWS} next_2d x {N} lanes "
          f"({dt/N/DRAWS*1e9:6.1f} ns/draw/lane)")
    return dt


if __name__ == "__main__":
    setup_compile_cache()
    print("backend", jax.default_backend())
    run(False)
    run(True)
