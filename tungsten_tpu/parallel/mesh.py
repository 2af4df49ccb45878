"""Device-mesh parallelism for the sample megabatch.

The reference's parallelism is a shared-memory thread pool over image tiles
(src/core/thread/ThreadPool.hpp:20-56); its multi-machine story is manual
seed-splitting + hdrmanip --merge (SURVEY.md §2.4). The wavefront design:

 - the wavefront (one lane per pixel-sample) is *data-sharded* over a 1-D
   device mesh ("shard" axis) with `jax.sharding.NamedSharding`;
 - the scene (BVH, triangles, materials, textures, light tables) is
   replicated into every chip's HBM — scenes are small relative to HBM;
 - per-device framebuffer partials need no collectives for the pixel-sharded
   path tracer (each device owns its pixels); splatting integrators (light
   tracer, MLT, photon pass) psum their splat buffers over the device
   interconnect;
 - lane ids are *global*, so the stateless counter RNG makes renders bitwise
   identical for any device count.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("shard",))


def shard_lanes(mesh: Mesh, *arrays):
    """Place lane-major arrays sharded over the mesh's shard axis.
    Lane counts must be padded to a multiple of the device count."""
    sh = NamedSharding(mesh, P("shard"))
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. the FlatScene) onto every device."""
    sh = NamedSharding(mesh, P())
    return jax.device_put(tree, sh)


def pad_to_devices(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def shard_chain_state(mesh: Mesh, state: dict, n_chains: int):
    """Shard an MLT chain-state dict over the mesh: every (n_chains, ...)
    leading-axis array lane-shards; everything else (the splat framebuffer)
    replicates. Chain counts are powers of two, so they divide any 2^k
    device count."""
    lane_sh = NamedSharding(mesh, P("shard"))
    repl = NamedSharding(mesh, P())
    out = {}
    for k, v in state.items():
        if hasattr(v, "shape") and v.ndim >= 1 and v.shape[0] == n_chains:
            out[k] = jax.device_put(v, lane_sh)
        else:
            out[k] = jax.device_put(v, repl)
    return out
