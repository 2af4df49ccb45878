"""tungsten-tpu: a physically-based wavefront renderer in JAX.

A JAX/XLA wavefront renderer with the capabilities of the
Tungsten renderer (C++ reference surveyed in SURVEY.md). The per-ray recursive
CPU megakernel of the reference becomes a batched, SPMD wavefront: SoA ray
megabatches traced through a flattened device-resident BVH, masked vectorized
BSDF dispatch, on-device NEE/MIS, and `jax.sharding`-based scaling over device
meshes.

Package layout:
  math/         vector/matrix/transform utilities (host numpy + device jnp)
  sampling/     RNG, low-discrepancy samplers, warps, distributions
  io/           scene JSON, mesh (.wo3/.obj), image (PNG/HDR/EXR/PFM) IO
  scene/        scene object model + flattening into device-resident tables
  accel/        BVH construction (host-side, numpy/C++)
  ops/          ray intersection: the BVH walk and the brute-force reference
  models/       physical models: bsdfs, cameras, media, phase functions,
                transmittances, textures, primitives
  integrators/  light-transport algorithms (path tracer, BDPT, photon map, MLT...)
  parallel/     device-mesh sharding of the sample megabatch
  utils/        pytree dataclasses, compile cache, image comparison, denoising
"""

__version__ = "0.1.0"

# On a GPU, XLA may run float32 matmuls in TF32 (about 10 mantissa bits)
# unless asked for more. The renderer's small dense matmuls (camera ray
# rotation `local @ rot.T`, env direction_to_uv `d @ inv_rot.T`,
# analytic-prim frames) are GEOMETRY: reduced-precision inputs quantize ray
# directions and shift rendered images by ~0.5-1 px against the C++
# reference. Force full-f32 matmuls everywhere; a hot path that wants a
# lower precision must opt in explicitly.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
