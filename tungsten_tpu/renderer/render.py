"""Render driver: spp-batched accumulation, adaptive sampling, AOVs,
checkpoint/resume.

The analog of the reference's render loop (src/tungsten/Shared.hpp:283-311 +
PathTraceIntegrator): render proceeds in spp_step batches; each batch is one
jitted wavefront dispatch. Seeds fold the pass index so every sample is an
independent, replayable stream (default seed 0xBA5EBA11, Shared.hpp:246).

Adaptive sampling mirrors PathTraceIntegrator.cpp:44-134: after a 16-spp
uniform warmup, per-4x4-tile relative error (two-buffer variance) with a 95th
percentile clamp and neighbor dilation drives a stochastic per-tile budget.
"""
from __future__ import annotations

import time

import numpy as np
import jax.numpy as jnp

from ..integrators.path_tracer import trace_batch, trace_pass
from ..models.cameras import tonemap
from ..scene.flatten import FlatScene, flatten_scene
from ..scene.load import SceneDocument, load_scene
from .framebuffer import OutputBuffers

DEFAULT_SEED = 0xBA5EBA11
ADAPTIVE_THRESHOLD_SPP = 16  # PathTraceIntegrator.hpp:27-29


# lanes are ordered in 16x16 image tiles, so neighbouring lanes trace
# neighbouring pixels and walk the same BVH nodes
TILE = 16


def _lane_arrays(meta, m, mesh=None):
    w, h = meta.res_x, meta.res_y
    xs, ys = np.meshgrid(np.arange(w, dtype=np.int32), np.arange(h, dtype=np.int32))
    tile_id = (ys // TILE) * ((w + TILE - 1) // TILE) + (xs // TILE)
    order = np.argsort(tile_id.ravel(), kind="stable")
    px1 = xs.ravel()[order]
    py1 = ys.ravel()[order]
    px = np.tile(px1, m)
    py = np.tile(py1, m)
    if mesh is not None:
        from ..parallel.mesh import pad_to_devices

        n_dev = mesh.devices.size
        n_pad = pad_to_devices(len(px), n_dev)
        if n_pad != len(px):
            px = np.concatenate([px, np.zeros(n_pad - len(px), np.int32)])
            py = np.concatenate([py, np.zeros(n_pad - len(py), np.int32)])
    lane = np.arange(len(px), dtype=np.uint32)
    # lane -> pixel map for accumulation
    pix_map = (py.astype(np.int64) * w + px.astype(np.int64))
    return px, py, lane, pix_map


def _place(mesh, lane, px, py):
    if mesh is None:
        return jnp.asarray(lane), jnp.asarray(px), jnp.asarray(py)
    from ..parallel.mesh import shard_lanes

    return shard_lanes(mesh, jnp.asarray(lane), jnp.asarray(px), jnp.asarray(py))


def render_buffers(
    scene: FlatScene,
    spp: int | None = None,
    seed: int = DEFAULT_SEED,
    verbose: bool = False,
    mesh=None,
    samples_per_pass: int = 1,
    passes_per_batch: int = 32,
    adaptive: bool = False,
    resume_file: str | None = None,
    scene_hash_value: str = "",
    checkpoint_cb=None,
    checkpoint_interval: float = 0.0,
    wavefront: str = "auto",
) -> OutputBuffers:
    """Full render into OutputBuffers (color + AOVs + variance)."""
    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n_pix = w * h
    m = samples_per_pass
    aov_names = tuple(a[0] for a in meta.aovs)
    bufs = OutputBuffers(w, h, aovs=aov_names)

    start_pass = 0
    if resume_file:
        extra = bufs.load_state(resume_file, scene_hash_value)
        if extra is not None:
            start_pass = int(extra.get("next_pass", 0))
            if verbose:
                print(f"  resumed at pass {start_pass}")

    if mesh is not None:
        from ..parallel.mesh import replicate

        scene = replicate(mesh, scene)

    px, py, lane, pix_map = _lane_arrays(meta, m, mesh)
    lane_arr, px_arr, py_arr = _place(mesh, lane, px, py)
    seed_arr = jnp.array([seed & 0xFFFFFFFF, 0], jnp.uint32)
    # regenerating wavefront: single-chip fast path without forward lobes
    # (occupancy stays ~100% across the bounce loop; see trace_regen_batch)
    if wavefront == "regen":
        use_regen = True
    elif wavefront == "lockstep":
        use_regen = False
    else:
        use_regen = mesh is None and not meta.has_forward
    if use_regen:
        from ..integrators.path_tracer import trace_regen_batch

        pix_arr = jnp.asarray(pix_map.astype(np.int32))

    total_passes = (spp + m - 1) // m
    done = start_pass
    t0 = time.time()
    last_ckpt = t0
    rng = np.random.default_rng(seed ^ 0x5EED)

    while done < total_passes:
        if adaptive and bufs.count.min() >= ADAPTIVE_THRESHOLD_SPP:
            # ---- adaptive step: allocate one pass of budget by tile error
            budget = n_pix * m
            err = _tile_error(bufs, w, h)
            p = err.ravel() / max(err.sum(), 1e-20)
            pix_sel = _sample_pixels_by_tile(p, w, h, rng, budget)
            px_a = (pix_sel % w).astype(np.int32)
            py_a = (pix_sel // w).astype(np.int32)
            lane_a = np.arange(len(pix_sel), dtype=np.uint32)
            la, pxa, pya = _place(mesh, lane_a, px_a, py_a)
            out = trace_batch(scene, seed_arr, la, pxa, pya, jnp.uint32(done), n_passes=1)
            rad = np.asarray(out[0] if aov_names else out)
            bufs.add_batch_sparse(rad, pix_sel)
            done += 1
        elif use_regen:
            nb = min(passes_per_batch, total_passes - done)
            out = trace_regen_batch(
                scene, seed_arr, px_arr, py_arr, pix_arr, jnp.uint32(done), n_passes=nb
            )
            if aov_names:
                rad, aux = out
                aux_np = {k: np.asarray(v) for k, v in aux.items()}
            else:
                rad, aux_np = out, None
            bufs.add_pixel_sums(np.asarray(rad), nb * m, aux_np)
            done += nb
        else:
            nb = min(passes_per_batch, total_passes - done)
            out = trace_batch(
                scene, seed_arr, lane_arr, px_arr, py_arr, jnp.uint32(done), n_passes=nb
            )
            if aov_names:
                rad, aux = out
                aux_np = {k: np.asarray(v) for k, v in aux.items()}
            else:
                rad, aux_np = out, None
            bufs.add_batch(np.asarray(rad), nb, m, n_pix, aux_np, pix_map=pix_map)
            done += nb
        if verbose:
            dt = time.time() - t0
            rate = n_pix * m * (done - start_pass) / dt / 1e6
            print(f"  spp {min(done * m, spp)}/{total_passes * m}  ({dt:.1f}s, {rate:.2f} Mpaths/s)")
        if checkpoint_cb and checkpoint_interval > 0 and time.time() - last_ckpt > checkpoint_interval:
            checkpoint_cb(bufs, done)
            last_ckpt = time.time()

    if resume_file:
        bufs.save_state(resume_file, scene_hash_value, {"next_pass": done})
    return bufs


def _tile_error(bufs, w, h):
    """4x4-tile relative error from two-buffer variance with 95th percentile
    clamp and neighbor dilation (PathTraceIntegrator.cpp:44-85)."""
    var = bufs.pixel_variance()
    mean = bufs.color().mean(-1)
    rel = var / np.maximum(mean * mean, 1e-4)
    th, tw = (h + 3) // 4, (w + 3) // 4
    rel = np.pad(rel, ((0, th * 4 - h), (0, tw * 4 - w)))
    tiles = rel.reshape(th, 4, tw, 4).mean((1, 3))
    clamp = np.percentile(tiles, 95)
    tiles = np.minimum(tiles, max(clamp, 1e-20))
    d = np.maximum(tiles, np.roll(tiles, 1, 0))
    d = np.maximum(d, np.roll(tiles, -1, 0))
    d = np.maximum(d, np.roll(tiles, 1, 1))
    d = np.maximum(d, np.roll(tiles, -1, 1))
    return d + 1e-12


def _sample_pixels_by_tile(tile_p, w, h, rng, budget):
    tw = (w + 3) // 4
    tiles = rng.choice(len(tile_p), size=budget, p=tile_p)
    ty, tx = tiles // tw, tiles % tw
    x = np.minimum(tx * 4 + rng.integers(0, 4, len(tiles)), w - 1)
    y = np.minimum(ty * 4 + rng.integers(0, 4, len(tiles)), h - 1)
    return (y * w + x).astype(np.int64)


def render_flat(
    scene: FlatScene,
    spp: int | None = None,
    seed: int = DEFAULT_SEED,
    verbose: bool = False,
    mesh=None,
    samples_per_pass: int = 1,
    passes_per_batch: int = 32,
    adaptive: bool = False,
    wavefront: str = "auto",
) -> np.ndarray:
    """Render and return the *linear* HDR framebuffer (H, W, 3) float32.

    mesh: optional jax.sharding.Mesh — shards the wavefront over devices
    (scene replicated, lanes pixel-sharded; lane ids are global, so it
    matches the single-device render of the lockstep wavefront: bitwise on
    the CPU, to float rounding on GPUs).
    """
    bufs = render_buffers(
        scene, spp=spp, seed=seed, verbose=verbose, mesh=mesh,
        samples_per_pass=samples_per_pass, passes_per_batch=passes_per_batch,
        adaptive=adaptive, wavefront=wavefront,
    )
    return bufs.color()


def render_scene(doc_or_path, spp=None, seed=DEFAULT_SEED, verbose=False):
    """Load+flatten+render; returns (linear_hdr, tonemapped_ldr01)."""
    doc = load_scene(doc_or_path) if isinstance(doc_or_path, str) else doc_or_path
    scene = flatten_scene(doc)
    hdr = render_flat(scene, spp=spp, seed=seed, verbose=verbose)
    ldr = np.asarray(tonemap(scene.meta.tonemap, jnp.asarray(hdr)))
    return hdr, np.clip(ldr, 0.0, 1.0)


def render_light_traced(scene: FlatScene, spp=None, seed=DEFAULT_SEED,
                        verbose=False, mesh=None, passes_per_batch=8):
    """Light-traced render: spp passes of W*H light paths each; the splat
    estimator satisfies E[splat_j per path] = I_j, so the image is
    splat_sum / total_paths (LightTraceIntegrator semantics).

    mesh: optional jax.sharding.Mesh — light paths lane-shard over devices
    (scene replicated); the scatter-added splat buffer is reduced by the
    partitioner over the device interconnect (SURVEY.md §2.4). Global lane
    ids keep the result bitwise independent of the device count. Passes are
    fused into batched dispatches of up to passes_per_batch passes."""
    from ..integrators.light_tracer import trace_light_batch

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    lane_ids = jnp.arange(n, dtype=jnp.uint32)
    if mesh is not None:
        from ..parallel.mesh import replicate, shard_lanes

        scene = replicate(mesh, scene)
        lane_ids = shard_lanes(mesh, lane_ids)
    seed_arr = jnp.array([seed & 0xFFFFFFFF, 0], jnp.uint32)
    acc = None
    done = 0
    while done < spp:
        nb = min(passes_per_batch, spp - done)
        buf = trace_light_batch(scene, seed_arr, lane_ids, jnp.uint32(done), n_passes=nb)
        acc = buf if acc is None else acc + buf
        done += nb
        if verbose:
            print(f"  lt spp {done}/{spp}")
    # E[splat_j per light path] = I_j  =>  normalize by total path count
    img = np.asarray(acc).reshape(h, w, 3) / (spp * float(n))
    return img


def render_bdpt(scene: FlatScene, spp=None, seed=DEFAULT_SEED, verbose=False,
                mesh=None, passes_per_batch=4):
    """BDPT render: eye-path techniques accumulate per pixel; t=1 techniques
    splat (normalized per light path, BidirectionalPathTracer.cpp:21-68).

    mesh: optional device mesh — eye lanes pixel-shard; the splat buffer is
    reduced over the device interconnect by the partitioner. Passes fuse
    into batched dispatches."""
    from ..integrators.bdpt import trace_bdpt_batch

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    px = jnp.tile(jnp.arange(w, dtype=jnp.int32), h)
    py = jnp.repeat(jnp.arange(h, dtype=jnp.int32), w)
    lane_ids = jnp.arange(n, dtype=jnp.uint32)
    if mesh is not None:
        from ..parallel.mesh import replicate, shard_lanes

        scene = replicate(mesh, scene)
        lane_ids, px, py = shard_lanes(mesh, lane_ids, px, py)
    seed_arr = jnp.array([seed & 0xFFFFFFFF, 0], jnp.uint32)
    eye_acc = None
    splat_acc = None
    done = 0
    while done < spp:
        nb = min(passes_per_batch, spp - done)
        eye, splat = trace_bdpt_batch(
            scene, seed_arr, lane_ids, px, py, jnp.uint32(done), n_passes=nb
        )
        eye_acc = eye if eye_acc is None else eye_acc + eye
        splat_acc = splat if splat_acc is None else splat_acc + splat
        done += nb
        if verbose:
            print(f"  bdpt spp {done}/{spp}")
    img = np.asarray(eye_acc).reshape(h, w, 3) / spp
    img = img + np.asarray(splat_acc).reshape(h, w, 3) / (spp * float(n))
    return img


def render_bdpt_pyramid(scene: FlatScene, spp=None, seed=DEFAULT_SEED,
                        verbose=False):
    """BDPT render that ALSO returns the per-technique (s, t) image stack
    (the reference's ImagePyramid diagnostic, ImagePyramid.cpp:20-40 /
    BidirectionalPathTraceIntegrator saveOutputs): {(s, t): (h, w, 3) HDR},
    weighted like the reference (t=1 splats by 1/(w*h*spp), others 1/spp).
    The weighted sum over all techniques equals the render."""
    from ..integrators.bdpt import trace_bdpt_pass_pyramid

    meta = scene.meta
    spp = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    px = jnp.tile(jnp.arange(w, dtype=jnp.int32), h)
    py = jnp.repeat(jnp.arange(h, dtype=jnp.int32), w)
    lane_ids = jnp.arange(n, dtype=jnp.uint32)
    eye_acc = None
    splat_acc = None
    pyr_acc = {}
    for it in range(spp):
        # same per-pass seed derivation as trace_bdpt_batch
        seed_arr = jnp.array([seed & 0xFFFFFFFF, 0x20000 + it], jnp.uint32)
        eye, splat, pyr = trace_bdpt_pass_pyramid(
            scene, seed_arr, lane_ids, px, py)
        eye_acc = eye if eye_acc is None else eye_acc + eye
        splat_acc = splat if splat_acc is None else splat_acc + splat
        for k, v in pyr.items():
            pyr_acc[k] = v if k not in pyr_acc else pyr_acc[k] + v
        if verbose:
            print(f"  bdpt-pyramid spp {it + 1}/{spp}")
    img = np.asarray(eye_acc).reshape(h, w, 3) / spp
    img = img + np.asarray(splat_acc).reshape(h, w, 3) / (spp * float(n))
    stack = {}
    for (s, t), v in sorted(pyr_acc.items()):
        weight = 1.0 / (spp * float(n)) if t == 1 else 1.0 / spp
        stack[(s, t)] = np.asarray(v).reshape(h, w, 3) * weight
    return img, stack


def render_sppm(
    scene: FlatScene,
    spp=None,
    seed=DEFAULT_SEED,
    photons_per_iter=1 << 18,
    initial_radius=None,
    volume_radius=None,
    alpha=0.3,
    verbose=False,
    mesh=None,
    volume_photon_type="points",
    gather_count=None,
):
    """Stochastic progressive photon mapping: per iteration one photon pass
    (hash-grid build) + one camera gather pass; radius shrinks per
    ProgressivePhotonMapIntegrator.cpp:58-76 (r_{i+1}^2 = r_i^2 (i+a)/(i+1)).

    volume_photon_type: "points" (3D kernel, beam query), "beams" (short
    photon beams, 1D kernel), "planes" (exact photon-plane 0D estimator,
    with beams covering the single-scatter tier) or "planes_1d" (extruded
    1D planes with control-variate visibility) — PhotonMapSettings
    volumePhotonType (points / beams / planes / planes_1d,
    PhotonMapSettings.hpp:16-23).

    mesh: optional device mesh — photon-trace lanes and camera-gather lanes
    shard over it (global lane ids keep the deposits identical); the photon
    pack is small (~10 MB at 2^18 photons) so the grid build runs on the
    gathered set, XLA inserting the all-gather over the device interconnect."""
    from ..integrators.photon_map import build_photon_grid, gather_pass, trace_photons

    meta = scene.meta
    iters = spp if spp is not None else meta.spp
    w, h = meta.res_x, meta.res_y
    n = w * h
    px = jnp.tile(jnp.arange(w, dtype=jnp.int32), h)
    py = jnp.repeat(jnp.arange(h, dtype=jnp.int32), w)
    shard_cam = False
    if mesh is not None:
        from ..parallel.mesh import pad_to_devices, replicate, shard_lanes

        scene = replicate(mesh, scene)
        n_dev = mesh.devices.size
        photons_per_iter = pad_to_devices(photons_per_iter, n_dev)
        # camera lanes shard only when they divide evenly (no pad lane
        # machinery in the gather); photon lanes always shard
        shard_cam = n % n_dev == 0
        if shard_cam:
            px, py = shard_lanes(mesh, px, py)
    ext = np.asarray(scene.bounds[1] - scene.bounds[0])
    diag = float(np.linalg.norm(ext))
    if initial_radius is None:
        # scene-bbox heuristic (the reference derives it from gatherRadius)
        initial_radius = diag * 5e-3
    if volume_radius is None:
        # reference default: volumeGatherRadius = gatherRadius
        # (PhotonMapSettings.hpp:45); the bbox heuristic is too tight for
        # the 2D beam kernel, so widen it
        volume_radius = initial_radius * 4.0
    r2 = initial_radius * initial_radius
    r_vol = volume_radius
    acc = None
    k_ph = min(meta.max_bounces, 6)
    ovf_total = 0
    for it in range(iters):
        seed_ph = jnp.array([seed & 0xFFFFFFFF, 0x30000 + it], jnp.uint32)
        lane_ph = jnp.arange(photons_per_iter, dtype=jnp.uint32)
        if mesh is not None:
            from ..parallel.mesh import shard_lanes

            lane_ph = shard_lanes(mesh, lane_ph)
        surf, vol, beams, planes = trace_photons(
            scene, seed_ph, lane_ph, k_max=k_ph,
            want_planes=volume_photon_type in ("planes", "planes_1d"),
        )
        radius = float(np.sqrt(r2))
        pack, starts, counts, ovf = build_photon_grid(
            surf[0], surf[1], surf[2], surf[3], radius, bounce=surf[4]
        )
        ovf_total += int(ovf)
        vargs = {}
        if vol is not None and volume_photon_type == "points":
            vpack, vstarts, vcounts, ovf_v = build_photon_grid(
                vol[0], vol[1], vol[2], vol[3], 2.0 * r_vol, bounce=vol[4]
            )
            ovf_total += int(ovf_v)
            vargs = dict(
                vpack=vpack, vstarts=vstarts, vcounts=vcounts,
                v_radius=jnp.float32(r_vol), scene_far=jnp.float32(diag * 2.0),
            )
        elif beams is not None and volume_photon_type in ("beams", "planes", "planes_1d"):
            from ..integrators.photon_map import build_beam_grid

            bpack, bstarts, bcounts, ovf_b, trunc = build_beam_grid(
                beams[0], beams[1], beams[2], beams[3], beams[4], beams[5],
                beams[6], jnp.float32(r_vol),
            )
            ovf_total += int(ovf_b)
            vargs = dict(
                bpack=bpack, bstarts=bstarts, bcounts=bcounts,
                b_radius=jnp.float32(r_vol), scene_far=jnp.float32(diag * 2.0),
            )
            if planes is not None and volume_photon_type in ("planes", "planes_1d"):
                from ..integrators.photon_map import build_plane_list

                # beyond MAX_PLANES the list is randomly THINNED with power
                # compensation (unbiased), so the count is not lost energy
                prows, pmask, _thinned = build_plane_list(*planes, seed=it)
                vargs.update(prows=prows, pmask=pmask)
                if volume_photon_type == "planes_1d":
                    # 1D extruded planes: thickness = the shrinking volume
                    # radius (evalPlane1D's `radius`)
                    vargs.update(p1d_radius=jnp.float32(r_vol))
        seed_cam = jnp.array([seed & 0xFFFFFFFF, 0x40000 + it], jnp.uint32)
        lane_cam = jnp.arange(n, dtype=jnp.uint32)
        if shard_cam:
            from ..parallel.mesh import shard_lanes

            lane_cam = shard_lanes(mesh, lane_cam)
        img = gather_pass(
            scene, seed_cam, lane_cam, px, py, pack, starts, counts,
            jnp.float32(radius), jnp.float32(photons_per_iter),
            knn_count=gather_count, **vargs,
        )
        acc = img if acc is None else acc + img
        # radius schedule (ProgressivePhotonMapIntegrator.cpp:58-76):
        # gamma per iteration; surface uses sqrt(gamma) on r (= gamma on
        # r^2), volume POINTS use cbrt(gamma)
        gamma_it = (it + 1 + alpha) / (it + 2)
        r2 = r2 * gamma_it
        # kernel-dimension exponents: surface 2D -> gamma on r^2; volume
        # points 3D -> cbrt; beams 1D -> gamma directly on r
        if volume_photon_type in ("beams", "planes", "planes_1d"):
            # 1D kernel (0D planes are exact — r_vol only drives their
            # single-scatter beam tier; 1D planes shrink their thickness)
            r_vol = r_vol * gamma_it
        else:
            r_vol = r_vol * gamma_it ** (1.0 / 3.0)
        if verbose:
            print(f"  sppm iter {it + 1}/{iters} r={radius:.4f} r_vol={r_vol:.4f}")
    if ovf_total and verbose:
        print(f"  note: {ovf_total} photons beyond MAX_PER_CELL were folded "
              f"into their cell's kept photons (energy-preserving "
              f"compensation; raise TUNGSTEN_PHOTON_CELL_CAP to gather them "
              f"individually)")
    img = np.asarray(acc).reshape(h, w, 3) / iters
    render_sppm.last_overflow = int(ovf_total)  # surfaced for callers
    return img
