#!/usr/bin/env python
"""tungsten-tpu CLI renderer — the analog of src/tungsten/tungsten.cpp.

Usage: python tools/tungsten.py scene.json [scene2.json ...] [options]

Renders a queue of Tungsten scene files (schema unmodified): spp/seed
overrides, adaptive sampling, AOV output buffers, checkpointing and full
resume (options mirror src/tungsten/Shared.hpp:134-145).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description="tungsten-tpu renderer")
    ap.add_argument("scenes", nargs="+", help="scene JSON files")
    ap.add_argument("-o", "--output", help="override output file")
    ap.add_argument("-e", "--hdr-output", help="override HDR output file")
    ap.add_argument("-s", "--spp", type=int, help="override sample count")
    ap.add_argument("--seed", type=int, default=0xBA5EBA11)
    ap.add_argument("--scale", type=float, default=1.0, help="resolution scale factor")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("-r", "--restart", action="store_true", help="ignore saved resume state")
    ap.add_argument("-c", "--checkpoint", type=float, default=None,
                    help="checkpoint interval in seconds (0 disables)")
    ap.add_argument("-d", "--output-directory", help="override output directory")
    ap.add_argument("--samples-per-pass", type=int, default=1)
    ap.add_argument("--passes-per-batch", type=int, default=16)
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from tungsten_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tungsten_tpu.io.imageio import save_image
    from tungsten_tpu.models.cameras import tonemap
    from tungsten_tpu.renderer.framebuffer import scene_hash
    from tungsten_tpu.renderer.render import render_buffers, render_light_traced
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import load_scene

    import jax.numpy as jnp
    import numpy as np

    def parse_duration(v) -> float:
        if v in (None, "", "0", 0):
            return 0.0
        v = str(v)
        mult = {"s": 1, "m": 60, "h": 3600}.get(v[-1], None)
        return float(v[:-1]) * mult if mult else float(v)

    for scene_path in args.scenes:
        try:
            t0 = time.time()
            doc = load_scene(scene_path)
            if args.scale != 1.0:
                rx, ry = doc.camera.get("resolution", [1000, 563])
                doc.camera["resolution"] = [
                    max(1, int(rx * args.scale)), max(1, int(ry * args.scale))
                ]
            scene = flatten_scene(doc)
            meta = scene.meta
            out_dir = args.output_directory or os.path.dirname(scene_path) or "."

            def outpath(name):
                return name if os.path.isabs(name) else os.path.join(out_dir, name)

            if not args.quiet:
                print(
                    f"[{scene_path}] {scene.tris.v0.shape[0]} tris, "
                    f"{meta.n_lights} lights, {meta.res_x}x{meta.res_y}, "
                    f"{args.spp or meta.spp} spp on {jax.devices()[0].platform}"
                )

            itype = doc.integrator.get("type", "path_tracer")
            resume_file = None
            sh = scene_hash(doc)
            if doc.renderer.get("enable_resume_render") and not args.restart:
                resume_file = outpath(doc.renderer.get("resume_render_file", "RenderState.dat"))
            ckpt_interval = (
                args.checkpoint
                if args.checkpoint is not None
                else parse_duration(doc.renderer.get("checkpoint_interval", "0"))
            )

            def write_outputs(bufs, suffix=""):
                hdr = bufs.color()
                out = args.output or doc.renderer.get("output_file", "TungstenRender.png")
                out = outpath(out)
                if suffix:
                    stem, ext = os.path.splitext(out)
                    out = stem + suffix + ext
                ldr = np.clip(np.asarray(tonemap(meta.tonemap, jnp.asarray(hdr))), 0, 1)
                save_image(out, ldr)
                hdr_out = args.hdr_output or doc.renderer.get("hdr_output_file", "")
                if hdr_out:
                    save_image(outpath(hdr_out), hdr)
                for aov_type, ldr_file, hdr_file in meta.aovs:
                    img = bufs.aov(aov_type)
                    if img.shape[-1] == 1:
                        img = np.repeat(img, 3, -1)
                    if aov_type == "depth":
                        img = img / max(img.max(), 1e-9)
                    if ldr_file:
                        save_image(outpath(ldr_file), np.clip(img, 0, 1))
                    if hdr_file:
                        save_image(outpath(hdr_file), img)
                return out


            def save_simple(hdr):
                out = outpath(args.output or doc.renderer.get("output_file", "TungstenRender.png"))
                ldr = np.clip(np.asarray(tonemap(meta.tonemap, jnp.asarray(hdr))), 0, 1)
                save_image(out, ldr)
                hdr_out = args.hdr_output or doc.renderer.get("hdr_output_file", "")
                if hdr_out:
                    save_image(outpath(hdr_out), np.asarray(hdr, np.float32))
                return out

            if itype == "kelemen_mlt":
                # reference default is the bidirectional variant
                # (KelemenMltSettings "bidirectional": true)
                if doc.integrator.get("bidirectional", True):
                    from tungsten_tpu.integrators.kelemen import render_kelemen_bdpt

                    hdr = render_kelemen_bdpt(
                        scene, spp=args.spp, seed=args.seed,
                        p_large=float(doc.integrator.get("large_step_probability", 0.1)),
                        verbose=not args.quiet,
                    )
                else:
                    from tungsten_tpu.integrators.kelemen import render_kelemen

                    hdr = render_kelemen(
                        scene, spp=args.spp, seed=args.seed,
                        p_large=float(doc.integrator.get("large_step_probability", 0.1)),
                        verbose=not args.quiet,
                    )
                out = save_simple(hdr)
            elif itype == "multiplexed_mlt":
                from tungsten_tpu.integrators.multiplexed import render_mmlt

                hdr = render_mmlt(
                    scene, spp=args.spp, seed=args.seed,
                    p_large=float(doc.integrator.get("large_step_probability", 0.1)),
                    verbose=not args.quiet,
                )
                out = save_simple(hdr)
            elif itype == "reversible_jump_mlt":
                from tungsten_tpu.integrators.rjmlt import render_rjmlt

                hdr = render_rjmlt(
                    scene, spp=args.spp, seed=args.seed,
                    p_large=float(doc.integrator.get("large_step_probability", 0.1)),
                    verbose=not args.quiet,
                )
                out = save_simple(hdr)
            elif itype in ("photon_map", "progressive_photon_map"):
                from tungsten_tpu.renderer.render import render_sppm

                pm = doc.integrator
                hdr = render_sppm(
                    scene, spp=args.spp, seed=args.seed,
                    photons_per_iter=min(int(pm.get("photon_count", 1 << 18)), 1 << 20),
                    alpha=float(pm.get("alpha", 0.3)),
                    volume_photon_type=pm.get("volume_photon_type", "points"),
                    # plain photon_map gathers by COUNT (kNN, gatherCount
                    # default 20, PhotonMapSettings.hpp:43); progressive
                    # keeps the pure radius schedule
                    gather_count=(int(pm.get("gather_photon_count", 20))
                                  if itype == "photon_map" else None),
                    verbose=not args.quiet,
                )
                out = save_simple(hdr)
            elif itype == "bidirectional_path_tracer":
                if doc.integrator.get("image_pyramid", False):
                    # per-technique decomposition stack: <out>-s=%d-t=%d.png
                    # (ImagePyramid::saveBuffers naming, ImagePyramid.cpp:36)
                    from tungsten_tpu.renderer.render import render_bdpt_pyramid

                    hdr, stack = render_bdpt_pyramid(
                        scene, spp=args.spp, seed=args.seed,
                        verbose=not args.quiet)
                    out = save_simple(hdr)
                    base = os.path.splitext(out)[0]
                    from tungsten_tpu.io.imageio import save_image

                    for (s, t), im in stack.items():
                        ldr = np.clip(np.asarray(
                            tonemap(scene.meta.tonemap, jnp.asarray(im))), 0, 1)
                        save_image(f"{base}-s={s}-t={t}.png", ldr)
                else:
                    from tungsten_tpu.renderer.render import render_bdpt

                    hdr = render_bdpt(scene, spp=args.spp, seed=args.seed, verbose=not args.quiet)
                    out = save_simple(hdr)
            elif itype == "light_tracer":
                hdr = render_light_traced(scene, spp=args.spp, seed=args.seed)
                out = save_simple(hdr)
            else:
                bufs = render_buffers(
                    scene,
                    spp=args.spp,
                    seed=args.seed,
                    verbose=not args.quiet,
                    samples_per_pass=args.samples_per_pass,
                    passes_per_batch=args.passes_per_batch,
                    adaptive=bool(doc.renderer.get("adaptive_sampling", False)),
                    resume_file=resume_file,
                    scene_hash_value=sh,
                    checkpoint_cb=(lambda b, p: write_outputs(b, "_checkpoint"))
                    if ckpt_interval > 0
                    else None,
                    checkpoint_interval=ckpt_interval,
                )
                out = write_outputs(bufs)
            if not args.quiet:
                print(f"  wrote {out} in {time.time() - t0:.1f}s")
        except Exception as e:
            print(f"[{scene_path}] FAILED: {e}", file=sys.stderr)
            if len(args.scenes) == 1:
                raise


if __name__ == "__main__":
    main()
