"""Golden image-regression tests against the C++ reference's renders.

tests/golden/*.pfm are renders of the unmodified reference scenes made with
the C++ Tungsten build in this image (cornell-box 256x144 @ 512 spp,
materialtest 250x141 @ 250 spp — linear HDR before tonemap). The estimator
here is unbiased but uses different random numbers, so agreement is
noise-limited at equal spp; the tests therefore compare NOISE-REDUCED
images (box-downsampled 4x, which averages 16 pixels) and assert both
structural similarity and per-channel flux agreement. A drift in MIS
weights, light sampling, BSDF normalization, or tonemap-independent flux
turns these red (SURVEY.md §4: hdrmanip --mse/--rmse is the reference's
own comparison harness, hdrmanip.cpp:204-223).
"""
import os

import numpy as np
import pytest

from tungsten_tpu.io.imageio import load_pfm
from tungsten_tpu.renderer.render import render_flat
from tungsten_tpu.scene.flatten import flatten_scene
from tungsten_tpu.scene.load import load_scene
from tungsten_tpu.utils.compare import golden_agreement

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CORNELL = os.path.join(os.path.dirname(GOLDEN), "..", "scenes", "cornell-box", "scene.json")
MATERIALTEST = "/root/reference/data/materialtest/materialtest.json"


def test_cornell_matches_reference_render():
    golden = load_pfm(os.path.join(GOLDEN, "cornell_256.pfm"))
    doc = load_scene(CORNELL)
    doc.camera["resolution"] = [256, 144]
    scene = flatten_scene(doc)
    img = render_flat(scene, spp=64, samples_per_pass=4, passes_per_batch=4)
    assert img.shape == golden.shape

    # flux: per-channel means (tonemap-independent) within 2%; structure:
    # 4x box-downsampled tonemapped SSIM (noise-reduced)
    ratio, s = golden_agreement(img, golden, 4)
    assert np.all(np.abs(ratio - 1.0) < 0.02), f"channel flux ratio {ratio}"
    assert s > 0.97, f"downsampled SSIM {s:.4f}"


@pytest.mark.skipif(not os.path.exists(MATERIALTEST), reason="reference data absent")
def test_materialtest_matches_reference_render():
    golden = load_pfm(os.path.join(GOLDEN, "materialtest_250.pfm"))
    doc = load_scene(MATERIALTEST)
    doc.camera["resolution"] = [250, 141]
    scene = flatten_scene(doc)
    img = render_flat(scene, spp=32, samples_per_pass=4, passes_per_batch=4)
    assert img.shape == golden.shape

    ratio, s = golden_agreement(img, golden, 4)
    assert np.all(np.abs(ratio - 1.0) < 0.03), f"channel flux ratio {ratio}"
    assert s > 0.93, f"downsampled SSIM {s:.4f}"


@pytest.mark.skipif(os.environ.get("TUNGSTEN_TEST_SLOW", "") != "1",
                    reason="converged 8192-spp render; TUNGSTEN_TEST_SLOW=1")
def test_cornell_quality_contract_converged():
    """The BASELINE.json quality contract, demonstrated at convergence:
    full-res tonemapped SSIM >= 0.99 against the C++ reference's 16384-spp
    render (tests/golden/cornell_16k.pfm, rendered with the in-image embree
    build). Recorded result: SSIM 0.9990 at 8192 spp, per-channel flux
    ratio 0.9975-0.9980 (COVERAGE.md "Quality contract"). Requires the
    package-wide f32 matmul precision (__init__.py) — reduced-precision
    camera rotations shift the image ~0.5 px and cap SSIM at ~0.62."""
    golden = load_pfm(os.path.join(GOLDEN, "cornell_16k.pfm"))
    doc = load_scene(CORNELL)
    doc.camera["resolution"] = [256, 144]
    scene = flatten_scene(doc)
    img = render_flat(scene, spp=8192, samples_per_pass=1, passes_per_batch=64,
                      seed=123)
    ratio, s = golden_agreement(img, golden, 1)
    assert np.all(np.abs(ratio - 1.0) < 0.005), f"channel flux ratio {ratio}"
    assert s >= 0.99, f"full-res converged SSIM {s:.4f}"
