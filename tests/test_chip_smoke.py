"""chip_smoke.py at tiny sizes on the CPU: the seeded scene generator, each
phase's checks, and main()'s refusal to run without a GPU. The full-size
run needs a card (python chip_smoke.py)."""
import filecmp
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tungsten_tpu.io.imageio import load_pfm  # noqa: E402


def _tiny_scene(out_dir, seed=cs.SEED, res=(32, 18), spp=2):
    path = cs.write_smoke_scene(str(out_dir), seed=seed, ground_cells=6, sphere_cells=3)
    with open(path) as f:
        raw = json.load(f)
    raw["camera"]["resolution"] = list(res)
    raw["renderer"]["spp"] = spp
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_scene(tmp_path_factory.mktemp("smoke"))


def test_scene_generator_is_deterministic(tmp_path):
    a = _tiny_scene(tmp_path / "a")
    b = _tiny_scene(tmp_path / "b")
    c = _tiny_scene(tmp_path / "c", seed=cs.SEED + 1)
    files = sorted(os.listdir(tmp_path / "a"))
    assert "scene.json" in files and len(files) == 6
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b", files, shallow=False)
    assert not mismatch and not errors
    assert not filecmp.cmp(os.path.join(os.path.dirname(a), "ground.wo3"),
                           os.path.join(os.path.dirname(c), "ground.wo3"), shallow=False)
    assert os.path.dirname(b) != os.path.dirname(a)
    # full size: 2 x 500^2 ground triangles + 4 spheres of 6 x 2 x 104^2
    assert 2 * cs.GROUND_CELLS ** 2 + 4 * 12 * cs.SPHERE_CELLS ** 2 >= 1_000_000


def test_phase_parity_tiny(tiny):
    scene = cs.load_variant(tiny)
    assert scene.tris.v0.shape[0] > 64 and scene.gbvh is not None
    out = cs.phase_parity(scene, 256, "cpu")
    assert out["camera"]["hits"] > 0 and out["bounce"]["occluded"] > 0


def test_parity_check_rejects_disagreement():
    good = {"mask_mismatch": 0, "t_max_rel": 1e-6, "prim_agree": 1.0, "anyhit_mismatch": 0}
    cs.check_parity(good, "ok")
    for key, bad in (("mask_mismatch", 1), ("t_max_rel", 1e-3), ("prim_agree", 0.99),
                     ("anyhit_mismatch", 2)):
        with pytest.raises(cs.SmokeFailure):
            cs.check_parity(dict(good, **{key: bad}), key)


def test_regen_render_same_with_and_without_bvh(tiny):
    """A trace_regen_batch render of the mesh scene traces the same paths
    with the BVH walk (scene_bvh true) and with brute force (false)."""
    r = cs.bvh_vs_brute(tiny, (24, 14), 2)
    assert np.all(np.abs(np.asarray(r["flux_ratio"]) - 1.0) < 0.01)
    assert r["pixels_within_1e-3"] >= 0.99


def test_golden_agreement_metric():
    golden = load_pfm(cs.GOLDEN)
    ratio, s = cs.golden_agreement(golden, golden)
    np.testing.assert_allclose(ratio, 1.0)
    assert s == pytest.approx(1.0)
    ratio, _ = cs.golden_agreement(golden * np.float32(1.03), golden)
    np.testing.assert_allclose(ratio, 1.03, rtol=1e-5)


def test_phase_main_path_tiny(tiny, monkeypatch, tmp_path):
    # the CLI sets up the compile cache; pointing the variable at a scratch
    # directory keeps this process's JAX configuration as it was
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(cs, "DATA_DIR", str(tmp_path))
    r = cs.phase_main_path(tiny, "cpu", check_res=(16, 9), check_spp=1)
    assert r["resolution"] == [32, 18]
    assert os.path.getsize(tmp_path / "smoke.png") > 0


def test_emitter_pixels_cover_the_light_only():
    m = cs.emitter_pixels((32, 18))
    assert m.shape == (18, 32)
    assert 0 < m.sum() < 0.1 * m.size
    assert not m[-6:].any()  # the floor half of the image never sees the light


def test_integrators_run_tiny():
    """Phase 4's renders at a size where only finiteness and shape can be
    checked (its flux test needs the card's sample counts)."""
    out = cs.integrator_fluxes((16, 9), spp=2, mlt_chains=256, max_bounces=3,
                               photons=1 << 12)
    assert set(out) == {"path_tracer", "light_tracer", "bidirectional_path_tracer",
                        "progressive_photon_map", "kelemen_mlt", "multiplexed_mlt",
                        "reversible_jump_mlt"}


def test_main_refuses_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


@pytest.mark.gpu
def test_phase_parity_on_gpu(tmp_path):
    """The BVH walk against brute force, compiled for the card, on a
    70k-triangle version of the smoke scene at 320x180."""
    path = cs.write_smoke_scene(str(tmp_path), ground_cells=150, sphere_cells=30)
    scene = cs.load_variant(path, res=(320, 180))
    cs.phase_parity(scene, 16384, cs.card())
