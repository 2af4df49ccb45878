"""Multi-device sharding correctness: single-chip ≡ multi-chip bitwise.

The promise of parallel/mesh.py: lane ids are global and the RNG is a
stateless counter, so sharding the wavefront over any device count must not
change a single bit of the output (the wavefront replacement for the
reference's thread pool, SURVEY.md §2.4 / thread/ThreadPool.hpp:20-56).
"""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tungsten_tpu.parallel.mesh import make_mesh
from tungsten_tpu.renderer.render import render_flat
from tungsten_tpu.scene.flatten import flatten_scene
from tungsten_tpu.scene.load import parse_scene


def _mini_cornell():
    from __graft_entry__ import _MINI_CORNELL

    return flatten_scene(parse_scene(dict(_MINI_CORNELL), path="."))


@pytest.fixture(scope="module")
def scene():
    return _mini_cornell()


@pytest.fixture(scope="module")
def single_img(scene):
    # pin the LOCKSTEP wavefront: multi-device renders use it (the regen
    # wavefront is single-chip-only and draws a different — equally
    # unbiased — stream), and the bitwise promise is per-wavefront
    return render_flat(scene, spp=4, wavefront="lockstep")


def test_has_virtual_devices():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("n_dev", [2, 8])
def test_multichip_bitwise_equal(scene, single_img, n_dev):
    mesh = make_mesh(jax.devices()[:n_dev])
    multi = render_flat(scene, spp=4, mesh=mesh)
    assert single_img.shape == multi.shape
    assert np.array_equal(single_img, multi), (
        f"multi-device render ({n_dev} devices) differs from single-device: "
        f"max abs diff {np.abs(single_img - multi).max()}"
    )
    assert np.isfinite(multi).all() and multi.max() > 0.0


def test_multichip_light_tracer_matches_single(scene):
    """VERDICT r2 item 8: a SPLATTING integrator sharded over the mesh —
    scatter-added splat buffers reduce over the shard axis; global lane ids
    keep the estimator identical, so the image must match the single-device
    render to float-sum reassociation tolerance."""
    from tungsten_tpu.renderer.render import render_light_traced

    single = render_light_traced(scene, spp=4, seed=9)
    mesh = make_mesh(jax.devices()[:8])
    multi = render_light_traced(scene, spp=4, seed=9, mesh=mesh)
    assert single.shape == multi.shape
    np.testing.assert_allclose(multi, single, rtol=1e-5, atol=1e-6)


def test_multichip_bdpt_matches_single(scene):
    from tungsten_tpu.renderer.render import render_bdpt

    single = render_bdpt(scene, spp=2, seed=11)
    mesh = make_mesh(jax.devices()[:8])
    multi = render_bdpt(scene, spp=2, seed=11, mesh=mesh)
    assert single.shape == multi.shape
    np.testing.assert_allclose(multi, single, rtol=1e-5, atol=1e-6)


def test_multichip_sppm_matches_single(scene):
    """VERDICT r2 weak #7: SPPM takes the mesh — photon lanes + camera
    gather lanes shard (global lane ids), the photon grid builds on the
    gathered set. Must match the single-device render to float-sum
    reassociation tolerance."""
    from tungsten_tpu.renderer.render import render_sppm

    kw = dict(spp=2, seed=13, photons_per_iter=1 << 12)
    single = render_sppm(scene, **kw)
    mesh = make_mesh(jax.devices()[:8])
    multi = render_sppm(scene, mesh=mesh, **kw)
    assert single.shape == multi.shape
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)


def test_multichip_kelemen_matches_single(scene):
    """VERDICT r2 weak #7: PSSMLT chains shard over the mesh — the chain
    state lane-shards, the splat buffer psums over the device interconnect.
    The bootstrap and mutation streams are lane-id keyed, so the estimate
    must match the single-device run to reassociation tolerance."""
    from tungsten_tpu.integrators.kelemen import render_kelemen

    kw = dict(spp=8, seed=17, n_chains=1 << 10, bootstrap_factor=2)
    single = render_kelemen(scene, **kw)
    mesh = make_mesh(jax.devices()[:8])
    multi = render_kelemen(scene, mesh=mesh, **kw)
    assert single.shape == multi.shape
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
