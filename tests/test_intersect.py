"""Ray-triangle intersection: the BVH walk (ops.gather_bvh) against brute
force, and the three entry points the integrators trace through."""
import numpy as np
import jax.numpy as jnp
import pytest

from tungsten_tpu.accel import bvh as bvh_mod
from tungsten_tpu.ops.gather_bvh import (
    build_gather_pack,
    intersect_bvh_gather,
    occluded_bvh_gather,
)
from tungsten_tpu.ops.intersect import TriangleSoA, intersect_brute, INF


def random_scene(rng, n_tris=200, spread=2.0):
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    return base, e1, e2


def make_bvh(v0, e1, e2):
    """Triangles in BVH leaf order (as flatten_scene stores them) and the
    walk's pack over them."""
    p1, p2 = v0 + e1, v0 + e2
    bmin = np.minimum(np.minimum(v0, p1), p2)
    bmax = np.maximum(np.maximum(v0, p1), p2)
    perm = bvh_mod.build_bvh(bmin, bmax).prim_order
    v0, e1, e2 = v0[perm], e1[perm], e2[perm]
    tris = TriangleSoA(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2))
    return tris, build_gather_pack(v0, e1, e2), perm


def random_rays(rng, n):
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_matches_brute(tris, pack, o, d, tnear, tfar):
    hb = intersect_brute(tris, o, d, tnear, tfar)
    hv = intersect_bvh_gather(pack, o, d, tnear, tfar)
    hit_b, hit_v = np.asarray(hb.prim >= 0), np.asarray(hv.prim >= 0)
    np.testing.assert_array_equal(hit_b, hit_v)
    tb, tv = np.asarray(hb.t), np.asarray(hv.t)
    np.testing.assert_allclose(tb[hit_b], tv[hit_b], rtol=1e-4)
    # same triangle except exact-tie cases
    same = np.asarray(hb.prim) == np.asarray(hv.prim)
    assert same[hit_b].mean() > 0.999


def test_bvh_matches_bruteforce(rng):
    v0, e1, e2 = random_scene(rng, 300)
    tris, pack, _ = make_bvh(v0, e1, e2)
    n = 2048
    o, d = random_rays(rng, n)
    _assert_matches_brute(tris, pack, o, d, jnp.full((n,), 1e-4), jnp.full((n,), INF))


def test_bvh_respects_tfar_and_tnear(rng):
    v0, e1, e2 = random_scene(rng, 100)
    tris, pack, _ = make_bvh(v0, e1, e2)
    n = 512
    o, d = random_rays(rng, n)
    full = intersect_bvh_gather(pack, o, d, jnp.full((n,), 1e-4), jnp.full((n,), INF))
    t = np.asarray(full.t)
    hit = t < 1e30
    # shorten rays to just before their hit: must all miss
    tfar_short = jnp.asarray(np.where(hit, t * 0.99, 1e30))
    short = intersect_bvh_gather(pack, o, d, jnp.full((n,), 1e-4), tfar_short)
    assert not np.asarray(short.prim >= 0)[hit].any()
    # tnear past the hit: the first hit must be excluded
    tnear_past = jnp.asarray(np.where(hit, t * 1.01, 1e-4))
    past = intersect_bvh_gather(pack, o, d, tnear_past, jnp.full((n,), INF))
    changed = np.asarray(past.prim) != np.asarray(full.prim)
    assert changed[hit].all()


def test_any_hit_mode(rng):
    v0, e1, e2 = random_scene(rng, 100)
    tris, pack, _ = make_bvh(v0, e1, e2)
    n = 512
    o, d = random_rays(rng, n)
    nearest = intersect_bvh_gather(pack, o, d, jnp.full((n,), 1e-4), jnp.full((n,), INF))
    anyh = occluded_bvh_gather(pack, o, d, jnp.full((n,), 1e-4), jnp.full((n,), INF))
    np.testing.assert_array_equal(np.asarray(nearest.prim >= 0), np.asarray(anyh))


def test_native_bvh_matches_bruteforce(rng, monkeypatch):
    """The walk over a tree from the native C++ builder matches brute force."""
    v0, e1, e2 = random_scene(rng, 500)
    p1, p2 = v0 + e1, v0 + e2
    if bvh_mod.build_bvh_native(np.minimum(np.minimum(v0, p1), p2),
                                np.maximum(np.maximum(v0, p1), p2)) is None:
        pytest.skip("native builder not built (no toolchain?); conftest "
                    "auto-builds it when make/g++ are present")
    monkeypatch.setattr(bvh_mod, "build_bvh_cached", bvh_mod.build_bvh_native)
    tris = TriangleSoA(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2))
    pack = build_gather_pack(v0, e1, e2)
    n = 2048
    o, d = random_rays(rng, n)
    _assert_matches_brute(tris, pack, o, d, jnp.full((n,), 1e-4), jnp.full((n,), INF))


def _entry_scene(v0, e1, e2, use_bvh):
    """The fields the intersector entry points read from a FlatScene."""
    from types import SimpleNamespace

    from tungsten_tpu.ops.gather_bvh import build_gather_pack

    tris = TriangleSoA(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2))
    pack = build_gather_pack(v0, e1, e2) if use_bvh and len(v0) > 64 else None
    return SimpleNamespace(meta=SimpleNamespace(use_bvh=use_bvh), tris=tris, gbvh=pack,
                           ana=None)


@pytest.mark.parametrize("use_bvh", [True, False])
def test_entry_points_match_bruteforce(rng, use_bvh):
    """_intersect_tris, _occluded_raw_tris and _intersect_mixed (including
    the any-hit latch of its lanes) agree with intersect_brute on a
    > 64-triangle mesh, whichever walk the scene selects."""
    from tungsten_tpu.integrators import path_tracer as pt

    v0, e1, e2 = random_scene(rng, 400)
    scene = _entry_scene(v0, e1, e2, use_bvh)
    assert pt._walks_bvh(scene) == use_bvh
    n = 4096
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tnear = jnp.full((n,), 1e-4)
    tfar = jnp.full((n,), INF)
    seg = jnp.asarray(rng.uniform(0.1, 5.0, n).astype(np.float32))
    ref = intersect_brute(scene.tris, o, d, tnear, tfar)
    ref_hit = np.asarray(ref.prim) >= 0

    h = pt._intersect_tris(scene, o, d, tnear, tfar)
    np.testing.assert_array_equal(np.asarray(h.prim) >= 0, ref_hit)
    np.testing.assert_allclose(np.asarray(h.t)[ref_hit], np.asarray(ref.t)[ref_hit], rtol=1e-4)
    assert np.mean(np.asarray(h.prim)[ref_hit] == np.asarray(ref.prim)[ref_hit]) > 0.999

    occ = np.asarray(pt._occluded_raw_tris(scene, o, d, tnear, seg))
    occ_ref = np.asarray(intersect_brute(scene.tris, o, d, tnear, seg).prim) >= 0
    np.testing.assert_array_equal(occ, occ_ref)

    latch = jnp.asarray(rng.random(n) < 0.5)
    hm = pt._intersect_mixed(scene, o, d, tnear, tfar, latch)
    lat = np.asarray(latch)
    np.testing.assert_array_equal(np.asarray(hm.prim) >= 0, ref_hit)
    closest = ~lat & ref_hit
    np.testing.assert_allclose(np.asarray(hm.t)[closest], np.asarray(ref.t)[closest], rtol=1e-4)
    assert np.mean(np.asarray(hm.prim)[closest] == np.asarray(ref.prim)[closest]) > 0.999


def test_small_scenes_take_brute_force(rng):
    from tungsten_tpu.integrators import path_tracer as pt

    v0, e1, e2 = random_scene(rng, 64)
    assert not pt._walks_bvh(_entry_scene(v0, e1, e2, True))
