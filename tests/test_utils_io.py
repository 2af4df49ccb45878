"""The pytree dataclass helper, image IO without optional packages, and the
compile-cache helper."""
import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tungsten_tpu.io import imageio
from tungsten_tpu.utils import cache
from tungsten_tpu.utils.pytree import dataclass, field


@dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = field(pytree_node=False, default=3)


def test_pytree_roundtrips_through_jit():
    p = _Pair(a=jnp.arange(4.0), b=jnp.ones(2), n=5)
    leaves, tree = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    assert jax.tree_util.tree_unflatten(tree, leaves).n == 5

    @jax.jit
    def f(x):
        return x.replace(a=x.a * x.n)  # static field usable as a Python int

    out = f(p)
    assert isinstance(out, _Pair) and out.n == 5
    np.testing.assert_array_equal(out.a, np.arange(4.0) * 5)
    np.testing.assert_array_equal(out.b, np.ones(2))


def test_pytree_static_field_retraces_and_is_frozen():
    traces = []

    @jax.jit
    def f(x):
        traces.append(x.n)
        return x.a + 1

    f(_Pair(a=jnp.zeros(2), n=1))
    f(_Pair(a=jnp.ones(2), n=1))
    f(_Pair(a=jnp.ones(2), n=2))
    assert traces == [1, 2]
    p = _Pair(a=jnp.zeros(1))
    with pytest.raises(Exception):
        p.a = jnp.ones(1)
    assert p.replace(n=7).n == 7 and p.n == 3
    assert jax.tree_util.tree_leaves(_Pair(a=jnp.zeros(1))) != []  # None b drops out


def _read_png(path):
    """Decode the unfiltered 8-bit RGB PNGs that save_png writes."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[0], hdr[1]
    assert hdr[2:] == (8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_roundtrip(tmp_path, rng):
    img = rng.random((13, 17, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    imageio.save_image(path, img)
    back = _read_png(path)
    np.testing.assert_array_equal(back, np.clip((img * 255).astype(np.int32), 0, 255))


def test_hdr_roundtrip(tmp_path, rng):
    img = (rng.random((9, 23, 3)) * np.logspace(-4, 4, 23)[None, :, None]).astype(np.float32)
    img[0, 0] = 0.0
    path = str(tmp_path / "x.hdr")
    imageio.save_image(path, img)
    back = imageio.load_image(path)
    assert back.shape == img.shape and back.dtype == np.float32
    # RGBE keeps 8 mantissa bits of the brightest channel
    err = np.abs(back - img) / np.maximum(img.max(-1, keepdims=True), 1e-30)
    assert err.max() < 1.0 / 128
    assert np.all(back[0, 0] == 0.0)


def test_hdr_reads_run_length_scanlines(tmp_path):
    w = 12
    rgbe = np.zeros((2, w, 4), np.uint8)
    rgbe[..., 0] = np.arange(w)[None, :] + 100
    rgbe[..., 1] = 50
    rgbe[..., 2] = [[7] * 6 + [9] * 6, [1] * 12]
    rgbe[..., 3] = 129  # 2^(129-136) per count
    body = b""
    for y in range(2):
        body += bytes([2, 2, 0, w])
        for c in range(4):
            ch = rgbe[y, :, c]
            if c == 0:  # one literal run of w bytes
                body += bytes([w]) + ch.tobytes()
            else:  # runs of equal bytes, at most 127 each
                x = 0
                while x < w:
                    n = 1
                    while x + n < w and ch[x + n] == ch[x]:
                        n += 1
                    body += bytes([128 + n, int(ch[x])])
                    x += n
    path = tmp_path / "rle.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y 2 +X {w}\n".encode() + body)
    img = imageio.load_image(str(path))
    np.testing.assert_allclose(img, rgbe[..., :3] * 2.0 ** (129 - 136))


def test_optional_formats_name_their_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    with pytest.raises(ImportError, match="opencv-python"):
        imageio.load_image(str(tmp_path / "x.exr"))


def test_cache_dir_fixed_path_unless_env(monkeypatch):
    assert cache.JAX_CACHE_DIR == os.path.join(cache.CHECKOUT, ".jax_cache")
    assert os.path.exists(os.path.join(cache.CHECKOUT, "tungsten_tpu", "__init__.py"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    assert cache.setup_compile_cache() == "/elsewhere"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_cache_helper_sets_fixed_path_in_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("import jax; from tungsten_tpu.utils import cache; "
            "print(cache.setup_compile_cache()); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=cache.CHECKOUT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [cache.JAX_CACHE_DIR, cache.JAX_CACHE_DIR]
