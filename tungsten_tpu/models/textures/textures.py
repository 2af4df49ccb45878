"""Texture system: host-side builder + device-side table evaluation.

The reference's Texture hierarchy (src/core/textures/, TextureFactory.cpp:11-18:
bitmap, constant, checker, disk, blade, ies) becomes a flat SoA table: every
texture in the scene gets a type id and a parameter row; bitmap texels are
concatenated into one (P, 3) HBM array indexed by (offset, w, h). Evaluation
is fully batched masked dispatch over the wavefront — no virtual calls.

Bitmap lookup reproduces BitmapTexture::operator[] (BitmapTexture.cpp): v is
flipped (row = (1-v)*h), bilinear with -0.5 texel center offset, repeat-wrap
addressing (clamp optional).
"""
from __future__ import annotations

from typing import List

import numpy as np
import jax.numpy as jnp
from ...utils.pytree import dataclass as pytree, field

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_BITMAP = 2
TEX_DISK = 3
TEX_BLADE = 4

_PARAMS = 8


@pytree
class TextureTable:
    type: jnp.ndarray  # (K,) int32
    params: jnp.ndarray  # (K, 8) float32
    data: jnp.ndarray  # (P, 3) float32 concatenated bitmap texels (row-major)
    # (P, 12) 2x2-block pack: row i = [c(i), c(right), c(down), c(diag)] with
    # the wrap/clamp of the +1 neighbors baked per texture at build time, so
    # a bilinear tap is ONE row gather instead of four
    data4: jnp.ndarray = None
    # (K, 9) packed [params | type] — the eval_texture header fetch is one
    # gather instead of two
    tpack: jnp.ndarray = None

    # static: which types are present (drives masked dispatch)
    present: tuple = field(pytree_node=False, default=())


class TextureBuilder:
    """Host-side accumulation of scene textures into a TextureTable."""

    def __init__(self):
        self.types: List[int] = []
        self.params: List[np.ndarray] = []
        self.blobs: List[np.ndarray] = []
        self._blob_meta: List[tuple] = []  # (h, w, clamp) per blob
        self._blob_off = 0
        self._cache = {}
        # tex ids referenced by bsdf roughness slots (pack_roughness) — the
        # static `may` hint for resolve_roughness
        self.rough_ids = []

    def add_constant(self, rgb) -> int:
        rgb = np.asarray(rgb, np.float32).ravel()
        if rgb.size == 1:
            rgb = np.repeat(rgb, 3)
        key = ("const", tuple(rgb))
        if key in self._cache:
            return self._cache[key]
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = rgb
        idx = self._push(TEX_CONSTANT, p)
        self._cache[key] = idx
        return idx

    def add_checker(self, on_color, off_color, res_u=20, res_v=20) -> int:
        on = np.asarray(on_color, np.float32).ravel()
        off = np.asarray(off_color, np.float32).ravel()
        if on.size == 1:
            on = np.repeat(on, 3)
        if off.size == 1:
            off = np.repeat(off, 3)
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = on
        p[3:6] = off
        p[6] = res_u
        p[7] = res_v
        return self._push(TEX_CHECKER, p)

    def add_bitmap(self, img: np.ndarray, path_key=None, clamp=False, scale=1.0) -> int:
        key = ("bitmap", path_key, clamp, scale)
        if path_key is not None and key in self._cache:
            return self._cache[key]
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[:2]
        p = np.zeros(_PARAMS, np.float32)
        p[0] = self._blob_off
        p[1] = w
        p[2] = h
        p[3] = 1.0 if clamp else 0.0
        p[4] = scale
        self.blobs.append(img.reshape(-1, 3) * scale if scale != 1.0 else img.reshape(-1, 3))
        self._blob_meta.append((h, w, clamp))
        self._blob_off += h * w
        idx = self._push(TEX_BITMAP, p)
        if path_key is not None:
            self._cache[key] = idx
        return idx

    def add_disk(self, value=1.0) -> int:
        v = np.asarray(value, np.float32).ravel()
        if v.size == 1:
            v = np.repeat(v, 3)
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = v
        return self._push(TEX_DISK, p)

    def add_blade(self, blades=6, angle=0.593412, value=1.0) -> int:
        v = np.asarray(value, np.float32).ravel()
        if v.size == 1:
            v = np.repeat(v, 3)
        p = np.zeros(_PARAMS, np.float32)
        p[:3] = v
        p[6] = blades
        p[7] = angle
        return self._push(TEX_BLADE, p)

    def _push(self, t: int, p: np.ndarray) -> int:
        self.types.append(t)
        self.params.append(p)
        return len(self.types) - 1

    def kinds_of(self, ids) -> tuple:
        """STATIC sorted tuple of texture types reachable from these ids —
        the eval_texture `may` hint (invalid/negative ids contribute none)."""
        return tuple(sorted({
            self.types[i] for i in ids if 0 <= int(i) < len(self.types)}))

    def image(self, tex_id: int) -> np.ndarray:
        """Host-side access to a bitmap's texels (H, W, 3) — used for building
        env-map sampling distributions."""
        assert self.types[tex_id] == TEX_BITMAP
        off, w, h = (int(self.params[tex_id][i]) for i in range(3))
        flat = np.concatenate(self.blobs, axis=0) if self.blobs else np.zeros((0, 3), np.float32)
        return flat[off : off + w * h].reshape(h, w, 3)

    def average(self, tex_id: int) -> np.ndarray:
        """Mean value of a texture (Texture::average) — for light power weights."""
        t = self.types[tex_id]
        p = self.params[tex_id]
        if t == TEX_CONSTANT:
            return p[:3].copy()
        if t == TEX_CHECKER:
            return 0.5 * (p[:3] + p[3:6])
        if t == TEX_BITMAP:
            return self.image(tex_id).mean(axis=(0, 1))
        if t == TEX_DISK:
            return np.float32(np.pi * 0.25) * p[:3]
        if t == TEX_BLADE:
            nb = max(p[6], 3.0)
            return np.float32(0.125 * nb * np.sin(2.0 * np.pi / nb)) * p[:3]
        return np.ones(3, np.float32)

    def build(self) -> TextureTable:
        import os

        if not self.types:
            # always keep one dummy constant so the arrays are non-empty
            self.add_constant([0.0, 0.0, 0.0])
        data = (
            np.concatenate(self.blobs, axis=0)
            if self.blobs
            else np.zeros((1, 3), np.float32)
        )
        # 2x2-block pack (see TextureTable.data4); skipped for very large
        # atlases where the 4x memory is not worth the gather-count win
        max_texels = int(os.environ.get("TUNGSTEN_TEX4_MAX", str(1 << 23)))
        data4 = None
        if self.blobs and data.shape[0] <= max_texels:
            packs = []
            for img, (h, w, clamp) in zip(self.blobs, self._blob_meta):
                t = img.reshape(h, w, 3)
                if clamp:
                    iu1 = np.minimum(np.arange(w) + 1, w - 1)
                    iv1 = np.minimum(np.arange(h) + 1, h - 1)
                else:
                    iu1 = (np.arange(w) + 1) % w
                    iv1 = (np.arange(h) + 1) % h
                packs.append(
                    np.concatenate(
                        [t, t[:, iu1], t[iv1], t[iv1][:, iu1]], axis=-1
                    ).reshape(-1, 12)
                )
            data4 = jnp.asarray(np.concatenate(packs, axis=0))
        tpack = np.concatenate(
            [np.stack(self.params),
             np.asarray(self.types, np.float32)[:, None]], axis=1,
        ).astype(np.float32)
        return TextureTable(
            type=jnp.asarray(np.asarray(self.types, np.int32)),
            params=jnp.asarray(np.stack(self.params)),
            data=jnp.asarray(data),
            data4=data4,
            tpack=jnp.asarray(tpack),
            present=tuple(sorted(set(self.types))),
        )


def _eval_constant(params, uv):
    return params[..., 0:3]


def _eval_checker(params, uv):
    # CheckerTexture::operator[] (CheckerTexture.cpp): on = (iu ^ iv) & 1
    iu = (uv[..., 0] * params[..., 6]).astype(jnp.int32)
    iv = (uv[..., 1] * params[..., 7]).astype(jnp.int32)
    on = ((iu ^ iv) & 1) == 1
    return jnp.where(on[..., None], params[..., 0:3], params[..., 3:6])


def _eval_bitmap(data, params, uv, data4=None):
    off = params[..., 0].astype(jnp.int32)
    w = params[..., 1].astype(jnp.int32)
    h = params[..., 2].astype(jnp.int32)
    clamp = params[..., 3] > 0.5

    u = uv[..., 0] * params[..., 1] - 0.5
    v = (1.0 - uv[..., 1]) * params[..., 2] - 0.5
    iu0 = jnp.floor(u).astype(jnp.int32)
    iv0 = jnp.floor(v).astype(jnp.int32)
    fu = u - iu0
    fv = v - iv0

    def wrap(i, n, clamp_mask):
        return jnp.where(clamp_mask, jnp.clip(i, 0, n - 1), ((i % n) + n) % n)

    iu1 = wrap(iu0 + 1, w, clamp)
    iv1 = wrap(iv0 + 1, h, clamp)
    iu0 = wrap(iu0, w, clamp)
    iv0 = wrap(iv0, h, clamp)
    fu = fu[..., None]
    fv = fv[..., None]
    if data4 is not None:
        # one gather: the row holds the full 2x2 block (+1 wrap pre-baked)
        row = data4[jnp.clip(off + iu0 + iv0 * w, 0, data4.shape[0] - 1)]
        c00, c10 = row[..., 0:3], row[..., 3:6]
        c01, c11 = row[..., 6:9], row[..., 9:12]
    else:
        safe = lambda idx: jnp.clip(idx, 0, data.shape[0] - 1)
        c00 = data[safe(off + iu0 + iv0 * w)]
        c10 = data[safe(off + iu1 + iv0 * w)]
        c01 = data[safe(off + iu0 + iv1 * w)]
        c11 = data[safe(off + iu1 + iv1 * w)]
    return (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv


def _eval_disk(params, uv):
    # DiskTexture::operator[]: unit disk centered at uv (0.5, 0.5)
    d = uv - 0.5
    inside = d[..., 0] ** 2 + d[..., 1] ** 2 < 0.25
    return jnp.where(inside[..., None], params[..., 0:3], 0.0)


def _eval_blade(params, uv):
    # BladeTexture::operator[] (BladeTexture.cpp:73-88): n-gon aperture
    nb = jnp.maximum(params[..., 6], 3.0)
    angle = params[..., 7]
    blade_angle = (2.0 * jnp.pi) / nb
    g = uv * 2.0 - 1.0
    phi = jnp.arctan2(g[..., 1], g[..., 0]) - angle
    phi = -(jnp.floor(phi / blade_angle) * blade_angle + angle)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    lx = g[..., 0] * cp - g[..., 1] * sp
    ly = g[..., 1] * cp + g[..., 0] * sp
    bnx = jnp.cos(blade_angle * 0.5)
    bny = jnp.sin(blade_angle * 0.5)
    outside = bnx * (lx - 1.0) + bny * ly > 0.0
    center = (uv[..., 0] + uv[..., 1]) == 0.0  # reference's uv==0 special case
    val = jnp.where(outside[..., None], 0.0, params[..., 0:3])
    return jnp.where(center[..., None], params[..., 0:3], val)


def eval_texture(table: TextureTable, tex_id, uv, may=None, pre=None):
    """Batched lookup: tex_id (N,), uv (N, 2) -> rgb (N, 3).

    Dispatch is masked over the texture types *present in the scene* (static),
    so a scene with only constants compiles to a single gather.

    may: optional STATIC tuple of texture types this call site's tex_id set
    can actually contain (computed at flatten) — branches outside it are
    never built, so e.g. an albedo eval in a scene whose only bitmap is the
    envmap skips the (unconditionally executed, latency-bound) texel gather.
    pre: optional (params, ttype) pair when the caller already fetched the
    header as part of its own packed row — skips the header gather here.
    """
    if pre is not None:
        params, ttype = pre
    elif table.tpack is not None:
        row = table.tpack[tex_id]  # one gather for params + type
        params = row[..., :-1]
        ttype = row[..., -1].astype(jnp.int32)
    else:
        params = table.params[tex_id]
        ttype = table.type[tex_id]
    kinds = table.present if may is None else tuple(
        t for t in table.present if t in may)
    out = jnp.zeros(uv.shape[:-1] + (3,), jnp.float32)
    for t in kinds:
        if t == TEX_CONSTANT:
            val = _eval_constant(params, uv)
        elif t == TEX_CHECKER:
            val = _eval_checker(params, uv)
        elif t == TEX_BITMAP:
            val = _eval_bitmap(table.data, params, uv, table.data4)
        elif t == TEX_DISK:
            val = _eval_disk(params, uv)
        elif t == TEX_BLADE:
            val = _eval_blade(params, uv)
        else:
            continue
        out = jnp.where((ttype == t)[..., None], val, out)
    return out


def texture_from_spec(spec, tex_builder, resolve_path=None):
    """JSON texture value -> table id (TextureFactory.cpp dispatch: scalar /
    rgb constants, strings = bitmap paths, dicts by "type")."""
    if isinstance(spec, str):
        from ...io.imageio import load_image

        if spec.lower().endswith(".ies"):
            from .ies import bake_ies_file

            img = bake_ies_file(resolve_path(spec) if resolve_path else spec)
            return tex_builder.add_bitmap(img, path_key=spec, clamp=True)
        img = load_image(resolve_path(spec) if resolve_path else spec)
        return tex_builder.add_bitmap(img, path_key=spec)
    if isinstance(spec, dict):
        t = spec.get("type")
        if t == "_prebuilt":
            # internal: a texture already registered with this builder
            # (mc-loader resource-pack atlas entries)
            return int(spec["id"])
        if t == "checker":
            return tex_builder.add_checker(
                spec.get("on_color", 0.8), spec.get("off_color", 0.2),
                spec.get("res_u", 20), spec.get("res_v", 20),
            )
        if t == "constant":
            return tex_builder.add_constant(spec.get("value", 1.0))
        if t == "bitmap":
            from ...io.imageio import load_image

            f = spec["file"]
            img = load_image(resolve_path(f) if resolve_path else f)
            return tex_builder.add_bitmap(img, path_key=f)
        if t == "disk":
            return tex_builder.add_disk(spec.get("value", 1.0))
        if t == "blade":
            return tex_builder.add_blade(
                spec.get("blades", 6), spec.get("angle", 0.593412),
                spec.get("value", 1.0),
            )
        if t == "ies":
            from .ies import bake_ies_file

            img = bake_ies_file(
                resolve_path(spec["file"]) if resolve_path else spec["file"],
                resolution=int(spec.get("resolution", 256)),
            )
            return tex_builder.add_bitmap(img, path_key=spec["file"], clamp=True)
        raise NotImplementedError(f"texture type {t}")
    return tex_builder.add_constant(spec)
