"""Image IO: PFM, Radiance .hdr and PNG output in numpy/zlib; other LDR
formats (png/jpg/tga/bmp input) through PIL and .exr through OpenCV, both
imported only when such a file is met.

Mirrors src/core/io/ImageIO.cpp capabilities. Loaded images are numpy float32
RGB in scanline order (row 0 = top), linearized: LDR sources get the sRGB/2.2
gamma removed when requested (BitmapTexture applies gamma on load).
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

HDR_EXTS = {".hdr", ".exr", ".pfm"}


def _optional(module: str, package: str, path: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise ImportError(
            f"reading or writing {os.path.basename(path)!r} needs the "
            f"{package!r} package, which is not installed"
        ) from e


def load_rgbe(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE, flat or new-style run-length scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while True:  # header lines end at an empty line
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise IOError(f"{path}: unsupported format {line.decode()}")
    end = data.index(b"\n", pos)
    m = re.fullmatch(rb"-Y (\d+) \+X (\d+)", data[pos:end].strip())
    if m is None:
        raise IOError(f"{path}: unsupported orientation {data[pos:end]!r}")
    h, w = int(m.group(1)), int(m.group(2))
    buf = np.frombuffer(data, np.uint8, offset=end + 1)
    rgbe = np.empty((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        rle = (8 <= w < 0x8000 and buf[p] == 2 and buf[p + 1] == 2
               and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w)
        if not rle:
            rgbe[y] = buf[p:p + 4 * w].reshape(w, 4)
            p += 4 * w
            continue
        p += 4
        for c in range(4):
            x = 0
            while x < w:
                n = int(buf[p])
                if n > 128:  # run of one byte
                    n -= 128
                    rgbe[y, x:x + n, c] = buf[p + 1]
                    p += 2
                else:  # literal bytes
                    rgbe[y, x:x + n, c] = buf[p + 1:p + 1 + n]
                    p += 1 + n
                x += n
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def save_rgbe(path: str, img: np.ndarray) -> None:
    """Radiance .hdr with flat (not run-length encoded) scanlines."""
    img = np.maximum(np.asarray(img, np.float32)[..., :3], 0.0)
    h, w = img.shape[:2]
    peak = img.max(axis=-1)
    mant, e = np.frexp(peak)
    scale = np.where(peak > 1e-32, mant * 256.0 / np.maximum(peak, 1e-38), 0.0)
    rgbe = np.empty((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(peak > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def encode_png(u8: np.ndarray) -> bytes:
    """8-bit RGB PNG bytes, unfiltered scanlines in one zlib stream."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    h, w = u8.shape[:2]

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, 3 * w)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def is_hdr(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in HDR_EXTS


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        channels = 3 if header == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, channels)[::-1]  # PFM is bottom-up
    return np.ascontiguousarray(img, np.float32)


def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def load_image(path: str, gamma_correct: bool = True) -> np.ndarray:
    """Load any supported image as float32 RGB (H, W, 3), linear radiometry."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        img = load_pfm(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img
    if ext == ".hdr":
        return load_rgbe(path)
    if ext == ".exr":
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        cv2 = _optional("cv2", "opencv-python", path)
        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
        if img is None:
            raise IOError(f"failed to load image: {path}")
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        else:
            img = img[..., ::-1]  # BGR -> RGB
        return np.ascontiguousarray(img, np.float32)
    Image = _optional("PIL.Image", "Pillow", path).Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        img = np.asarray(im, np.float32) / 255.0
    if gamma_correct:
        # BitmapTexture linearizes LDR input with gamma 2.2
        img = img**2.2
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Save float32 RGB. LDR formats expect tonemapped [0,1] values and use
    the reference's quantization (floor to int, Integrator.cpp:writeBuffers)."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".pfm":
        save_pfm(path, img)
    elif ext == ".hdr":
        save_rgbe(path, img)
    elif ext == ".exr":
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        cv2 = _optional("cv2", "opencv-python", path)
        ok = cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
        if not ok:
            raise IOError(f"failed to save image: {path}")
    else:
        u8 = np.clip((img * 255.0).astype(np.int32), 0, 255).astype(np.uint8)
        if ext == ".png":
            with open(path, "wb") as f:
                f.write(encode_png(u8))
        else:
            Image = _optional("PIL.Image", "Pillow", path).Image
            Image.fromarray(u8, "RGB").save(path)
