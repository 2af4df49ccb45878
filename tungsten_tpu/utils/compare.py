"""Image comparison metrics: MSE / RMSE (hdrmanip --mse/--rmse,
src/hdrmanip/hdrmanip.cpp:204-223) and SSIM (the BASELINE.json quality gate).

SSIM follows Wang et al. 2004 with the standard 11x11 gaussian window
(sigma 1.5), computed per channel on tonemapped [0,1] images and averaged.
Pure numpy — no skimage dependency in this image.
"""
from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(mse(a, b)))


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img, k):
    """Valid-mode 2D convolution per channel via sliding windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    chans = []
    for c in range(img.shape[2]):
        win = sliding_window_view(img[:, :, c], k.shape)
        chans.append(np.einsum("ijxy,xy->ij", win, k))
    return np.stack(chans, axis=-1)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    s_aa = _filter2(a * a, k) - mu_aa
    s_bb = _filter2(b * b, k) - mu_bb
    s_ab = _filter2(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


def golden_agreement(img: np.ndarray, ref: np.ndarray, f: int = 4):
    """Per-channel flux ratio of img over ref, and SSIM of the two after an
    f x f box downsample (which averages away per-pixel noise) and a
    gamma-2.2 tonemap: the comparison against the C++ reference renders."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)

    def down(a):
        h, w = a.shape[0] // f * f, a.shape[1] // f * f
        return a[:h, :w].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))

    def tm(a):
        return np.clip(np.power(np.clip(a, 0.0, None), 1.0 / 2.2), 0.0, 1.0)

    ratio = img.reshape(-1, 3).mean(0) / np.maximum(ref.reshape(-1, 3).mean(0), 1e-9)
    return ratio, ssim(tm(down(img)), tm(down(ref)))
