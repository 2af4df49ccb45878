"""NFOR denoiser — the complete pipeline (Bitterli et al. 2016).

Feature-parity port of the reference denoiser's algorithm
(src/denoiser/denoiser.cpp:38-133 nforDenoiser, NlMeans.hpp:46-157
nlMeansWeights/nlMeans, Regression.cpp:14-140 collaborativeRegression),
re-designed for array execution: where the reference dices the image into
32x32 tiles and runs per-pixel Eigen QR solves on a thread pool, this
implementation loops over the (2R+1)^2 window SHIFTS and accumulates the
weighted normal equations as whole-image maps, ending in one batched
(H*W, d, d) Cholesky solve — the natural wavefront/Wavefront formulation of the
same math (no per-pixel control flow, every step a fused elementwise map).

Pipeline stages (names match the paper sections cited in denoiser.cpp):
  5.1 feature cross-prefiltering: NL-means with buffer A guided by B and
      vice versa (F=3, R=5, k=0.5, varianceScale=2).
  5.2 main regression, k in {0.5, 1.0}: collaborative first-order fit of
      half buffer A on B's prefiltered features with NL-means weights.
  5.3 MSE estimation + per-channel selection map between the two k's,
      both NL-means-filtered (F=1, R=9, k=1).
  5.4 second filter pass: combined features re-filtered, final regression
      of the combined selected result on them.

All arrays are (H, W, C) float32/64 numpy. Weighted LS uses a ridge of
1e-4 * trace/d on the normal matrix (colPivHouseholderQr's rank handling
analog — the features are centered so the system is near-singular on flat
regions).
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-7
_MIN_CENTER_WEIGHT = 1e-4
_DIST_CLAMP = 10000.0


def _box_mean(img, r):
    """Edge-normalized box mean over (2r+1)^2 windows (BoxFilter.hpp:11-37
    semantics: mean over in-bounds taps)."""
    h, w = img.shape[:2]
    ii = np.zeros((h + 1, w + 1) + img.shape[2:], np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    y0 = np.clip(np.arange(h) - r, 0, h)
    y1 = np.clip(np.arange(h) + r + 1, 0, h)
    x0 = np.clip(np.arange(w) - r, 0, w)
    x1 = np.clip(np.arange(w) + r + 1, 0, w)
    s = ii[y1][:, x1] - ii[y0][:, x1] - ii[y1][:, x0] + ii[y0][:, x0]
    cnt = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float64)
    return s / cnt.reshape(h, w, *([1] * (img.ndim - 2)))


def _shifted(img, dx, dy):
    """img translated by (+dx, +dy) pixel lookups: out[y, x] = img[y+dy, x+dx]
    where in bounds, else 0; plus the validity mask."""
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    msk = np.zeros((h, w), bool)
    ys0, ys1 = max(0, -dy), min(h, h - dy)
    xs0, xs1 = max(0, -dx), min(w, w - dx)
    if ys0 >= ys1 or xs0 >= xs1:
        return out, msk
    out[ys0:ys1, xs0:xs1] = img[ys0 + dy : ys1 + dy, xs0 + dx : xs1 + dx]
    msk[ys0:ys1, xs0:xs1] = True
    return out, msk


def _nl_dist(guide, variance, dx, dy, k, variance_scale, F):
    """Per-pixel patchwise NL-means distance to the (dx, dy) neighbor and its
    validity mask (NlMeans.hpp:70-83: Rousselle modified distance, box-
    filtered over the (2F+1)^2 patch)."""
    gq, mq = _shifted(guide, dx, dy)
    vq, _ = _shifted(variance, dx, dy)
    vp = variance * variance_scale
    vq = vq * variance_scale
    sq = (guide - gq) ** 2 - (vp + np.minimum(vp, vq))
    dist = sq / ((vp + vq) * (k * k) + _EPS)
    dist = np.minimum(dist, _DIST_CLAMP)
    # patch average ONLY over taps whose own shift is valid: the reference
    # clips the shifted rect before the box filter, zeros outside
    dist = np.where(mq[..., None], dist, 0.0)
    dist = _box_mean(dist, F)
    return dist, mq


def _nl_weight(guide, variance, dx, dy, k, variance_scale, F, scalar=False):
    dist, mq = _nl_dist(guide, variance, dx, dy, k, variance_scale, F)
    wgt = np.exp(-np.maximum(dist, 0.0))
    if scalar:
        wgt = wgt.min(axis=-1)  # convertWeight(float, Vec3f) = in.min()
    else:
        mq = mq[..., None]
    if dx == 0 and dy == 0:
        wgt = np.maximum(wgt, _MIN_CENTER_WEIGHT)
    return np.where(mq, wgt, 0.0)


def nl_means(image, guide, variance, F, R, k, variance_scale=1.0):
    """NL-means filter (NlMeans.hpp:96-157): weights from `guide`/`variance`,
    values from `image`. All (H, W, C); per-channel weights."""
    image = np.asarray(image, np.float64)
    guide = np.asarray(guide, np.float64)
    variance = np.asarray(variance, np.float64)
    acc = np.zeros_like(image)
    wacc = np.zeros_like(image)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            wgt = _nl_weight(guide, variance, dx, dy, k, variance_scale, F)
            iq, _ = _shifted(image, dx, dy)
            acc += wgt * iq
            wacc += wgt
    return acc / np.maximum(wacc, 1e-30)


def collaborative_regression(image, guide, features, variance, F, R, k):
    """First-order collaborative regression (Regression.cpp:14-140).

    image/guide/variance: (H, W, 3); features: (H, W, NF) prefiltered.
    Per pixel p, fit  y_q ~ beta . x_q  over the (2R+1)^2 window with
    x_q = [1, dx, dy, f_q - f_p] and NL-means weights w_pq from the guide
    (varianceScale=2, scalar-converted); every window's prediction for
    pixel q is averaged with weight w_pq (overlapping-model averaging).
    """
    image = np.asarray(image, np.float64)
    h, w = image.shape[:2]
    f = np.asarray(features, np.float64)
    nf = f.shape[-1]
    d = nf + 3

    shifts = [(dx, dy) for dy in range(-R, R + 1) for dx in range(-R, R + 1)]
    # Pass 1: accumulate normal equations A(p) = sum_q w x x^T, b(p) = sum w x y^T
    A = np.zeros((h, w, d, d))
    B = np.zeros((h, w, d, 3))
    wgts = []
    for dx, dy in shifts:
        wgt = _nl_weight(guide, variance, dx, dy, k, 2.0, F, scalar=True)
        wgts.append(wgt)
        fq, _ = _shifted(f, dx, dy)
        yq, _ = _shifted(image, dx, dy)
        x = np.empty((h, w, d))
        x[..., 0] = 1.0
        x[..., 1] = dx
        x[..., 2] = dy
        x[..., 3:] = fq - f
        wx = wgt[..., None] * x
        A += wx[..., :, None] * x[..., None, :]
        B += wx[..., :, None] * yq[..., None, :]

    # ridge: the centered features make A rank-deficient on flat regions
    tr = np.trace(A, axis1=-2, axis2=-1)
    A += (1e-4 * tr[..., None, None] / d + 1e-12) * np.eye(d)
    try:
        beta = np.linalg.solve(A, B)  # (H, W, d, 3)
    except np.linalg.LinAlgError:
        beta = np.linalg.solve(A + 1e-6 * np.eye(d), B)

    # Pass 2: scatter each window's prediction to its member pixels.
    # Prediction of window p for pixel q = p + delta:  beta(p) . x_delta(p).
    # Gather form at q: out[q] += w(q-delta) * pred(q-delta, delta), i.e.
    # shift the window-centered maps by -delta.
    acc = np.zeros((h, w, 3))
    wacc = np.zeros((h, w, 1))
    for (dx, dy), wgt in zip(shifts, wgts):
        fq, _ = _shifted(f, dx, dy)
        x = np.empty((h, w, d))
        x[..., 0] = 1.0
        x[..., 1] = dx
        x[..., 2] = dy
        x[..., 3:] = fq - f
        pred = np.einsum("hwd,hwdc->hwc", x, beta)
        contrib, _ = _shifted(wgt[..., None] * pred, -dx, -dy)
        wq, _ = _shifted(wgt[..., None], -dx, -dy)
        acc += contrib
        wacc += wq
    return acc / np.maximum(wacc, 1e-30)


def nfor(color_a, color_b, color_var, features):
    """Full NFOR (denoiser.cpp:38-133).

    color_a/color_b: the two half buffers (H, W, 3); color_var: sample
    variance of the MEAN (H, W, 3); features: list of dicts with keys
    buffer_a, buffer_b, variance — each (H, W, C) (C = 3 for albedo/normal,
    1 for depth); channels are filtered independently like the reference's
    slicePixmap.
    """
    color_a = np.asarray(color_a, np.float64)
    color_b = np.asarray(color_b, np.float64)
    color_var = np.asarray(color_var, np.float64)
    image = 0.5 * (color_a + color_b)
    h, w = image.shape[:2]

    # 5.1 feature cross-prefiltering (denoiser.cpp:42-53): A guided by B
    filt_a, filt_b = [], []
    for ft in features:
        fa = np.asarray(ft["buffer_a"], np.float64).reshape(h, w, -1)
        fb = np.asarray(ft["buffer_b"], np.float64).reshape(h, w, -1)
        fv = np.asarray(ft["variance"], np.float64).reshape(h, w, -1)
        filt_a.append(nl_means(fa, fb, fv, 3, 5, 0.5, variance_scale=2.0))
        filt_b.append(nl_means(fb, fa, fv, 3, 5, 0.5, variance_scale=2.0))
    feats_a = np.concatenate(filt_a, axis=-1) if filt_a else np.zeros((h, w, 0))
    feats_b = np.concatenate(filt_b, axis=-1) if filt_b else np.zeros((h, w, 0))

    # 5.2 main regression for k in {0.5, 1.0} + 5.3 MSE estimation
    cand_a, cand_b, mses = [], [], []
    for k in (0.5, 1.0):
        fca = collaborative_regression(color_a, color_b, feats_b, color_var, 3, 9, k)
        fcb = collaborative_regression(color_b, color_a, feats_a, color_var, 3, 9, k)
        mse_a = (color_b - fca) ** 2 - 2.0 * color_var
        mse_b = (color_a - fcb) ** 2 - 2.0 * color_var
        resid = (fcb - fca) ** 2 * 0.25
        noisy_mse = 0.5 * (mse_a + mse_b) - resid
        cand_a.append(fca)
        cand_b.append(fcb)
        mses.append(nl_means(noisy_mse, image, color_var, 1, 9, 1.0, 1.0))

    # 5.3 selection map: 0 -> k=0.5, 1 -> k=1.0, per channel, NL-filtered
    noisy_sel = (mses[0] >= mses[1]).astype(np.float64)
    sel = nl_means(noisy_sel, image, color_var, 1, 9, 1.0, 1.0)
    result_a = cand_a[0] * (1.0 - sel) + cand_a[1] * sel
    result_b = cand_b[0] * (1.0 - sel) + cand_b[1] * sel

    # 5.4 second filter pass (denoiser.cpp:107-132)
    final_feats = []
    for fa_, fb_ in zip(filt_a, filt_b):
        comb = 0.5 * (fa_ + fb_)
        comb_var = (fb_ - fa_) ** 2 * 0.25
        final_feats.append(nl_means(comb, comb, comb_var, 3, 2, 0.5))
    ff = (
        np.concatenate(final_feats, axis=-1)
        if final_feats
        else np.zeros((h, w, 0))
    )
    comb_res = 0.5 * (result_a + result_b)
    comb_var = (result_b - result_a) ** 2 * 0.25
    return collaborative_regression(comb_res, comb_res, ff, comb_var, 3, 9, 1.0)
