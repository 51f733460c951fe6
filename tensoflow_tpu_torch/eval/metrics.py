"""Image metrics of the port (counterpart of tensoflow_tpu/eval/metrics.py:
psnr and ssim, self-contained numpy; the JAX package's LPIPS, Chamfer and
HDR metrics are not ported yet)."""
from __future__ import annotations

import numpy as np


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((gt.astype(np.float64)
                         - pred.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(data_range ** 2 / max(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    k = np.exp(-x ** 2 / (2 * sigma ** 2))
    return k / k.sum()


def ssim(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    """Gaussian-weighted SSIM, skimage-compatible defaults (win 11,
    sigma 1.5). Accepts [H,W] or [H,W,C]; returns the mean over channels
    of the map without its 5-pixel border."""
    gt = gt.astype(np.float64)
    pred = pred.astype(np.float64)
    if gt.ndim == 2:
        gt, pred = gt[..., None], pred[..., None]
    k = _gaussian_window()

    def blur(img):
        out = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode='same'), 0, img)
        return np.apply_along_axis(
            lambda r: np.convolve(r, k, mode='same'), 1, out)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(gt.shape[-1]):
        x, y = gt[..., c], pred[..., c]
        mx, my = blur(x), blur(y)
        mxx, myy, mxy = blur(x * x), blur(y * y), blur(x * y)
        vx = mxx - mx * mx
        vy = myy - my * my
        cxy = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)
             / ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2)))
        pad = 5
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))
