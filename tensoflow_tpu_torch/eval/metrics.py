"""Metrics of the port (counterpart of tensoflow_tpu/eval/metrics.py):
psnr, ssim, normal_mae, chamfer_distance and scale_invariant_psnr_hdr,
self-contained numpy (scipy's cKDTree for Chamfer); LPIPS is not ported
yet."""
from __future__ import annotations

from typing import Optional

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


def normal_mae(gt_normals: np.ndarray, pred_normals: np.ndarray,
               mask: Optional[np.ndarray] = None) -> float:
    """Mean angular error in degrees (ref: trainer_inv.py:327-330)."""
    def norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-8)
    cos = np.clip(np.sum(norm(gt_normals) * norm(pred_normals), -1), -1, 1)
    ang = np.arccos(cos) * 180.0 / np.pi
    if mask is not None:
        return float(ang[mask > 0.5].mean())
    return float(ang.mean())


def chamfer_distance(pts_a: np.ndarray, pts_b: np.ndarray,
                     bidirectional: bool = True) -> float:
    """Bidirectional mean Chamfer via KD-trees (ref: eval_orb_shape.py:42-96)."""
    from scipy.spatial import cKDTree
    d_ab = cKDTree(pts_b).query(pts_a, k=1)[0]
    if not bidirectional:
        return float(d_ab.mean())
    d_ba = cKDTree(pts_a).query(pts_b, k=1)[0]
    return float(0.5 * (d_ab.mean() + d_ba.mean()))


def scale_invariant_psnr_hdr(gt: np.ndarray, pred: np.ndarray,
                             mask: Optional[np.ndarray] = None) -> float:
    """ORB relight protocol: per-channel least-squares scale before PSNR
    (ref: eval_orb_relight.py:64-80)."""
    gt = gt.astype(np.float64)
    pred = pred.astype(np.float64)
    if mask is not None:
        m = mask > 0.5
        gt_m = gt[m]
        pr_m = pred[m]
    else:
        gt_m = gt.reshape(-1, gt.shape[-1])
        pr_m = pred.reshape(-1, pred.shape[-1])
    scales = []
    for c in range(gt_m.shape[-1]):
        denom = float(np.sum(pr_m[:, c] ** 2))
        scales.append(float(np.sum(pr_m[:, c] * gt_m[:, c]))
                      / max(denom, 1e-12))
    pred_s = pred * np.asarray(scales)[None, None, :]
    mse = float(np.mean((gt - pred_s) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))
