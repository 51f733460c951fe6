"""Metrics of the port (counterpart of tensoflow_tpu/eval/metrics.py):
psnr, ssim, normal_mae, chamfer_distance and scale_invariant_psnr_hdr,
self-contained numpy (scipy's cKDTree for Chamfer), and LPIPS (lpips-0.1,
VGG16) from a weights bundle the user provides.

LPIPS needs trained weights, which nothing here downloads: ``lpips``
returns None without ``tensoflow_tpu_torch/assets/lpips_vgg16.npz``.  The
JAX package falls back to torchvision's pretrained VGG16 there, a
download; the port has no such fallback."""
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


_LPIPS_EXACT = None

# lpips-0.1 VGG16 topology: (conv_index_in_torchvision_features, out_ch);
# feature taps after relu1_2/2_2/3_3/4_3/5_3, max-pool between groups.
_VGG_PLAN = [(0, 64), (2, 64), 'pool', (5, 128), (7, 128), 'pool',
             (10, 256), (12, 256), (14, 256), 'pool',
             (17, 512), (19, 512), (21, 512), 'pool',
             (24, 512), (26, 512), (28, 512)]
_VGG_TAPS = {2, 7, 14, 21, 28}  # conv ids whose relu output is a tap
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _lpips_weights_path() -> str:
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, 'assets', 'lpips_vgg16.npz')


def lpips_exact(gt: np.ndarray, pred: np.ndarray,
                weights=None) -> Optional[float]:
    """Exact lpips-0.1 (VGG16 backbone + learned 1x1 linear heads) on the
    CPU, from a weights bundle: ``features.{i}.weight`` [O,I,3,3] /
    ``features.{i}.bias`` [O] for each conv index of torchvision's
    vgg16().features, and ``lin{k}.weight`` [1,C,1,1] for the 5 heads
    (the tensors of ``lpips.LPIPS(net='vgg')`` exported with numpy).
    ``weights`` defaults to assets/lpips_vgg16.npz; None when it is absent.

    gt/pred: [H,W,3] float in [0,1]."""
    global _LPIPS_EXACT
    import os
    import torch
    import torch.nn.functional as F
    if weights is None:
        path = _lpips_weights_path()
        if _LPIPS_EXACT is None:
            if not os.path.exists(path):
                return None
            _LPIPS_EXACT = dict(np.load(path))
        weights = _LPIPS_EXACT

    def prep(img):
        x = img.astype(np.float32).transpose(2, 0, 1)[None]   # [1,3,H,W]
        x = 2.0 * x - 1.0                                     # [-1, 1]
        return torch.from_numpy(
            (x - _LPIPS_SHIFT.reshape(1, 3, 1, 1))
            / _LPIPS_SCALE.reshape(1, 3, 1, 1))

    def vgg_taps(x):
        taps = []
        for item in _VGG_PLAN:
            if item == 'pool':
                x = F.max_pool2d(x, 2, 2)
                continue
            i, _ = item
            w = torch.from_numpy(np.asarray(weights[f'features.{i}.weight'],
                                            np.float32))
            b = torch.from_numpy(np.asarray(weights[f'features.{i}.bias'],
                                            np.float32))
            x = torch.relu(F.conv2d(x, w, padding=1) + b.reshape(1, -1, 1, 1))
            if i in _VGG_TAPS:
                taps.append(x)
        return taps

    with torch.no_grad():
        ta, tb = vgg_taps(prep(gt)), vgg_taps(prep(pred))
        dist = 0.0
        for k, (fa, fb) in enumerate(zip(ta, tb)):
            na = fa / torch.sqrt(torch.sum(fa ** 2, 1, keepdim=True) + 1e-10)
            nb = fb / torch.sqrt(torch.sum(fb ** 2, 1, keepdim=True) + 1e-10)
            lin = torch.from_numpy(np.asarray(weights[f'lin{k}.weight'],
                                              np.float32)).reshape(1, -1, 1, 1)
            dist = dist + torch.mean(torch.sum((na - nb) ** 2 * lin, 1))
    return float(dist)


def lpips(gt: np.ndarray, pred: np.ndarray) -> Optional[float]:
    """LPIPS perceptual distance (ref: base_utils.py:52-66): lpips_exact
    from the bundle, None without it (no download, see the module
    docstring)."""
    return lpips_exact(gt, pred)
