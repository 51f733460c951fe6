"""Validation metrics and tiled diagnostic dumps of the port (counterpart
of tensoflow_tpu/train/metrics_vis.py): PSNR / SSIM of a held-out render,
a tiled JPEG (gt | pred | normal | materials | lights) written to
data/train_vis/<name>-val/ where cv2 imports, as the JAX package does,
and ``ValidationEvaluator`` over a split.  ``resize_linear`` is the
validation downsample (cv2.resize with INTER_LINEAR in the JAX package)
computed without cv2.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..eval import metrics as m


def _to_u8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _tile(images: List[np.ndarray], cols: int = 4) -> np.ndarray:
    """Grid-tile same-height images; grayscale promoted to rgb."""
    imgs = []
    for im in images:
        if im is None:
            continue
        if im.ndim == 2:
            im = im[..., None]
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, -1)
        imgs.append(_to_u8(im[..., :3]))
    if not imgs:
        return np.zeros((1, 1, 3), np.uint8)
    h, w = imgs[0].shape[:2]
    rows = []
    for i in range(0, len(imgs), cols):
        row = imgs[i:i + cols]
        row += [np.zeros((h, w, 3), np.uint8)] * (cols - len(row))
        rows.append(np.concatenate(row, 1))
    return np.concatenate(rows, 0)


SHAPE_KEYS = ['ray_rgb', 'normal_vis', 'albedo', 'roughness', 'metallic',
              'occ_prob', 'occ_prob_gt', 'diffuse_color', 'specular_color',
              'diffuse_light', 'specular_light', 'indirect_light']
MAT_KEYS = ['rgb_pr', 'normal', 'albedo', 'roughness', 'metallic',
            'diffuse_color', 'specular_color', 'diffuse_light',
            'specular_light', 'visibility', 'indirect_light']


def _linear_taps(n_in: int, n_out: int):
    """Source indices and weights of cv2's INTER_LINEAR along one axis:
    half-pixel centres x = (d + 0.5) * n_in / n_out - 0.5, clamped to the
    first / last texel, two taps with the edge texel repeated."""
    x = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    x0 = np.floor(x).astype(np.int64)
    f = x - x0
    f = np.where(x0 < 0, 0.0, f)
    x0 = np.maximum(x0, 0)
    f = np.where(x0 >= n_in - 1, 0.0, f).astype(np.float32)
    x0 = np.minimum(x0, n_in - 1)
    return x0, np.minimum(x0 + 1, n_in - 1), f


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, C] float image resized to [h, w, C] by two-tap linear
    interpolation with half-pixel centres (the values cv2.resize gives
    with INTER_LINEAR)."""
    y0, y1, fy = _linear_taps(img.shape[0], h)
    x0, x1, fx = _linear_taps(img.shape[1], w)
    fy = fy[:, None, None]
    fx = fx[None, :, None]
    # along x first, then along y, each as a0 * (1 - f) + a1 * f: cv2's
    # order of operations
    cols = img[:, x0] * (1 - fx) + img[:, x1] * fx
    return (cols[y0] * (1 - fy) + cols[y1] * fy).astype(img.dtype)


def eval_and_dump(gt: np.ndarray, outputs: Dict[str, np.ndarray],
                  model_name: str, step: int, index: int,
                  keys: Optional[List[str]] = None,
                  pred_key: str = 'ray_rgb',
                  vis_dir: str = 'data/train_vis') -> Dict[str, float]:
    """PSNR/SSIM vs gt + the tiled diagnostic dump (ref: metrics.py:41-136).
    The dump is a diagnostic: without cv2 it is skipped."""
    keys = keys or SHAPE_KEYS
    pred = outputs[pred_key]
    results = {'psnr': m.psnr(gt, pred), 'ssim': m.ssim(gt, pred)}
    out_dir = os.path.join(vis_dir, f'{model_name}-val')
    os.makedirs(out_dir, exist_ok=True)
    tiled = _tile([gt] + [outputs.get(k) for k in keys if k in outputs])
    try:
        import cv2
    except ImportError:
        return results
    cv2.imwrite(os.path.join(out_dir, f'step{step}-{index}.jpg'),
                tiled[..., ::-1])
    return results


class ValidationEvaluator:
    """Accumulate metric dicts over a val split, pick the key metric
    (ref: train/train_valid.py:18-51)."""

    def __init__(self, key_metric_name: str = 'psnr'):
        self.key_metric_name = key_metric_name

    def __call__(self, render_fn, val_ids, database, model_name: str,
                 step: int, downsample: float = 1.0):
        agg: Dict[str, List[float]] = {}
        for i, vid in enumerate(val_ids):
            gt = database.get_image(vid).astype(np.float32) / 255.0
            K = database.get_K(vid).copy()
            pose = database.get_pose(vid)
            h, w = gt.shape[:2]
            if downsample != 1.0:
                h, w = int(h * downsample), int(w * downsample)
                gt = resize_linear(gt, h, w)
                K = np.diag([downsample, downsample, 1.0]).astype(
                    np.float32) @ K
            outputs = render_fn(pose, K, h, w)
            pred_key = 'ray_rgb' if 'ray_rgb' in outputs else 'rgb_pr'
            res = eval_and_dump(gt, outputs, model_name, step, i,
                                pred_key=pred_key)
            for k, v in res.items():
                agg.setdefault(k, []).append(v)
        means = {k: float(np.mean(v)) for k, v in agg.items()}
        return means, means.get(self.key_metric_name, 0.0)
