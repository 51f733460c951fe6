"""ORB relighting evaluation CLI of the port (counterpart of
eval_orb_relight.py): relit renders against ground-truth relit captures,
scale-invariant HDR PSNR (per-channel least-squares scale) within an
eroded mask, SSIM, and LPIPS where its weights bundle is present.

    python -m tensoflow_tpu_torch.eval_orb_relight --pred_dir DIR \\
        --gt_dir DIR [--mask_dir DIR]

Each <pred_dir>/*.png with a namesake in gt_dir is scored; prints one line
a view and the means, and appends the means to data/metrics_record.txt.
The files are read as the reference's cv2.imread reads them
(data/image_io.imread_cv2: RGB with alpha dropped, masks through cv2's
grey conversion), and masks eroded as its cv2.erode erodes them.  Host
numpy only: no device.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def erode_mask(mask: np.ndarray, iters: int = 1) -> np.ndarray:
    """Binary erosion with a 3x3 square, as cv2.erode with its default
    border: outside the image counts as set, so pixels at the edge erode
    only from inside."""
    m = np.asarray(mask).astype(bool)
    h, w = m.shape
    for _ in range(iters):
        p = np.pad(m, 1, constant_values=True)
        m = np.logical_and.reduce([p[dy:dy + h, dx:dx + w]
                                   for dy in range(3) for dx in range(3)])
    return m


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pred_dir', type=str, required=True)
    parser.add_argument('--gt_dir', type=str, required=True)
    parser.add_argument('--mask_dir', type=str, default=None)
    args = parser.parse_args(argv)

    from tensoflow_tpu_torch.data.image_io import imread_cv2
    from tensoflow_tpu_torch.eval import metrics

    preds = sorted(glob.glob(os.path.join(args.pred_dir, '*.png')))
    psnrs, ssims, lpipss = [], [], []
    for p in preds:
        name = os.path.basename(p)
        g = os.path.join(args.gt_dir, name)
        if not os.path.exists(g):
            continue
        pred = imread_cv2(p).astype(np.float32) / 255.0
        gt = imread_cv2(g).astype(np.float32) / 255.0
        mask = None
        if args.mask_dir:
            m = os.path.join(args.mask_dir, name)
            if os.path.exists(m):
                mask = erode_mask(imread_cv2(m, grey=True) > 127)
        psnrs.append(metrics.scale_invariant_psnr_hdr(gt, pred, mask))
        ssims.append(metrics.ssim(gt, pred))
        lp = metrics.lpips(gt, pred)
        if lp is not None:
            lpipss.append(lp)
        print(f'{name}: si-psnr={psnrs[-1]:.3f}', flush=True)

    msg = (f'relight: SI-PSNR {np.mean(psnrs):.4f} SSIM {np.mean(ssims):.4f}'
           + (f' LPIPS {np.mean(lpipss):.4f}' if lpipss else ''))
    print(msg)
    os.makedirs('data', exist_ok=True)
    with open('data/metrics_record.txt', 'a') as f:
        f.write(msg + '\n')
    return msg


if __name__ == '__main__':
    main()
