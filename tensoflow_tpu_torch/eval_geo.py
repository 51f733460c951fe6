"""Geometry-stage evaluation CLI of the port (counterpart of eval_geo.py).

    python -m tensoflow_tpu_torch.eval_geo --cfg configs/shape/syn/compressor.yaml \\
        [--ckpt PATH] [--max_views 100] [--save_dir DIR] [--device cpu] \\
        [key=value ...]

Opens the test split of the config's database (``isTest=True``), renders
each view at full resolution with a trained stage-1 model of the port
(default data/model/<name>/model.pkl), prints PSNR and SSIM per view and
the normal MAE where the split has normals, writes <vid>_pred.png
(default under data/nvs/<name>/) and appends the means to
data/metrics_record.txt in the reference's line format.  It runs on the
card; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def normalize_numpy(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--max_views', type=int, default=100)
    parser.add_argument('--save_dir', type=str, default=None)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' for the plain path (default: the card)")
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)

    from tensoflow_tpu_torch.config import load_config
    from tensoflow_tpu_torch.data import database as db_mod
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    from tensoflow_tpu_torch.eval import metrics
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer

    cfg = load_config(args.cfg, overrides=args.overrides)
    trainer = ShapeTrainer(cfg, device=args.device)
    ckpt_path = args.ckpt or os.path.join('data/model', cfg['name'],
                                          'model.pkl')
    trainer.load(ckpt_path)

    database = db_mod.parse_database_name(
        cfg['database_name'], cfg['dataset_dir'], isTest=True,
        isWhiteBG=cfg['isBGWhite'])
    ids = database.get_img_ids()[:args.max_views]
    save_dir = args.save_dir or os.path.join('data/nvs', cfg['name'])
    os.makedirs(save_dir, exist_ok=True)

    psnrs, ssims, maes = [], [], []
    for vid in ids:
        gt = database.get_image(vid).astype(np.float32) / 255.0
        pose = database.get_pose(vid)
        K = database.get_K(vid)
        h, w = gt.shape[:2]
        out = trainer.render_image(pose, K, h, w)
        pred = out['ray_rgb']
        psnrs.append(metrics.psnr(gt, pred))
        ssims.append(metrics.ssim(gt, pred))
        gt_n = database.get_normal(vid)
        if gt_n is not None:
            maes.append(metrics.normal_mae(normalize_numpy(gt_n),
                                           out['normal']))
        imwrite_png(os.path.join(save_dir, f'{vid}_pred.png'),
                    (np.clip(pred, 0, 1) * 255).astype(np.uint8))
        print(f'view {vid}: psnr={psnrs[-1]:.3f} ssim={ssims[-1]:.4f}'
              + (f' mae={maes[-1]:.3f}' if maes else ''), flush=True)

    msg = (f"{cfg['name']} geo: PSNR {np.mean(psnrs):.4f} "
           f"SSIM {np.mean(ssims):.4f}"
           + (f" NormalMAE {np.mean(maes):.4f}" if maes else ""))
    print(msg)
    os.makedirs('data', exist_ok=True)
    with open('data/metrics_record.txt', 'a') as f:
        f.write(msg + '\n')
    return {'psnr': psnrs, 'ssim': ssims, 'normal_mae': maes, 'line': msg}


if __name__ == '__main__':
    main()
