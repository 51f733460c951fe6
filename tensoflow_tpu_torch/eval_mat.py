"""Material-stage evaluation CLI of the port (counterpart of eval_mat.py).

    python -m tensoflow_tpu_torch.eval_mat --cfg configs/mat/syn/compressor.yaml \\
        [--ckpt PATH] [--run_nvs] [--extract_mats] [--relight --hdr ENV] \\
        [--max_views N] [--device cpu] [key=value ...]

Modes:
  --run_nvs:       render the test views (data/nvs/<name>/<id>_mat.png),
                   print PSNR / SSIM, append them to data/metrics_record.txt
  --extract_mats:  bake vertex materials onto the stage-1 mesh (the
                   config's ``mesh``) into data/materials/<name>/*.npy,
                   gamma-corrected, the albedo rescaled as ``albedoRescale``
                   asks (ref: eval_mat.py:114-134)
  --relight:       bake the vertex materials as --extract_mats does, then
                   write the Blender relight bundle for the environment
                   ``--hdr`` (eval/relight.run_blender_relight:
                   data/relight/<name>/) and run blender when one is on
                   PATH (ref: eval_mat.py:136-148)

The checkpoint is opened with MaterialTrainer.load's default, which (as in
the reference) restarts the flows and clears their frozen copies, so the
views render through the analytic pass only.  It runs on the card;
``--device cpu`` runs the plain PyTorch path.  PNGs are written by
``data/image_io.imwrite_png``, which needs no imaging package.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _srgb(x: np.ndarray) -> np.ndarray:
    from tensoflow_tpu_torch.ops.math import linear_to_srgb
    return linear_to_srgb(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def calc_albedo_rescale(trainer, cfg, n_samples: int = 20):
    """Median GT / predicted albedo ratio over ~n_samples test views
    (ref: eval_mat.py:19-60).  Returns (single_channel, three_channel).
    For tensoSDF scenes the GT 'albedo' is albedo * (1 - metallic), so the
    prediction is aligned the same way."""
    from tensoflow_tpu_torch.data import database as db_mod
    database = db_mod.parse_database_name(
        cfg['database_name'], cfg['dataset_dir'], isTest=True,
        isWhiteBG=cfg['isBGWhite'])
    database_type = cfg['database_name'].split('/')[0]
    ids = database.get_img_ids()
    interval = max(len(ids) // n_samples, 1)
    gt_l, pred_l = [], []
    for i, vid in enumerate(ids):
        if (i + 1) % interval:
            continue
        try:
            gt_albedo = database.get_albedo(vid)
        except NotImplementedError:
            gt_albedo = None
        if gt_albedo is None:
            continue
        h, w = gt_albedo.shape[:2]
        out = trainer.render_image(database.get_pose(vid),
                                   database.get_K(vid), h, w)
        pred = out['albedo']
        if database_type == 'tensoSDF':
            pred = pred * (1.0 - out['metallic'])
        mask = np.asarray(database.get_mask(vid)) > 0
        gt_l.append(np.asarray(gt_albedo)[mask])
        pred_l.append(np.asarray(pred)[mask])
    gt = np.concatenate(gt_l, 0)
    pred = np.concatenate(pred_l, 0).clip(min=1e-6)
    single = float(np.median((gt / pred)[..., 0]))
    three = np.median(gt / pred, axis=0)
    msg = (f'single channel rescale ratio: {single}, '
           f'three channels rescale ratio: {three}')
    print(msg)
    save_dir = os.path.join('data/nvs', cfg['name'])
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, 'albedoRescale_record.txt'), 'a') as f:
        f.write(msg + '\n')
    return single, three


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--run_nvs', action='store_true')
    parser.add_argument('--extract_mats', action='store_true')
    parser.add_argument('--relight', action='store_true')
    parser.add_argument('--hdr', type=str, default=None)
    parser.add_argument('--max_views', type=int, default=100)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' for the plain path (default: the card)")
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)

    from tensoflow_tpu_torch.config import load_config
    from tensoflow_tpu_torch.data import database as db_mod
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    from tensoflow_tpu_torch.eval import metrics, relight
    from tensoflow_tpu_torch.models import material_renderer as mr
    from tensoflow_tpu_torch.ops import mesh as mesh_mod
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

    cfg = load_config(args.cfg, overrides=args.overrides)
    trainer = MaterialTrainer(cfg, cfg['geo_model_path'], device=args.device)
    ckpt_path = args.ckpt or os.path.join('data/model', cfg['name'],
                                          'model.pkl')
    trainer.load(ckpt_path)
    result = {}

    if args.run_nvs:
        database = db_mod.parse_database_name(
            cfg['database_name'], cfg['dataset_dir'], isTest=True,
            isWhiteBG=cfg['isBGWhite'])
        trainer.database = database
        save_dir = os.path.join('data/nvs', cfg['name'])
        os.makedirs(save_dir, exist_ok=True)
        psnrs, ssims = [], []
        for vid in database.get_img_ids()[:args.max_views]:
            gt = database.get_image(vid).astype(np.float32) / 255.0
            h, w = gt.shape[:2]
            out = trainer.render_image(database.get_pose(vid),
                                       database.get_K(vid), h, w)
            key = 'rgb_pr_nis' if 'rgb_pr_nis' in out else 'rgb_pr'
            pred = out[key]
            if key == 'rgb_pr_nis':
                pred = pred + (1.0 - out['hit_mask'])
            psnrs.append(metrics.psnr(gt, pred))
            ssims.append(metrics.ssim(gt, pred))
            imwrite_png(os.path.join(save_dir, f'{vid}_mat.png'),
                        (np.clip(pred, 0, 1) * 255).astype(np.uint8))
            print(f'view {vid}: psnr={psnrs[-1]:.3f}', flush=True)
        msg = (f"{cfg['name']} mat: PSNR {np.mean(psnrs):.4f} "
               f"SSIM {np.mean(ssims):.4f}")
        print(msg)
        os.makedirs('data', exist_ok=True)
        with open('data/metrics_record.txt', 'a') as f:
            f.write(msg + '\n')
        result['psnr'], result['ssim'] = psnrs, ssims

    if args.extract_mats or args.relight:
        verts, _ = mesh_mod.read_ply(cfg['mesh'])
        mats = mr.predict_vertex_materials(trainer.params, trainer.rcfg,
                                           verts.astype(np.float32))
        albedo = mats['albedo']
        rescale_mode = cfg.get('albedoRescale', 0)
        if rescale_mode:
            single, three = calc_albedo_rescale(trainer, cfg)
            albedo = albedo * (single if rescale_mode == 1 else three)
        out_dir = os.path.join('data/materials', cfg['name'])
        os.makedirs(out_dir, exist_ok=True)
        # all three are gamma-corrected: the Blender backend stores them as
        # vertex colours, which Blender inverse-gamma-corrects on read
        # (ref: eval_mat.py:129-134)
        for name, v in (('albedo', albedo), ('metallic', mats['metallic']),
                        ('roughness', mats['roughness'])):
            np.save(os.path.join(out_dir, f'{name}.npy'), _srgb(v))
        print(f'materials saved to {out_dir}')
        result['materials'] = out_dir

    if args.relight:
        result['relight'] = relight.run_blender_relight(cfg, args.hdr)
    return result


if __name__ == '__main__':
    main()
