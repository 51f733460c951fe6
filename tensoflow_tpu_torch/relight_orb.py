"""Relighting CLI of the port (counterpart of relight_orb.py): a trained
material model re-shaded under a new environment map.

    python -m tensoflow_tpu_torch.relight_orb --cfg configs/mat/syn/compressor.yaml \\
        --hdr ENV.{hdr,exr,png} [--out DIR] [--blender] [--device cpu] \\
        [key=value ...]

Loads data/model/<name>/model.pkl, reads the equirectangular environment
(Radiance .hdr, OpenEXR or PNG / JPEG, by its first bytes; an image whose
largest value is above 2 is taken as 0-255 and divided by 255, as the
reference does), converts it to a 64^2 cubemap, and relights the first 8
test views with eval/relight.relight_direct: rays in chunks of 4096,
trace_surface, 128 cosine-sampled light directions a hit with
sphere-traced visibility, one azimuth roll a point drawn from the
trainer's generator.  Misses stay white.  Writes <out>/relit_<id>.png
(default out: data/relight/<name>), 8-bit by truncation as the
reference's cv2.imwrite of ``(clip(img, 0, 1) * 255).astype(uint8)``.
``--blender`` writes the Blender bundle instead (eval/relight.
run_blender_relight).  Runs on the card; ``--device cpu`` runs the plain
PyTorch path.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

CHUNK = 4096
N_VIEWS = 8
ENV_RES = 64


def load_env_cube(path: str, device, res: int = ENV_RES):
    """[6, res, res, 3] cubemap of the environment image at ``path``."""
    from tensoflow_tpu_torch.data.image_io import read_env_map
    from tensoflow_tpu_torch.ops.cubemap import latlong_to_cubemap
    env = read_env_map(path)
    if env.max() > 2.0:
        env = env / 255.0
    return latlong_to_cubemap(
        torch.as_tensor(np.ascontiguousarray(env[..., :3]), device=device),
        res)


@torch.no_grad()
def relight_view(trainer, env_cube, pose, K, h: int, w: int, rolls=None,
                 chunk: int = CHUNK, n_samples: int = 128, rows=None,
                 secondary: bool = False):
    """One view relit: primary rays (construct_ray_batch_nerf) in chunks
    of ``chunk``, trace_surface, then relight_direct on the chunk's
    surface points with -d as the view.  ``rolls`` is a list of [n,1,1]
    azimuth rolls, one a chunk (None: drawn from ``trainer.gen``);
    ``rows=(r0, r1)`` renders that band of rows only.  Returns 'rgb'
    [rows, w, 3] float32 (white where no surface is hit) and 'hit'
    [rows, w] bool, on the host; with ``secondary`` also
    'secondary_hits' [rows * w, n_samples] bool, each light ray's hit."""
    from tensoflow_tpu_torch.data import rays as rays_mod
    from tensoflow_tpu_torch.eval.relight import relight_direct
    from tensoflow_tpu_torch.models import material_renderer as mr
    r0, r1 = rows or (0, h)
    info = {'imgs': np.zeros((1, h, w, 3), np.float32),
            'Ks': np.asarray(K, np.float32)[None],
            'poses': np.asarray(pose, np.float32)[None]}
    batch = rays_mod.construct_ray_batch_nerf(info)[0]
    dev = trainer.device
    o_all, d_all = (torch.as_tensor(batch[k][r0 * w:r1 * w], device=dev)
                    for k in ('rays_o', 'dirs'))
    n = o_all.shape[0]
    aabb = mr.aabb_tensor(trainer.rcfg, dev)
    us = mr.unit_size(trainer.rcfg)
    rgb = torch.ones((n, 3), device=dev)
    hits = torch.zeros((n,), dtype=torch.bool, device=dev)
    sec = []
    for ci, ri in enumerate(range(0, n, chunk)):
        o, d = o_all[ri:ri + chunk], d_all[ri:ri + chunk]
        inters, normals, _, hit = mr.trace_surface(
            trainer.geo_params, trainer.rcfg, trainer.grid, o, d)
        roll = (torch.rand((o.shape[0], 1, 1), generator=trainer.gen,
                           device=dev) if rolls is None
                else torch.as_tensor(rolls[ci], device=dev))
        colors, sec_hit = relight_direct(
            trainer.params, trainer.rcfg.shader, trainer.grid, us, aabb,
            inters, normals, env_cube, -d, roll=roll, n_samples=n_samples,
            return_hits=True)
        if secondary:
            sec.append(sec_hit)
        rgb[ri:ri + chunk] = torch.where(hit[:, None], colors,
                                         rgb[ri:ri + chunk])
        hits[ri:ri + chunk] = hit
    out = {'rgb': rgb.reshape(r1 - r0, w, 3).cpu().numpy(),
           'hit': hits.reshape(r1 - r0, w).cpu().numpy()}
    if secondary:
        out['secondary_hits'] = torch.cat(sec).cpu().numpy()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg', type=str, required=True)
    parser.add_argument('--hdr', type=str, required=True,
                        help='equirectangular HDR/LDR environment image')
    parser.add_argument('--blender', action='store_true')
    parser.add_argument('--out', type=str, default=None)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' for the plain path (default: the card)")
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)

    from tensoflow_tpu_torch.config import load_config
    from tensoflow_tpu_torch.data import database as db_mod
    from tensoflow_tpu_torch.data.image_io import imwrite_png
    from tensoflow_tpu_torch.eval import relight as relight_mod
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

    cfg = load_config(args.cfg, overrides=args.overrides)
    trainer = MaterialTrainer(cfg, cfg['geo_model_path'], device=args.device)
    trainer.load(os.path.join('data/model', cfg['name'], 'model.pkl'))
    if args.blender:
        return relight_mod.run_blender_relight(cfg, args.hdr)

    env_cube = load_env_cube(args.hdr, trainer.device)
    database = db_mod.parse_database_name(
        cfg['database_name'], cfg['dataset_dir'], isTest=True,
        isWhiteBG=cfg['isBGWhite'])
    out_dir = args.out or os.path.join('data/relight', cfg['name'])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for vid in database.get_img_ids()[:N_VIEWS]:
        h, w = database.get_image(vid).shape[:2]
        img = relight_view(trainer, env_cube, database.get_pose(vid),
                           database.get_K(vid), h, w)['rgb']
        path = os.path.join(out_dir, f'relit_{vid}.png')
        imwrite_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        written.append(path)
        print(f'relit view {vid}', flush=True)
    return written


if __name__ == '__main__':
    main()
