"""Mesh extraction CLI of the port (counterpart of extract_mesh.py).

    python -m tensoflow_tpu_torch.extract_mesh --cfg configs/shape/syn/compressor_occ.yaml \\
        [--ckpt PATH] [--resolution 512] [--output PATH] [--device cpu] [key=value ...]

Loads a stage-1 checkpoint of the port, samples the SDF on the card at the
config's ``blend_ratio`` mip level over a dense grid in [-1, 1]^3 (chunks
of 262,144 points), runs marching tetrahedra on the host and writes a PLY
(default data/meshes/<name>-<step>.ply).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

QUERY_CHUNK = 262144


def sdf_query(params, rcfg, device, blend: Optional[float]):
    """numpy points [N, 3] -> numpy SDF [N] of the checkpoint's field at
    mip level ``blend`` (None: level 0 alone, as sdf_only takes it without
    a level), computed on ``device`` chunk by chunk."""
    from tensoflow_tpu_torch.fields import tenso_sdf
    from tensoflow_tpu_torch.models.shape_renderer import aabb_tensor
    aabb = aabb_tensor(rcfg, device)
    packed = tenso_sdf.pack_field(params['sdf'], rcfg.sdf)

    @torch.no_grad()
    def query(pts_np):
        out = []
        for i in range(0, len(pts_np), QUERY_CHUNK):
            pts = torch.as_tensor(pts_np[i:i + QUERY_CHUNK], device=device)
            lv = None if blend is None else torch.full(
                (pts.shape[0], 1), blend, device=device)
            out.append(tenso_sdf.sdf_only(params['sdf'], rcfg.sdf, pts, aabb,
                                          lv, packed=packed)[:, 0].cpu())
        return torch.cat(out).numpy()
    return query


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--resolution', type=int, default=512)
    parser.add_argument('--output', type=str, default=None)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' for the plain path (default: the card)")
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)

    from tensoflow_tpu_torch import resolve_device
    from tensoflow_tpu_torch.config import load_config
    from tensoflow_tpu_torch.ops import mesh
    from tensoflow_tpu_torch.train import checkpoints
    from tensoflow_tpu_torch.train.trainer import build_shape_config

    device = resolve_device(args.device)
    cfg = load_config(args.cfg, overrides=args.overrides)
    ckpt_path = args.ckpt or os.path.join('data/model', cfg['name'],
                                          'model.pkl')
    ckpt = checkpoints.load_checkpoint(ckpt_path)
    kw = ckpt['kwargs']
    rcfg = build_shape_config(cfg, kw['grid_size'], kw['n_levels'])
    params = checkpoints.tree_map(lambda t: t.to(device), ckpt['params'])
    query = sdf_query(params, rcfg, device, float(cfg.get('blend_ratio', 0)))
    verts, tris = mesh.extract_geometry(
        np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]), args.resolution,
        0.0, query)
    out = args.output or os.path.join(
        'data/meshes', f"{cfg['name']}-{ckpt['step']}.ply")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    mesh.write_ply(out, verts, tris)
    print(f'wrote {out}: {len(verts)} verts, {len(tris)} tris')
    return out, verts, tris


if __name__ == '__main__':
    main()
