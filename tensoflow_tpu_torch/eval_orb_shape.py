"""ORB geometry evaluation CLI of the port (counterpart of
eval_orb_shape.py): bidirectional Chamfer distance
(ref: eval_orb_shape.py:42-96).

    python -m tensoflow_tpu_torch.eval_orb_shape --mesh PRED.ply \\
        --gt_mesh GT.ply [--n_samples 100000]

Samples both surfaces (area-weighted, ``RandomState(0)`` draws as the
JAX package makes them; a ground truth without faces is taken as a point
cloud), prints the Chamfer distance and appends it to
data/metrics_record.txt.  Host numpy and scipy only: no device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def sample_surface(verts: np.ndarray, tris: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted surface sampling."""
    rng = np.random.RandomState(seed)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    probs = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(tris), n, p=probs)
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[idx] + u * (b[idx] - a[idx]) + v * (c[idx] - a[idx])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--mesh', type=str, required=True)
    parser.add_argument('--gt_mesh', type=str, required=True)
    parser.add_argument('--n_samples', type=int, default=100000)
    args = parser.parse_args(argv)

    from tensoflow_tpu_torch.eval.metrics import chamfer_distance
    from tensoflow_tpu_torch.ops.mesh import read_ply

    v1, t1 = read_ply(args.mesh)
    v2, t2 = read_ply(args.gt_mesh)
    p1 = sample_surface(v1, t1, args.n_samples)
    p2 = sample_surface(v2, t2, args.n_samples) if len(t2) else v2
    cd = chamfer_distance(p1, p2)
    print(f'chamfer: {cd:.6f}')
    os.makedirs('data', exist_ok=True)
    with open('data/metrics_record.txt', 'a') as f:
        f.write(f'{args.mesh} vs {args.gt_mesh}: chamfer {cd:.6f}\n')
    return cd


if __name__ == '__main__':
    main()
