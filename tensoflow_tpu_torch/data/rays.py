"""Host-side ray-batch construction (PyTorch port copy of tensoflow_tpu/data/rays.py): filtering and shuffling.

Equivalent of the reference's in-renderer ray plumbing
(ref: network/shapeRenderer.py:383-566): flatten every training pixel into a
global ray table with tri-miprf cone radii, filter rays that miss the aabb,
shuffle, and slice fixed-size batches per step.  Kept in numpy on the host —
the per-step slice is tiny (rays x ~30 floats) and overlaps with device
compute; the epoch-level shuffle is a single permutation.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def build_imgs_info(database, img_ids, apply_mask: bool = False):
    """(ref: shapeRenderer.py:21-41)"""
    images = np.stack([database.get_image(i) for i in img_ids], 0)
    images = images.astype(np.float32) / 255.0
    Ks = np.stack([database.get_K(i) for i in img_ids], 0).astype(np.float32)
    poses = np.stack([database.get_pose(i) for i in img_ids], 0).astype(
        np.float32)
    info = {'imgs': images, 'Ks': Ks, 'poses': poses}
    if apply_mask:
        info['masks'] = np.stack([database.get_depth(i)[1] for i in img_ids],
                                 0).astype(np.float32)
    return info


def get_human_coordinate_poses(poses):
    """(ref: shapeRenderer.py:520-536) poses [n,3,4] w2c or [n,4,4] c2w->[:3].
    Returns [n,3,4]."""
    poses = poses[:, :3, :]
    pn = poses.shape[0]
    cam_cen = (-np.transpose(poses[:, :, :3], (0, 2, 1))
               @ poses[:, :, 3:])[..., 0]
    cam_cen[..., 2] = 0
    y = np.zeros((pn, 3), np.float32)
    y[:, 2] = -1.0
    z = poses[:, 2, :3].copy()
    z[:, 2] = 0
    z = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-8)
    x = np.cross(y, z)
    rot = np.stack([x, y, z], 1)
    t = -rot @ cam_cen[:, :, None]
    return np.concatenate([rot, t], -1).astype(np.float32)


def construct_ray_batch_nerf(imgs_info, apply_mask: bool = False):
    """Blender/nerf-convention rays (c2w poses, -z forward)
    (ref: shapeRenderer.py:471-518). Returns dict of [rn, ...] arrays."""
    imgs = imgs_info['imgs']
    imn, h, w, _ = imgs.shape
    K = imgs_info['Ks'][0]
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    rays_d = np.stack([(i - K[0, 2] + 0.5) / K[0, 0],
                       -(j - K[1, 2] + 0.5) / K[1, 1],
                       -np.ones_like(i)], -1)                      # [h,w,3]

    dx = np.linalg.norm(rays_d[:, :-1] - rays_d[:, 1:], axis=-1,
                        keepdims=True)
    dx = np.concatenate([dx, dx[:, -2:-1]], 1)
    dy = np.linalg.norm(rays_d[:-1] - rays_d[1:], axis=-1, keepdims=True)
    dy = np.concatenate([dy, dy[-2:-1]], 0)
    radii = np.sqrt(dx * dy / np.pi)                               # [h,w,1]

    poses = imgs_info['poses'].astype(np.float32)                  # [n,4,4]
    rn = imn * h * w
    d = rays_d.reshape(1, h * w, 3)
    d_world = np.einsum('nkj,npj->npk', poses[:, :3, :3], d)       # R @ d
    rays_o = np.broadcast_to(poses[:, None, :3, 3], (imn, h * w, 3))

    d_world = d_world.reshape(rn, 3)
    dirs = d_world / np.linalg.norm(d_world, axis=-1, keepdims=True)
    human = get_human_coordinate_poses(poses)                      # [n,3,4]
    human = np.repeat(human[:, None], h * w, 1).reshape(rn, 3, 4)

    batch = {
        'dirs': dirs.astype(np.float32),
        'rays_d': d_world.astype(np.float32),
        'rays_o': np.ascontiguousarray(rays_o.reshape(rn, 3)),
        'radiis': np.broadcast_to(radii.reshape(1, h * w, 1),
                                  (imn, h * w, 1)).reshape(rn, 1)
                    .astype(np.float32),
        'rays_cos': (1.0 / np.linalg.norm(d_world, axis=-1, keepdims=True))
                    .astype(np.float32),
        'rgbs': imgs.reshape(rn, 3).astype(np.float32),
        'human_poses': human,
    }
    if apply_mask and 'masks' in imgs_info:
        batch['masks'] = imgs_info['masks'].reshape(rn, 1).astype(np.float32)
    return batch, rn, h, w


def construct_ray_batch_w2c(imgs_info, apply_mask: bool = False):
    """COLMAP/w2c-convention rays (ref: shapeRenderer.py:417-469)."""
    imgs = imgs_info['imgs']
    imn, h, w, _ = imgs.shape
    Ks = imgs_info['Ks']
    poses = imgs_info['poses'][:, :3, :]                           # [n,3,4]

    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    coords = np.stack([i + 0.5, j + 0.5, np.ones_like(i)], -1)     # [h,w,3]
    rn = imn * h * w

    rays_d_all, radii_all, rays_o_all = [], [], []
    for n in range(imn):
        d_cam = coords.reshape(-1, 3) @ np.linalg.inv(Ks[n]).T
        d_img = d_cam.reshape(h, w, 3)
        dx = np.linalg.norm(d_img[:, :-1] - d_img[:, 1:], axis=-1,
                            keepdims=True)
        dx = np.concatenate([dx, dx[:, -2:-1]], 1)
        dy = np.linalg.norm(d_img[:-1] - d_img[1:], axis=-1, keepdims=True)
        dy = np.concatenate([dy, dy[-2:-1]], 0)
        radii_all.append(np.sqrt(dx * dy / np.pi).reshape(-1, 1))
        R, t = poses[n, :, :3], poses[n, :, 3:]
        rays_d_all.append(d_cam @ R)                               # R^T d
        rays_o_all.append(np.broadcast_to((-R.T @ t)[:, 0], (h * w, 3)))

    rays_d = np.concatenate(rays_d_all, 0).astype(np.float32)
    dirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    human = get_human_coordinate_poses(imgs_info['poses'])
    human = np.repeat(human[:, None], h * w, 1).reshape(rn, 3, 4)
    batch = {
        'dirs': dirs,
        'rays_d': rays_d,
        'rays_o': np.concatenate(rays_o_all, 0).astype(np.float32),
        'radiis': np.concatenate(radii_all, 0).astype(np.float32),
        'rays_cos': (1.0 / np.linalg.norm(rays_d, axis=-1, keepdims=True))
                    .astype(np.float32),
        'rgbs': imgs.reshape(rn, 3).astype(np.float32),
        'human_poses': human.astype(np.float32),
    }
    if apply_mask and 'masks' in imgs_info:
        batch['masks'] = imgs_info['masks'].reshape(rn, 1).astype(np.float32)
    return batch, rn, h, w


def filter_rays_aabb(batch: Dict[str, np.ndarray], aabb) -> Dict:
    """Keep rays that intersect the aabb (ref: shapeRenderer.py:538-566)."""
    o, d = batch['rays_o'], batch['dirs']
    aabb = np.asarray(aabb, np.float32)
    vec = np.where(d == 0, 1e-6, d)
    ra = (aabb[1] - o) / vec
    rb = (aabb[0] - o) / vec
    t_min = np.minimum(ra, rb).max(-1)
    t_max = np.maximum(ra, rb).min(-1)
    keep = t_max > t_min
    return {k: v[keep] for k, v in batch.items()}


class RayBatcher:
    """Shuffled fixed-size batch slicing (ref: shapeRenderer.py:411-415,
    777-782)."""

    def __init__(self, batch: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0):
        self.batch = batch
        self.bs = batch_size
        self.n = len(next(iter(batch.values())))
        self.rng = np.random.RandomState(seed)
        self._shuffle()

    def _shuffle(self):
        idx = self.rng.permutation(self.n)
        self.batch = {k: v[idx] for k, v in self.batch.items()}
        self.i = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.i + self.bs >= self.n:
            self._shuffle()
        out = {k: v[self.i:self.i + self.bs] for k, v in self.batch.items()}
        self.i += self.bs
        return out
