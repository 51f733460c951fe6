"""Procedural analytic test scene (PyTorch port copy of tensoflow_tpu/data/toy.py): a shaded sphere rendered on the fly.

No reference counterpart — this framework's own test/bench fixture.  It lets
the full train/eval pipeline run hermetically (no dataset downloads): an
analytic SDF sphere with Lambertian + Blinn-Phong shading under a fixed
directional light, rendered by exact ray-sphere intersection with the same
camera model as the blender-format datasets (nerfDataType poses).
"""
from __future__ import annotations

import numpy as np

from .database import BaseDatabase


def _look_at(eye, center=np.zeros(3), up=np.array([0.0, 0.0, 1.0])):
    """c2w pose, OpenGL convention (camera looks along -z)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    c2w = np.eye(4)
    c2w[:3, 0] = s
    c2w[:3, 1] = u
    c2w[:3, 2] = -f
    c2w[:3, 3] = eye
    return c2w


def render_sphere_view(pose_c2w, K, h, w, radius=0.5,
                       light_dir=np.array([0.5, 0.3, 0.8]),
                       albedo=np.array([0.7, 0.3, 0.2])):
    """Exact ray-traced lambertian+specular sphere. Returns (rgb u8, mask)."""
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(i - K[0, 2] + 0.5) / K[0, 0],
                     -(j - K[1, 2] + 0.5) / K[1, 1],
                     -np.ones_like(i, np.float64)], -1)
    R, t = pose_c2w[:3, :3], pose_c2w[:3, 3]
    d = dirs @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(t, d.shape)

    b = 2 * np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    tq = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    hit &= tq > 0
    pts = o + tq[..., None] * d
    n = pts / radius
    l = light_dir / np.linalg.norm(light_dir)
    diff = np.clip(np.sum(n * l, -1), 0, 1)
    hvec = l - d
    hvec = hvec / np.maximum(np.linalg.norm(hvec, axis=-1, keepdims=True),
                             1e-8)
    spec = np.clip(np.sum(n * hvec, -1), 0, 1) ** 40
    rgb = (albedo[None, None] * (0.25 + 0.75 * diff[..., None])
           + 0.5 * spec[..., None])
    rgb = np.clip(rgb, 0, 1)
    img = np.where(hit[..., None], rgb, 1.0)
    return (img * 255).astype(np.uint8), hit.astype(np.float32)


# ---------------------------------------------------------------------------
# 'blobs': a higher-fidelity procedural scene — smooth union of spheres with
# concavities, spatially-varying albedo, and analytic normals.  Harder than
# the sphere (non-convex geometry, self-shadowing-free shading) while still
# having exact ground truth (an analytic SDF for Chamfer via marching tets,
# analytic normals for MAE).
# ---------------------------------------------------------------------------

_BLOB_CENTERS = np.array([
    [0.00, 0.00, 0.05],
    [0.38, 0.00, -0.12],
    [-0.25, 0.30, -0.05],
    [-0.12, -0.34, 0.22],
    [0.10, 0.18, 0.38],
], np.float64)
_BLOB_RADII = np.array([0.40, 0.22, 0.20, 0.18, 0.16], np.float64)
_BLOB_ALBEDO = np.array([
    [0.70, 0.30, 0.20],
    [0.20, 0.55, 0.75],
    [0.75, 0.65, 0.20],
    [0.30, 0.65, 0.30],
    [0.60, 0.30, 0.65],
], np.float64)
_BLOB_SMOOTH_K = 16.0


def blob_sdf(p):
    """Smooth-min SDF of the blob scene at [..., 3] points (float64-safe).

    exp-smooth-min is Lipschitz <= 1 so sphere tracing with a safety
    factor is exact; the surface is within |sdf| of any query."""
    d = (np.linalg.norm(p[..., None, :] - _BLOB_CENTERS, axis=-1)
         - _BLOB_RADII)                                   # [..., B]
    w = np.exp(-_BLOB_SMOOTH_K * d)
    return -np.log(np.maximum(w.sum(-1), 1e-300)) / _BLOB_SMOOTH_K


def blob_albedo(p):
    """Smoothly blended per-blob albedo at [..., 3] points."""
    d = (np.linalg.norm(p[..., None, :] - _BLOB_CENTERS, axis=-1)
         - _BLOB_RADII)
    w = np.exp(-8.0 * d)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-300)
    return w @ _BLOB_ALBEDO


def _blob_normal(p, eps=1e-4):
    offs = np.eye(3) * eps
    g = np.stack([blob_sdf(p + offs[i]) - blob_sdf(p - offs[i])
                  for i in range(3)], -1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def render_blobs_view(pose_c2w, K, h, w,
                      light_dir=np.array([0.5, 0.3, 0.8]),
                      n_steps=128):
    """Sphere-traced render of the blob scene. Returns (rgb u8, mask,
    normals [h,w,3] world-space, zero outside the mask)."""
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(i - K[0, 2] + 0.5) / K[0, 0],
                     -(j - K[1, 2] + 0.5) / K[1, 1],
                     -np.ones_like(i, np.float64)], -1)
    R, t = pose_c2w[:3, :3], pose_c2w[:3, 3]
    d = (dirs @ R.T).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(t, d.shape).astype(np.float64)

    tt = np.zeros((d.shape[0],))
    done = np.zeros((d.shape[0],), bool)
    for _ in range(n_steps):
        p = o + d * tt[:, None]
        sd = blob_sdf(p)
        done |= (sd < 1e-4) | (tt > 4.0)
        tt = np.where(done, tt, tt + 0.9 * np.maximum(sd, 1e-5))
    sd = blob_sdf(o + d * tt[:, None])
    hit = (sd < 5e-3) & (tt < 4.0)

    pts = o + d * tt[:, None]
    n = _blob_normal(pts)
    alb = blob_albedo(pts)
    l = light_dir / np.linalg.norm(light_dir)
    diff = np.clip(np.sum(n * l, -1), 0, 1)
    hvec = l - d
    hvec = hvec / np.maximum(np.linalg.norm(hvec, axis=-1, keepdims=True),
                             1e-8)
    spec = np.clip(np.sum(n * hvec, -1), 0, 1) ** 40
    rgb = alb * (0.25 + 0.75 * diff[:, None]) + 0.5 * spec[:, None]
    rgb = np.clip(rgb, 0, 1)
    img = np.where(hit[:, None], rgb, 1.0).reshape(h, w, 3)
    normals = np.where(hit[:, None], n, 0.0).reshape(h, w, 3)
    alb_img = np.where(hit[:, None], alb, 0.0).reshape(h, w, 3)
    return ((img * 255).astype(np.uint8),
            hit.reshape(h, w).astype(np.float32),
            normals.astype(np.float32), alb_img.astype(np.float32))


class ToyDatabase(BaseDatabase):
    """'toy/<scene>_<res>_<n>' — n views on a circle at resolution res.

    Scenes: 'sphere' (analytic lambert+phong sphere) and 'blobs'
    (smooth-union SDF with varying albedo + analytic normals/Chamfer GT;
    see blob_sdf)."""

    def __init__(self, database_name, dataset_dir=None, isTest=False,
                 isWhiteBG=True):
        super().__init__(database_name)
        parts = database_name.split('/')[1].split('_')
        scene = parts[0]
        res = int(parts[1]) if len(parts) > 1 else 100
        n_views = int(parts[2]) if len(parts) > 2 else 16
        self.scene = scene
        self.H = self.W = res
        focal = 1.2 * res
        self.K = np.array([[focal, 0, res / 2],
                           [0, focal, res / 2], [0, 0, 1]], np.float32)
        rng = np.random.RandomState(0)
        self.poses, self.imgs, self.masks = [], [], []
        self.normals, self.albedos = [], []
        for vi in range(n_views):
            az = 2 * np.pi * vi / n_views
            el = 0.3 + 0.4 * rng.rand()
            eye = 2.2 * np.array([np.cos(az) * np.cos(el),
                                  np.sin(az) * np.cos(el), np.sin(el)])
            pose = _look_at(eye)
            if scene == 'blobs':
                img, mask, nrm, alb = render_blobs_view(pose, self.K,
                                                        res, res)
            else:
                img, mask = render_sphere_view(pose, self.K, res, res)
                nrm, alb = None, None
            self.poses.append(pose)
            self.imgs.append(img)
            self.masks.append(mask)
            self.normals.append(nrm)
            self.albedos.append(alb)
        self.img_ids = list(range(n_views))
        self.scale_factor = 1.0

    def get_image(self, i):
        return self.imgs[i]

    def get_K(self, i):
        return self.K

    def get_pose(self, i):
        return self.poses[i]

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, i):
        return np.zeros((self.H, self.W), np.float32), self.masks[i]

    def get_mask(self, i):
        return self.masks[i]

    def get_normal(self, i):
        """Analytic GT normals for the blobs scene (None for sphere —
        its base class handles that)."""
        return self.normals[i]

    def get_albedo(self, i):
        """Ground-truth albedo map."""
        if self.albedos[i] is not None:
            return self.albedos[i]
        alb = np.empty((self.H, self.W, 3), np.float32)
        alb[:] = np.array([0.7, 0.3, 0.2], np.float32)
        return alb
