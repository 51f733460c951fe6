"""COLMAP-based scene databases of the PyTorch port (counterpart of
tensoflow_tpu/data/colmap_db.py): real captures and glossy-synthetic
scenes.

Re-designed equivalents of the reference's COLMAP-backed adapters
(ref: dataset/database.py:102-286 GlossyReal/GlossySynthetic, 581-721
CustomDatabase): w2c poses parsed from a COLMAP sparse model, the scene
normalized into the unit sphere from an object point cloud, with the same
up/forward re-orientation convention for the known captures.  The
resized and cropped image caches are computed by data/image_ops.py and
written as the JAX package writes them with cv2, so a cache directory
made by either package opens in the other.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict

import numpy as np

from .colmap_model import camera_K, qvec2rotmat, read_model
from .database import BaseDatabase
from .image_io import imread, imwrite_jpeg, imwrite_png
from .image_ops import gaussian_blur, resize_area, warp_perspective_linear


GLOSSY_META = {
    # up/forward re-orientation of the public GlossyReal captures
    # (ref: database.py:103-109)
    'bear': {'forward': [0.539944, -0.342791, 0.341446],
             'up': [0.0512875, -0.645326, -0.762183]},
    'coral': {'forward': [0.004226, -0.235523, 0.267582],
              'up': [0.0477973, -0.748313, -0.661622]},
    'maneki': {'forward': [-2.336584, -0.406351, 0.482029],
               'up': [-0.0117387, -0.738751, -0.673876]},
    'bunny': {'forward': [0.437076, -1.672467, 1.436961],
              'up': [-0.0693234, -0.644819, -0.761185]},
    'vase': {'forward': [-0.911907, -0.132777, 0.180063],
             'up': [-0.01911, -0.738918, -0.673524]},
}


def _compute_rotation(vert, forward):
    """(ref: database.py:172-180)"""
    y = np.cross(vert, forward)
    x = np.cross(y, vert)
    vert = vert / np.linalg.norm(vert)
    x = x / np.linalg.norm(x)
    y = y / np.linalg.norm(y)
    return np.stack([x, y, vert], 0)


def normalize_poses(poses: Dict, ref_points: np.ndarray,
                    up=None, forward=None):
    """Rigidly map the object into the unit sphere; update w2c poses
    (ref: database.py:182-207). Returns (poses, scale, offset, R_rect)."""
    max_pt, min_pt = ref_points.max(0), ref_points.min(0)
    center = 0.5 * (max_pt + min_pt)
    offset = -center
    scale = 1.0 / np.max(np.linalg.norm(ref_points - center[None], axis=1))
    if up is not None:
        up = np.asarray(up, np.float64)
        forward = np.asarray(forward, np.float64)
        up = up / np.linalg.norm(up)
        forward = forward / np.linalg.norm(forward)
        r_rect = _compute_rotation(up, forward)
    else:
        r_rect = np.eye(3)
    out = {}
    for img_id, pose in poses.items():
        rot, t = pose[:, :3], pose[:, 3]
        r_new = rot @ r_rect.T
        t_new = (t - rot @ offset) * scale
        out[img_id] = np.concatenate(
            [r_new, t_new[:, None]], -1).astype(np.float32)
    return out, scale, offset, r_rect


def _write_as_cv2(path: str, arr: np.ndarray):
    """The file that the JAX package's ``cv2.imwrite(path, arr)`` writes
    for a PNG or JPEG name: cv2 takes a 3- or 4-channel array as BGR(A),
    and writes a JPEG without alpha at its default quality (95)."""
    ext = os.path.splitext(path)[1].lower()
    if arr.ndim == 3 and arr.shape[-1] in (3, 4):
        arr = arr[..., [2, 1, 0, 3][:arr.shape[-1]]]
    if ext == '.png':
        imwrite_png(path, arr)
    elif ext in ('.jpg', '.jpeg'):
        imwrite_jpeg(path, arr[..., :3] if arr.ndim == 3 else arr)
    else:
        raise NotImplementedError(
            f'{path}: the port writes its image caches as PNG or JPEG')


def load_ply_points(path: str) -> np.ndarray:
    from ..ops.mesh import read_ply
    verts, _ = read_ply(path)
    return verts


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def look_at_rotation_2d(center_px: np.ndarray, K: np.ndarray):
    """Camera-space rotation steering the optical axis toward the pixel
    ``center_px``, plus the focal that preserves apparent size there
    (ref: base_utils.py:832-841 look_at_rotation +
    pose_utils.py:47-53 let_me_look_at_2d)."""
    f_raw = 0.5 * (K[0, 0] + K[1, 1])
    c = center_px - K[:2, 2]
    f_new = float(np.sqrt(c[0] ** 2 + c[1] ** 2 + f_raw ** 2))
    x, y = c / f_raw
    r_new = _rot_x(np.arctan2(y, 1.0)) @ _rot_y(-np.arctan2(x, 1.0))
    return r_new, f_new


def project_points(pts: np.ndarray, pose: np.ndarray, K: np.ndarray):
    """Pinhole projection of [n,3] world points through a w2c [3,4] pose
    (ref: base_utils.py:141-150)."""
    cam = pts @ pose[:, :3].T + pose[:, 3]
    cam = cam @ K.T
    depth = np.where(np.abs(cam[:, 2]) < 1e-4,
                     np.sign(cam[:, 2] + 1e-12) * 1e-4, cam[:, 2])
    return cam[:, :2] / depth[:, None], depth


def crop_to_object(img: np.ndarray, ref_points: np.ndarray,
                   pose: np.ndarray, K: np.ndarray, size: int):
    """Re-aim the camera at the object and warp to a square ``size`` crop.

    Projects the (normalized) object point cloud, takes its bounding
    square (kept inside the frame), rotates the camera so the crop center
    is on-axis, scales focal so the object fills ``size`` px, and warps
    by the induced homography H = K_new R_new K^-1. Returns
    (img [size,size,3], K_new [3,3], pose_new [3,4])
    (ref: database.py:71-100 crop_by_points +
    pose_utils.py:308-322 look_at_crop).
    """
    h, w = img.shape[:2]
    pts2d, _ = project_points(ref_points, pose, K)
    pts2d[:, 0] = np.clip(pts2d[:, 0], 0, w - 1)
    pts2d[:, 1] = np.clip(pts2d[:, 1], 0, h - 1)
    pt_min, pt_max = pts2d.min(0), pts2d.max(0)
    region = min(float(np.max(pt_max - pt_min)), h - 3, w - 3)

    def _center(lo, hi, extent):
        if region <= hi - lo:
            return 0.5 * (lo + hi)
        b0 = max(region / 2, hi - region / 2)
        b1 = min(lo + region / 2, extent - 2 - region / 2)
        return 0.5 * (b0 + b1)

    center = np.asarray([_center(pt_min[0], pt_max[0], w),
                         _center(pt_min[1], pt_max[1], h)], np.float32)
    scale = size / region

    r_new, f_new = look_at_rotation_2d(center, K)
    f_new *= scale
    k_new = np.asarray([[f_new, 0, size / 2], [0, f_new, size / 2],
                        [0, 0, 1]], np.float32)
    hom = k_new @ r_new @ np.linalg.inv(K)
    if scale < 1.0:
        # gaussian pre-filter against minification aliasing
        sigma = (1.0 / scale) / 3.0
        ksize = int(np.ceil(((sigma - 0.8) / 0.3 + 1) * 2 + 1))
        ksize += (ksize % 2 == 0)
        img = gaussian_blur(img, ksize, sigma)
    img_new = warp_perspective_linear(img.astype(np.float32), hom,
                                      (size, size))
    pose_new = np.concatenate(
        [r_new @ pose[:, :3], r_new @ pose[:, 3:]], 1).astype(np.float32)
    return img_new, k_new, pose_new


class ColmapDatabase(BaseDatabase):
    """Shared base for COLMAP-parsed captures (w2c [3,4] poses)."""

    def _parse_colmap(self, sparse_dir: str):
        cache = os.path.join(self.root, 'cache.pkl')
        if os.path.exists(cache):
            with open(cache, 'rb') as f:
                (self.poses, self.Ks, self.image_names,
                 self.img_ids) = pickle.load(f)
            return
        cameras, images, _ = read_model(sparse_dir)
        self.poses, self.Ks, self.image_names = {}, {}, {}
        self.img_ids = []
        for img_id, image in images.items():
            self.img_ids.append(img_id)
            self.image_names[img_id] = image.name
            rot = qvec2rotmat(image.qvec)
            pose = np.concatenate([rot, image.tvec[:, None]], 1)
            self.poses[img_id] = pose.astype(np.float32)
            self.Ks[img_id] = camera_K(cameras[image.camera_id])
        with open(cache, 'wb') as f:
            pickle.dump((self.poses, self.Ks, self.image_names,
                         self.img_ids), f)

    def get_K(self, img_id):
        return self.Ks[img_id].copy()

    def get_pose(self, img_id):
        return self.poses[img_id].copy()

    def get_img_ids(self):
        return self.img_ids

    def _resize_dir(self, max_len: str):
        """Cache a downscaled image dir images_raw_<len>/ and rescale Ks
        (ref: database.py:121-136)."""
        first = os.path.join(self.root, 'images',
                             self.image_names[self.img_ids[0]])
        h, w = imread(first).shape[:2]
        target = int(max_len.split('_')[1])
        ratio = target / max(h, w)
        th, tw = int(ratio * h), int(ratio * w)
        self.image_dir = os.path.join(self.root, f'images_{max_len}')
        os.makedirs(self.image_dir, exist_ok=True)
        for img_id in self.img_ids:
            dst = os.path.join(self.image_dir, self.image_names[img_id])
            if not os.path.exists(dst):
                img = imread(os.path.join(self.root, 'images',
                                          self.image_names[img_id]))
                _write_as_cv2(dst, resize_area(img[..., ::-1], (tw, th)))
            self.Ks[img_id] = (np.diag([tw / w, th / h, 1.0])
                               @ self.Ks[img_id]).astype(np.float32)

    def _crop_dir(self, size: int):
        """Cache an object-centered square-crop dir images_<size>/ with
        rectified poses/Ks in meta_info.pkl (ref: database.py:209-228)."""
        self.image_dir = os.path.join(self.root, f'images_{size}')
        meta = os.path.join(self.image_dir, 'meta_info.pkl')
        if os.path.exists(meta):
            with open(meta, 'rb') as f:
                self.poses, self.Ks = pickle.load(f)
            return
        os.makedirs(self.image_dir, exist_ok=True)
        for img_id in self.img_ids:
            img = imread(os.path.join(self.root, 'images',
                                      self.image_names[img_id]))
            img1, k1, pose1 = crop_to_object(
                img, self.ref_points, self.poses[img_id],
                self.Ks[img_id], size)
            _write_as_cv2(os.path.join(self.image_dir,
                                       self.image_names[img_id]),
                          np.clip(img1, 0, 255).astype(np.uint8)[..., ::-1])
            self.poses[img_id] = pose1
            self.Ks[img_id] = k1
        with open(meta, 'wb') as f:
            pickle.dump((self.poses, self.Ks), f)


class GlossyRealDatabase(ColmapDatabase):
    """(ref: database.py:102-247) 'real/<object>/raw_<len>'"""

    def __init__(self, database_name, dataset_dir):
        super().__init__(database_name)
        _, self.object_name, self.max_len = database_name.split('/')
        self.root = os.path.join(dataset_dir, self.object_name)
        self._parse_colmap(os.path.join(self.root, 'colmap', 'sparse', '0'))
        ref_points = load_ply_points(
            os.path.join(self.root, 'object_point_cloud.ply'))
        meta = GLOSSY_META.get(self.object_name, {})
        self.poses, self.scale_rect, self.offset_rect, self.R_rect = \
            normalize_poses(self.poses, ref_points,
                            meta.get('up'), meta.get('forward'))
        # object point cloud in the normalized frame (ref: database.py:191)
        self.ref_points = ((self.scale_rect
                            * (ref_points + self.offset_rect))
                           @ self.R_rect.T).astype(np.float32)
        # 'raw_<len>' -> downscaled full frames; '<len>' -> object-centred
        # square crops with rectified poses (ref: database.py:117-136)
        if self.max_len.startswith('raw'):
            self._resize_dir(self.max_len)
        else:
            self._crop_dir(int(self.max_len))

    def get_image(self, img_id):
        return imread(os.path.join(self.image_dir,
                                   self.image_names[img_id]))[..., :3]

    def get_depth(self, img_id):
        img = self.get_image(img_id)
        h, w = img.shape[:2]
        return np.ones([h, w], np.float32), np.ones([h, w], bool)


class GlossySyntheticDatabase(BaseDatabase):
    """(ref: database.py:249-286) 'syn/<model>' — per-view camera pickles."""

    def __init__(self, database_name, dataset_dir):
        super().__init__(database_name)
        _, model_name = database_name.split('/')
        self.root = os.path.join(dataset_dir, model_name)
        self.img_num = len(glob.glob(os.path.join(self.root, '*.pkl')))
        self.img_ids = [str(k) for k in range(self.img_num)]
        self.cams = []
        for k in range(self.img_num):
            with open(os.path.join(self.root, f'{k}-camera.pkl'),
                      'rb') as f:
                self.cams.append(pickle.load(f))
        self.scale_factor = 1.0

    def get_image(self, img_id):
        img = imread(os.path.join(self.root, f'{img_id}.png'))[..., :3]
        return img * self.get_mask(img_id)[..., None]

    def get_K(self, img_id):
        return self.cams[int(img_id)][1].astype(np.float32)

    def get_pose(self, img_id):
        pose = self.cams[int(img_id)][0].astype(np.float32).copy()
        pose[:, 3:] *= self.scale_factor
        return pose

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, img_id):
        depth = imread(os.path.join(self.root, f'{img_id}-depth.png'))
        depth = depth.astype(np.float32) / 65535 * 15
        return depth, depth < 14.5

    def get_mask(self, img_id):
        return self.get_depth(img_id)[1]


class CustomDatabase(ColmapDatabase):
    """(ref: database.py:581-721) 'custom/<object>/<max_len>' — user
    captures with COLMAP poses + object point cloud; optional masks dir."""

    def __init__(self, database_name, dataset_dir):
        super().__init__(database_name)
        _, self.object_name, self.max_len = database_name.split('/')
        self.root = os.path.join(dataset_dir, self.object_name)
        self._parse_colmap(os.path.join(self.root, 'colmap', 'sparse', '0'))
        pc = os.path.join(self.root, 'object_point_cloud.ply')
        self.image_dir = os.path.join(self.root, 'images')
        self.mask_dir = os.path.join(self.root, 'masks')
        if os.path.exists(pc):
            ref_points = load_ply_points(pc)
            self.poses, scale, offset, r_rect = normalize_poses(
                self.poses, ref_points)
            self.ref_points = ((scale * (ref_points + offset))
                               @ r_rect.T).astype(np.float32)
            # same raw/crop dispatch as GlossyReal (ref: database.py:589-592)
            if self.max_len.startswith('raw'):
                if '_' in self.max_len:
                    self._resize_dir(self.max_len)
            else:
                self._crop_dir(int(self.max_len))

    def get_image(self, img_id):
        return imread(os.path.join(self.image_dir,
                                   self.image_names[img_id]))[..., :3]

    def get_mask(self, img_id):
        p = os.path.join(self.mask_dir, self.image_names[img_id])
        if os.path.exists(p):
            m = imread(p)
            return (m[..., 0] if m.ndim == 3 else m) > 127
        img = self.get_image(img_id)
        return np.ones(img.shape[:2], bool)

    def get_depth(self, img_id):
        img = self.get_image(img_id)
        h, w = img.shape[:2]
        return np.ones([h, w], np.float32), self.get_mask(img_id)


def parse_colmap_database(database_name: str, dataset_dir: str
                          ) -> BaseDatabase:
    dtype = database_name.split('/')[0]
    if dtype == 'real':
        return GlossyRealDatabase(database_name, dataset_dir)
    if dtype == 'syn':
        return GlossySyntheticDatabase(database_name, dataset_dir)
    if dtype == 'custom':
        return CustomDatabase(database_name, dataset_dir)
    raise NotImplementedError(database_name)
