"""Scene databases of the PyTorch port (counterpart of
tensoflow_tpu/data/database.py): uniform image/pose/intrinsics access per
dataset family, a name-based registry and deterministic train/test splits.
All loading is host-side numpy; arrays feed the ray batches (data/rays.py).

Adapters (ref: dataset/database.py):
  * TensoSDFSynDatabase — blender transforms_{split}.json + RGBA pngs +
    normal/diffColor test extras (ref: database.py:479-579)
  * NeRFSynDatabase     — classic nerf-synthetic layout (ref: 288-374)
  * TensoIRDatabase     — TensoIR relighting layout (ref: 376-477)
  * ORBDatabase         — ORB captures (ref: 723-802)
  * ToyDatabase         — the procedural scene of data/toy.py
Glossy real/synthetic + COLMAP-based CustomDatabase are in
data/colmap_db.py.  Images are read by data/image_io.py (PNG and
scanline OpenEXR without imageio or cv2); the JAX package's diffColor
read goes through cv2, and is skipped there when cv2 has no EXR codec.
"""
from __future__ import annotations

import abc
import json
import os
import random
from typing import List, Tuple

import numpy as np

from .image_io import imread, read_exr


class BaseDatabase(abc.ABC):
    """(ref: database.py:20-45)"""

    def __init__(self, database_name: str):
        self.database_name = database_name

    @abc.abstractmethod
    def get_image(self, img_id): ...

    @abc.abstractmethod
    def get_K(self, img_id): ...

    @abc.abstractmethod
    def get_pose(self, img_id): ...

    @abc.abstractmethod
    def get_img_ids(self): ...

    @abc.abstractmethod
    def get_depth(self, img_id): ...

    def get_mask(self, img_id):
        return None

    def get_normal(self, img_id):
        return None

    def get_albedo(self, img_id):
        raise NotImplementedError


class TensoSDFSynDatabase(BaseDatabase):
    """Blender transforms.json datasets with poses as c2w 4x4
    (ref: database.py:479-579). Poses are OpenGL-convention c2w; translation
    scaled by 0.5 to fit the unit sphere."""

    def __init__(self, database_name, dataset_dir, isTest=False,
                 isWhiteBG=True):
        super().__init__(database_name)
        _, model_name = database_name.split('/')
        self.root = os.path.join(dataset_dir, model_name)
        self.load_normals = isTest
        self.load_diffColor = isTest
        self.splits = ['test'] if isTest else ['train', 'val']

        self.pose_all, self.imgs_all, self.masks_all = [], [], []
        self.normals_all, self.diffColor_all = [], []
        meta = None
        for s in self.splits:
            with open(os.path.join(self.root,
                                   f'transforms_{s}.json')) as fp:
                meta = json.load(fp)
            for fr in meta['frames']:
                fname = os.path.join(self.root, fr['file_path'] + '.png')
                img = imread(fname).astype(np.float32) / 255.0
                mask = img[..., -1:]
                if isWhiteBG:
                    rgb = ((img[..., :3] * mask + (1 - mask)) * 255).astype(
                        np.uint8)
                else:
                    rgb = (img[..., :3] * mask * 255).astype(np.uint8)
                self.imgs_all.append(rgb)
                self.masks_all.append(mask)
                self.pose_all.append(np.array(fr['transform_matrix']))
                if self.load_normals:
                    nrm = imread(os.path.join(
                        self.root, fr['file_path'] + '_normal.png'))
                    nrm = np.array(nrm)[..., :3] / 255.0
                    nrm = (nrm - 0.5) * 2.0
                    nrm = nrm * mask + (1 - mask) * np.array([0, 0, 1.0])
                    self.normals_all.append(nrm)
                dc_path = os.path.join(self.root,
                                       fr['file_path'] + '_diffColor.exr')
                if self.load_diffColor and os.path.exists(dc_path):
                    dc = read_exr(dc_path)
                    if dc.shape[-1] != 4:
                        raise ValueError(f'{dc_path}: {dc.shape[-1]} '
                                         'channels, RGBA expected')
                    self.diffColor_all.append(dc[..., :3] * dc[..., -1:])

        self.H, self.W = self.imgs_all[0].shape[:2]
        cax = float(meta['camera_angle_x'])
        self.focal = 0.5 * self.W / np.tan(0.5 * cax)
        self.K = np.array([[self.focal, 0, 0.5 * self.W],
                           [0, self.focal, 0.5 * self.H],
                           [0, 0, 1]], np.float32)
        self.scale_factor = 0.5
        self.img_ids = list(range(len(self.imgs_all)))

    def get_image(self, i):
        return self.imgs_all[i]

    def get_K(self, i):
        return self.K

    def get_pose(self, i):
        pose = self.pose_all[i].copy()
        pose[:, 3:] *= self.scale_factor
        return pose

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, i):
        h, w = self.H, self.W
        return np.zeros((h, w), np.float32), self.masks_all[i][..., -1]

    def get_mask(self, i):
        return self.masks_all[i][..., -1]

    def get_normal(self, i):
        return self.normals_all[i]

    def get_albedo(self, i):
        return self.diffColor_all[i]


class NeRFSynDatabase(TensoSDFSynDatabase):
    """Classic nerf-synthetic (ref: database.py:288-374). Same transforms
    layout; no normal/diffColor extras and no pose rescale."""

    def __init__(self, database_name, dataset_dir, isTest=False,
                 isWhiteBG=True):
        parts = database_name.split('/')
        super().__init__('/'.join(parts[:2]), dataset_dir, isTest, isWhiteBG)
        self.load_normals = False
        self.load_diffColor = False
        self.scale_factor = float(parts[2]) if len(parts) > 2 else 0.5


class TensoIRDatabase(BaseDatabase):
    """TensoIR relighting scenes (ref: database.py:376-477): per-view
    subdirectories '<split>_NNN/' each holding metadata.json +
    rgba_<light>_<rot>.png (+ normal/albedo pngs for test)."""

    def __init__(self, database_name, dataset_dir, isTest=False,
                 isWhiteBG=True, light_name='sunset', light_rotation='000'):
        super().__init__(database_name)
        _, model_name = database_name.split('/')
        self.root = os.path.join(dataset_dir, model_name)
        self.light_name, self.light_rotation = light_name, light_rotation
        splits = ['test'] if isTest else ['train', 'val']
        load_extras = isTest

        self.imgs_all, self.masks_all, self.pose_all = [], [], []
        self.normals_all, self.albedos_all = [], []
        meta = None
        for s in splits:
            items = sorted(d for d in os.listdir(self.root)
                           if d.startswith(s)
                           and os.path.isdir(os.path.join(self.root, d)))
            for item in items:
                item_path = os.path.join(self.root, item)
                with open(os.path.join(item_path, 'metadata.json')) as fp:
                    meta = json.load(fp)
                fname = os.path.join(
                    item_path,
                    f'rgba_{self.light_name}_{self.light_rotation}.png')
                img = imread(fname).astype(np.float32) / 255.0
                mask = img[..., -1:]
                if isWhiteBG:
                    rgb = ((img[..., :3] * mask + (1 - mask)) * 255).astype(
                        np.uint8)
                else:
                    rgb = (img[..., :3] * mask * 255).astype(np.uint8)
                self.imgs_all.append(rgb)
                self.masks_all.append(mask)
                self.pose_all.append(np.array(list(map(
                    float, meta['cam_transform_mat'].split(',')))
                    ).reshape(4, 4))
                if load_extras:
                    nrm_im = imread(os.path.join(item_path, 'normal.png'))
                    nrm = np.array(nrm_im)[..., :3] / 255.0
                    nrm = (nrm - 0.5) * 2.0
                    na = np.array(nrm_im)[..., -1:] / 255.0
                    nrm = nrm * na + (1 - na) * np.array([0, 0, 1.0])
                    self.normals_all.append(nrm)
                    alb_im = imread(os.path.join(item_path, 'albedo.png'))
                    alb = np.array(alb_im)[..., :3] / 255.0
                    aa = np.array(alb_im)[..., -1:] / 255.0
                    self.albedos_all.append(alb * aa)

        self.H, self.W = int(meta['imh']), int(meta['imw'])
        cax = float(meta['cam_angle_x'])
        self.focal = 0.5 * self.W / np.tan(0.5 * cax)
        self.K = np.array([[self.focal, 0, 0.5 * self.W],
                           [0, self.focal, 0.5 * self.H],
                           [0, 0, 1]], np.float32)
        self.scale_factor = 0.5
        self.img_ids = list(range(len(self.imgs_all)))

    def get_image(self, i):
        return self.imgs_all[i]

    def get_K(self, i):
        return self.K

    def get_pose(self, i):
        pose = self.pose_all[i].copy()
        pose[:, 3:] *= self.scale_factor
        return pose

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, i):
        return (np.zeros((self.H, self.W), np.float32),
                self.masks_all[i][..., -1])

    def get_mask(self, i):
        return self.masks_all[i][..., -1]

    def get_normal(self, i):
        return self.normals_all[i]

    def get_albedo(self, i):
        return self.albedos_all[i]


class ORBDatabase(BaseDatabase):
    """Open Real-world Benchmark captures (ref: database.py:723-802):
    blender_format_LDR with transforms json; w2c derived from c2w."""

    def __init__(self, database_name, dataset_dir, isTest=False,
                 isWhiteBG=True):
        super().__init__(database_name)
        _, model_name = database_name.split('/')
        self.root = os.path.join(dataset_dir, model_name,
                                 'blender_format_LDR')
        splits = ['test'] if isTest else ['train']
        self.imgs_all, self.masks_all, self.pose_all = [], [], []
        meta = None
        for s in splits:
            with open(os.path.join(self.root, f'transforms_{s}.json')) as fp:
                meta = json.load(fp)
            for fr in meta['frames']:
                fname = os.path.join(self.root, fr['file_path'] + '.png')
                img = imread(fname).astype(np.float32) / 255.0
                if img.shape[-1] == 4:
                    mask = img[..., -1:]
                else:
                    mask = np.ones_like(img[..., :1])
                rgb = ((img[..., :3] * mask + (1 - mask) * (1.0 if isWhiteBG
                                                            else 0.0))
                       * 255).astype(np.uint8)
                self.imgs_all.append(rgb)
                self.masks_all.append(mask)
                self.pose_all.append(np.array(fr['transform_matrix']))
        self.H, self.W = self.imgs_all[0].shape[:2]
        cax = float(meta['camera_angle_x'])
        self.focal = 0.5 * self.W / np.tan(0.5 * cax)
        self.K = np.array([[self.focal, 0, 0.5 * self.W],
                           [0, self.focal, 0.5 * self.H],
                           [0, 0, 1]], np.float32)
        self.scale_factor = 1.0
        self.img_ids = list(range(len(self.imgs_all)))

    def get_image(self, i):
        return self.imgs_all[i]

    def get_K(self, i):
        return self.K

    def get_pose(self, i):
        pose = self.pose_all[i].copy()
        pose[:, 3:] *= self.scale_factor
        return pose

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, i):
        return (np.zeros((self.H, self.W), np.float32),
                self.masks_all[i][..., -1])

    def get_mask(self, i):
        return self.masks_all[i][..., -1]


def parse_database_name(database_name: str, dataset_dir: str, isTest=False,
                        isWhiteBG=False) -> BaseDatabase:
    """(ref: database.py:804-822)"""
    from .toy import ToyDatabase
    name2database = {
        'nerf': NeRFSynDatabase,
        'tensoIR': TensoIRDatabase,
        'tensoSDF': TensoSDFSynDatabase,
        'orb': ORBDatabase,
        'toy': ToyDatabase,
    }
    dtype = database_name.split('/')[0]
    if dtype in ('syn', 'real', 'custom'):
        from .colmap_db import parse_colmap_database
        return parse_colmap_database(database_name, dataset_dir)
    if dtype not in name2database:
        raise NotImplementedError(database_name)
    return name2database[dtype](database_name, dataset_dir, isTest=isTest,
                                isWhiteBG=isWhiteBG)


def get_database_split(database: BaseDatabase, split_type='validation',
                       split_manul=False, split_borderline=100
                       ) -> Tuple[List, List]:
    """(ref: database.py:824-844)"""
    if split_manul:
        img_ids = database.get_img_ids()
        train_ids = img_ids[:split_borderline]
        test_ids = img_ids[split_borderline:]
        if len(test_ids) > 10:
            test_ids = test_ids[::50]
        else:
            test_ids = test_ids[::4]
        return train_ids, test_ids
    if split_type == 'validation':
        random.seed(6033)
        img_ids = list(database.get_img_ids())
        random.shuffle(img_ids)
        return img_ids[1:], img_ids[:1]
    if split_type == 'test':
        # pickled fixed split (ref: database.py:840-841 reads
        # configs/synthetic_split_128.pkl as (test_ids, train_ids))
        import pickle
        with open('configs/synthetic_split_128.pkl', 'rb') as f:
            test_ids, train_ids = pickle.load(f)
        return train_ids, test_ids
    raise NotImplementedError(split_type)
