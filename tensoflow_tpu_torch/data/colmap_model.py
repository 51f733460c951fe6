"""COLMAP sparse-model IO of the port: its own copy of
tensoflow_tpu/data/colmap_model.py (pure struct / numpy).

Replaces the vendored ``colmap/read_write_model.py`` (ref: colmap/
read_write_model.py:1-503): binary + text readers/writers for
cameras/images/points3D following the public COLMAP format spec.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class Camera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class Image(NamedTuple):
    id: int
    qvec: np.ndarray     # [4] w,x,y,z
    tvec: np.ndarray     # [3]
    camera_id: int
    name: str
    xys: np.ndarray      # [N,2]
    point3D_ids: np.ndarray  # [N]


class Point3D(NamedTuple):
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


CAMERA_MODELS = {
    0: ('SIMPLE_PINHOLE', 3), 1: ('PINHOLE', 4), 2: ('SIMPLE_RADIAL', 4),
    3: ('RADIAL', 5), 4: ('OPENCV', 8), 5: ('OPENCV_FISHEYE', 8),
    6: ('FULL_OPENCV', 12), 7: ('FOV', 5), 8: ('SIMPLE_RADIAL_FISHEYE', 4),
    9: ('RADIAL_FISHEYE', 5), 10: ('THIN_PRISM_FISHEYE', 12),
}
MODEL_NAME_TO_ID = {name: (mid, n) for mid, (name, n)
                    in CAMERA_MODELS.items()}


def qvec2rotmat(qvec) -> np.ndarray:
    """(COLMAP convention, w-first)"""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, 'rb') as f:
        (n,) = _read(f, '<Q')
        for _ in range(n):
            cid, model_id, w, h = _read(f, '<iiQQ')
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f'<{np_}d'))
            cams[cid] = Camera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, 'rb') as f:
        (n,) = _read(f, '<Q')
        for _ in range(n):
            iid = _read(f, '<i')[0]
            qvec = np.array(_read(f, '<4d'))
            tvec = np.array(_read(f, '<3d'))
            cam_id = _read(f, '<i')[0]
            name = b''
            c = f.read(1)
            while c != b'\x00':
                name += c
                c = f.read(1)
            (n2d,) = _read(f, '<Q')
            data = np.frombuffer(f.read(24 * n2d),
                                 dtype=[('xy', '<f8', 2), ('id', '<i8')])
            images[iid] = Image(iid, qvec, tvec, cam_id,
                                name.decode('utf-8'),
                                data['xy'].copy(), data['id'].copy())
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path, 'rb') as f:
        (n,) = _read(f, '<Q')
        for _ in range(n):
            pid = _read(f, '<Q')[0]
            xyz = np.array(_read(f, '<3d'))
            rgb = np.array(_read(f, '<3B'))
            err = _read(f, '<d')[0]
            (tl,) = _read(f, '<Q')
            track = np.frombuffer(f.read(8 * tl),
                                  dtype=[('img', '<i4'), ('p2d', '<i4')])
            pts[pid] = Point3D(pid, xyz, rgb, err, track['img'].copy(),
                               track['p2d'].copy())
    return pts


def write_cameras_binary(cams: Dict[int, Camera], path):
    """(ref: colmap/read_write_model.py write_cameras_binary)"""
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(cams)))
        for cam in cams.values():
            mid, np_ = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack('<iiQQ', cam.id, mid,
                                int(cam.width), int(cam.height)))
            f.write(struct.pack(f'<{np_}d', *np.asarray(cam.params)[:np_]))


def write_images_binary(images: Dict[int, 'Image'], path):
    """(ref: colmap/read_write_model.py write_images_binary)"""
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(images)))
        for im in images.values():
            f.write(struct.pack('<i', im.id))
            f.write(struct.pack('<4d', *np.asarray(im.qvec)))
            f.write(struct.pack('<3d', *np.asarray(im.tvec)))
            f.write(struct.pack('<i', im.camera_id))
            f.write(im.name.encode('utf-8') + b'\x00')
            n2d = len(im.xys)
            f.write(struct.pack('<Q', n2d))
            for xy, pid in zip(np.asarray(im.xys),
                               np.asarray(im.point3D_ids)):
                f.write(struct.pack('<2dq', xy[0], xy[1], int(pid)))


def write_points3d_binary(pts: Dict[int, Point3D], path):
    """(ref: colmap/read_write_model.py write_points3D_binary)"""
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(pts)))
        for p in pts.values():
            f.write(struct.pack('<Q', p.id))
            f.write(struct.pack('<3d', *np.asarray(p.xyz)))
            f.write(struct.pack('<3B', *np.asarray(p.rgb)))
            f.write(struct.pack('<d', float(p.error)))
            f.write(struct.pack('<Q', len(p.image_ids)))
            for img_id, p2d in zip(np.asarray(p.image_ids),
                                   np.asarray(p.point2D_idxs)):
                f.write(struct.pack('<ii', int(img_id), int(p2d)))


def write_model(cams, images, pts, path):
    """Binary model writer (ref: colmap/read_write_model.write_model)."""
    os.makedirs(path, exist_ok=True)
    write_cameras_binary(cams, os.path.join(path, 'cameras.bin'))
    write_images_binary(images, os.path.join(path, 'images.bin'))
    write_points3d_binary(pts, os.path.join(path, 'points3D.bin'))


def read_cameras_text(path) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            e = line.split()
            cams[int(e[0])] = Camera(int(e[0]), e[1], int(e[2]), int(e[3]),
                                     np.array([float(x) for x in e[4:]]))
    return cams


def read_images_text(path) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith('#') and l.strip()]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        iid = int(e[0])
        qvec = np.array([float(x) for x in e[1:5]])
        tvec = np.array([float(x) for x in e[5:8]])
        pts = lines[i + 1].split()
        xys = np.array(pts, dtype=np.float64).reshape(-1, 3) if pts \
            else np.zeros((0, 3))
        images[iid] = Image(iid, qvec, tvec, int(e[8]), e[9],
                            xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def read_model(path: str):
    """Auto-detect binary/text model (ref: read_write_model.read_model)."""
    if os.path.exists(os.path.join(path, 'cameras.bin')):
        cams = read_cameras_binary(os.path.join(path, 'cameras.bin'))
        imgs = read_images_binary(os.path.join(path, 'images.bin'))
        p3d_path = os.path.join(path, 'points3D.bin')
        pts = read_points3d_binary(p3d_path) if os.path.exists(p3d_path) \
            else {}
        return cams, imgs, pts
    cams = read_cameras_text(os.path.join(path, 'cameras.txt'))
    imgs = read_images_text(os.path.join(path, 'images.txt'))
    return cams, imgs, {}


def camera_K(cam: Camera) -> np.ndarray:
    """Intrinsics matrix for pinhole-family models."""
    if cam.model == 'SIMPLE_PINHOLE' or cam.model == 'SIMPLE_RADIAL':
        f, cx, cy = cam.params[:3]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    if cam.model in ('PINHOLE', 'OPENCV'):
        fx, fy, cx, cy = cam.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    raise NotImplementedError(cam.model)
