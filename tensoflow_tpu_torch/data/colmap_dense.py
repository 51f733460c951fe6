"""COLMAP dense-reconstruction IO of the port (its own copy of
tensoflow_tpu/data/colmap_dense.py): depth/normal map arrays and fused
point-cloud visibility.

Completes the COLMAP tooling surface (ref: colmap/read_write_dense.py,
colmap/read_write_fused_vis.py — both vendored from the official COLMAP
scripts).  Formats are the public COLMAP on-disk specs:

  * Mat<T> arrays (src/mvs/mat.h): ASCII header "W&H&C&" followed by
    little-endian float32 data in column-major (Fortran) order.
  * fused.ply.vis (src/mvs/fusion.cc WritePointsVisibility): uint64
    point count, then per point a uint32 count + that many uint32 image
    indices.
  * fused.ply itself is a plain binary PLY point cloud
    (x y z nx ny nz red green blue) — read/written with the generic
    property-preserving PLY helpers here (no plyfile/pyntcloud
    dependency).
"""
from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple

import numpy as np


# ---------------------------------------------------------------------------
# Mat<T> depth / normal maps
# ---------------------------------------------------------------------------

def read_array(path: str) -> np.ndarray:
    """COLMAP Mat<float> -> [H, W] or [H, W, C] float32."""
    with open(path, 'rb') as f:
        header = b''
        delims = 0
        while delims < 3:
            b = f.read(1)
            if not b:
                raise ValueError(f'truncated Mat header in {path}')
            header += b
            if b == b'&':
                delims += 1
        w, h, c = (int(x) for x in header.decode('ascii').split('&')[:3])
        data = np.fromfile(f, np.float32, w * h * c)
    arr = data.reshape((w, h, c), order='F')
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(array: np.ndarray, path: str):
    array = np.asarray(array, np.float32)
    if array.ndim == 2:
        array = array[..., None]
    h, w, c = array.shape
    with open(path, 'wb') as f:
        f.write(f'{w}&{h}&{c}&'.encode('ascii'))
        f.write(np.transpose(array, (1, 0, 2)).astype('<f4').tobytes(
            order='F'))


# ---------------------------------------------------------------------------
# generic point-cloud PLY (property-preserving)
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    'float': '<f4', 'float32': '<f4', 'double': '<f8', 'float64': '<f8',
    'uchar': 'u1', 'uint8': 'u1', 'char': 'i1', 'int8': 'i1',
    'ushort': '<u2', 'uint16': '<u2', 'short': '<i2', 'int16': '<i2',
    'uint': '<u4', 'uint32': '<u4', 'int': '<i4', 'int32': '<i4',
}
_PLY_NAMES = {'<f4': 'float', '<f8': 'double', '|u1': 'uchar',
              '|i1': 'char', '<u2': 'ushort', '<i2': 'short',
              '<u4': 'uint', '<i4': 'int'}


def read_ply_points(path: str) -> Dict[str, np.ndarray]:
    """Read a binary/ascii PLY's vertex element as {property: [N] array}."""
    with open(path, 'rb') as f:
        data = f.read()
    end = data.find(b'end_header\n') + len(b'end_header\n')
    header = data[:end].decode('ascii', 'ignore').splitlines()
    body = data[end:]

    fmt = 'binary_little_endian'
    n_v = 0
    props: List[tuple] = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'format':
            fmt = parts[1]
        elif parts[0] == 'element':
            in_vertex = parts[1] == 'vertex'
            if in_vertex:
                n_v = int(parts[2])
        elif parts[0] == 'property' and in_vertex:
            if parts[1] == 'list':
                raise ValueError('list property on vertex element')
            props.append((parts[2], _PLY_DTYPES[parts[1]]))

    if fmt == 'ascii':
        rows = np.loadtxt(
            [ln for ln in body.decode('ascii').splitlines() if ln.strip()],
            ndmin=2)[:n_v]
        return {name: rows[:, i].astype(dt)
                for i, (name, dt) in enumerate(props)}
    if fmt != 'binary_little_endian':
        raise NotImplementedError(fmt)
    rec_dt = np.dtype([(name, dt) for name, dt in props])
    rec = np.frombuffer(body, rec_dt, n_v)
    return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def write_ply_points(path: str, props: Dict[str, np.ndarray]):
    """Write a binary point-cloud PLY with the given named properties."""
    names = list(props)
    n = len(props[names[0]])
    arrays = {k: np.asarray(v).reshape(n) for k, v in props.items()}
    rec_dt = np.dtype([(k, arrays[k].dtype.str.replace('>', '<'))
                       for k in names])
    rec = np.zeros(n, rec_dt)
    for k in names:
        rec[k] = arrays[k]
    with open(path, 'wb') as f:
        hdr = ['ply', 'format binary_little_endian 1.0',
               f'element vertex {n}']
        for k in names:
            hdr.append(f'property {_PLY_NAMES[rec_dt[k].str]} {k}')
        hdr.append('end_header')
        f.write(('\n'.join(hdr) + '\n').encode())
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# fused point cloud + visibility
# ---------------------------------------------------------------------------

class FusedPoint(NamedTuple):
    position: np.ndarray          # [3] float
    color: np.ndarray             # [3] uint8
    normal: np.ndarray            # [3] float
    visible_image_idxs: np.ndarray  # [k] int


def read_fused(ply_path: str, vis_path: str) -> List[FusedPoint]:
    pts = read_ply_points(ply_path)
    xyz = np.stack([pts['x'], pts['y'], pts['z']], -1)
    nrm = np.stack([pts['nx'], pts['ny'], pts['nz']], -1)
    rgb = np.stack([pts['red'], pts['green'], pts['blue']], -1)
    out: List[FusedPoint] = []
    with open(vis_path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        if n != len(xyz):
            raise ValueError(f'vis count {n} != ply count {len(xyz)}')
        for i in range(n):
            (k,) = struct.unpack('<I', f.read(4))
            idxs = np.frombuffer(f.read(4 * k), '<u4').astype(np.int64)
            out.append(FusedPoint(xyz[i], rgb[i], nrm[i], idxs))
    return out


def write_fused(points: List[FusedPoint], ply_path: str, vis_path: str):
    xyz = np.asarray([p.position for p in points], np.float32)
    nrm = np.asarray([p.normal for p in points], np.float32)
    rgb = np.asarray([p.color for p in points], np.uint8)
    write_ply_points(ply_path, {
        'x': xyz[:, 0], 'y': xyz[:, 1], 'z': xyz[:, 2],
        'nx': nrm[:, 0], 'ny': nrm[:, 1], 'nz': nrm[:, 2],
        'red': rgb[:, 0], 'green': rgb[:, 1], 'blue': rgb[:, 2]})
    with open(vis_path, 'wb') as f:
        f.write(struct.pack('<Q', len(points)))
        for p in points:
            idxs = np.asarray(p.visible_image_idxs, '<u4')
            f.write(struct.pack('<I', len(idxs)))
            f.write(idxs.tobytes())
