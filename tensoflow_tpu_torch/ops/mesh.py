"""Mesh extraction and IO of the port (counterpart of
tensoflow_tpu/ops/mesh.py): marching tetrahedra over a dense SDF sampled
chunk by chunk, and binary PLY read/write.

The isosurfacer is host C++: the port keeps its own copy of the JAX
package's source in csrc/marching_tets.cpp, compiles it with the host
compiler into build/kernels/ (beside the CUDA kernels, named by a hash of
the source) at first use, and binds it with ctypes.
"""
from __future__ import annotations

import ctypes
import os
from typing import Callable, Tuple

import numpy as np

from . import cuda_build
from .cuda_build import BUILD_DIR, CSRC

_SRC = os.path.join(CSRC, 'marching_tets.cpp')
_LIB = None


def _build_library() -> str:
    """Compile csrc/marching_tets.cpp with g++ unless a library of the
    same source is already built; returns its path."""
    return cuda_build.build_host(_SRC, BUILD_DIR)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build_library())
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
    return _LIB


def marching_tets(values: np.ndarray, iso: float = 0.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a [nx,ny,nz] scalar field. Returns (verts [V,3] in
    grid-index coords, tris [T,3] int32)."""
    values = np.ascontiguousarray(values, np.float32)
    nx, ny, nz = values.shape
    max_verts = max(4 * nx * ny * nz, 1 << 16)
    max_tris = 2 * max_verts
    verts = np.empty((max_verts, 3), np.float32)
    tris = np.empty((max_tris, 3), np.int32)
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    ret = _lib().marching_tets(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(iso),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_verts, max_tris, ctypes.byref(nv), ctypes.byref(nt))
    if ret != 0:
        raise RuntimeError('marching_tets: buffer overflow')
    return verts[:nv.value].copy(), tris[:nt.value].copy()


def extract_fields(bound_min, bound_max, resolution: int,
                   query_fn: Callable, batch: int = 64,
                   outside_val: float = 1.0) -> np.ndarray:
    """Chunked dense field evaluation (ref: network_utils.py:204-222):
    values outside the unit sphere forced to ``outside_val``."""
    xs = [np.linspace(bound_min[d], bound_max[d], resolution,
                      dtype=np.float32) for d in range(3)]
    u = np.zeros((resolution,) * 3, np.float32)
    for xi in range(0, resolution, batch):
        for yi in range(0, resolution, batch):
            for zi in range(0, resolution, batch):
                gx = xs[0][xi:xi + batch]
                gy = xs[1][yi:yi + batch]
                gz = xs[2][zi:zi + batch]
                xx, yy, zz = np.meshgrid(gx, gy, gz, indexing='ij')
                pts = np.stack([xx, yy, zz], -1).reshape(-1, 3)
                vals = np.asarray(query_fn(pts)).reshape(-1)
                outside = np.linalg.norm(pts, axis=-1) >= 1.0
                vals = np.where(outside, outside_val, vals)
                u[xi:xi + len(gx), yi:yi + len(gy), zi:zi + len(gz)] = \
                    vals.reshape(len(gx), len(gy), len(gz))
    return u


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn: Callable, outside_val: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(ref: network_utils.py:224-231) — marching tetrahedra over the
    evaluated field; vertices mapped to world coordinates."""
    u = extract_fields(bound_min, bound_max, resolution, query_fn,
                       outside_val=outside_val)
    verts, tris = marching_tets(u, threshold)
    b_min = np.asarray(bound_min, np.float32)
    b_max = np.asarray(bound_max, np.float32)
    verts = verts / (resolution - 1.0) * (b_max - b_min)[None] + b_min[None]
    return verts, tris


# ---------------------------------------------------------------------------
# PLY IO
# ---------------------------------------------------------------------------

def write_ply(path: str, verts: np.ndarray, tris: np.ndarray,
              vert_colors: np.ndarray = None):
    """Binary little-endian PLY writer (replaces plyfile)."""
    n_v, n_t = len(verts), len(tris)
    with open(path, 'wb') as f:
        hdr = ['ply', 'format binary_little_endian 1.0',
               f'element vertex {n_v}',
               'property float x', 'property float y', 'property float z']
        if vert_colors is not None:
            hdr += ['property uchar red', 'property uchar green',
                    'property uchar blue']
        hdr += [f'element face {n_t}',
                'property list uchar int vertex_indices', 'end_header']
        f.write(('\n'.join(hdr) + '\n').encode())
        if vert_colors is not None:
            vc = np.clip(vert_colors * 255, 0, 255).astype(np.uint8)
            rec = np.zeros(n_v, dtype=[('xyz', np.float32, 3),
                                       ('rgb', np.uint8, 3)])
            rec['xyz'] = verts.astype(np.float32)
            rec['rgb'] = vc
            f.write(rec.tobytes())
        else:
            f.write(verts.astype('<f4').tobytes())
        face = np.zeros(n_t, dtype=[('n', np.uint8),
                                    ('idx', '<i4', 3)])
        face['n'] = 3
        face['idx'] = tris.astype(np.int32)
        f.write(face.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal binary/ascii PLY reader for vertex+face meshes."""
    with open(path, 'rb') as f:
        data = f.read()
    end = data.find(b'end_header\n') + len(b'end_header\n')
    header = data[:end].decode('ascii', 'ignore').splitlines()
    body = data[end:]

    fmt = 'binary_little_endian'
    n_v = n_f = 0
    vert_props = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'format':
            fmt = parts[1]
        elif parts[0] == 'element':
            in_vertex = parts[1] == 'vertex'
            if parts[1] == 'vertex':
                n_v = int(parts[2])
            elif parts[1] == 'face':
                n_f = int(parts[2])
        elif parts[0] == 'property' and in_vertex and parts[1] != 'list':
            vert_props.append((parts[2], parts[1]))

    type_map = {'float': '<f4', 'float32': '<f4', 'double': '<f8',
                'uchar': 'u1', 'uint8': 'u1', 'int': '<i4', 'uint': '<u4'}
    if fmt == 'ascii':
        text = body.decode()
        rows = text.splitlines()
        vdata = np.array([[float(x) for x in r.split()[:3]]
                          for r in rows[:n_v]], np.float32)
        fdata = np.array([[int(x) for x in r.split()[1:4]]
                          for r in rows[n_v:n_v + n_f]], np.int32)
        return vdata, fdata

    vdt = np.dtype([(name, type_map[t]) for name, t in vert_props])
    vrec = np.frombuffer(body, dtype=vdt, count=n_v)
    verts = np.stack([vrec['x'], vrec['y'], vrec['z']], -1).astype(np.float32)
    off = n_v * vdt.itemsize
    fdt = np.dtype([('n', 'u1'), ('idx', '<i4', 3)])
    frec = np.frombuffer(body, dtype=fdt, count=n_f, offset=off)
    return verts, frec['idx'].astype(np.int32)
