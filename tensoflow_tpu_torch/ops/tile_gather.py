"""Gathers from a tile staged in shared memory: the card's counterpart of
the four Pallas probes of scripts/microbench_r3.py.

    probe (microbench_r3.py)        wrapper here
    kern   :68   row gather, f32    row_gather_tile
    kern_g :98   the same, gridded  row_gather_grid
    kern2  :126  lane gather, f32   lane_gather_tile
    kern3  :155  row gather, bf16   row_gather_tile_bf16

The kernels are csrc/tile_gather.cu (its header says how they stage the
table and what bounds them: bytes moved over the HBM rate; a gather does
no arithmetic).  Each wrapper launches its kernel for a CUDA tensor and
computes its plain version (``*_plain``) only for a CPU tensor; a kernel
that fails to build or launch raises.  ``LAUNCHES`` counts launches per
probe.  No gradient: the probes have none.  Indices are int32 and must be
in range: the plain version raises otherwise, the kernel does not check.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .stencil import check_current_device

LAUNCHES = {'row_gather_tile': 0, 'row_gather_grid': 0,
            'lane_gather_tile': 0, 'row_gather_tile_bf16': 0}
SLAB_BYTES = 512             # slab width per table row (tile_gather.cu)
MAX_SMEM = 232448
N_SM = 132


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def row_gather_plain(table, idx):
    """out[r, :] = table[idx[r], :]; idx [N] or [N, 1]."""
    return table[idx.reshape(-1).long()]


def lane_gather_plain(table, idx):
    """out[r, c] = table[r, idx[r, c]]."""
    return torch.take_along_dim(table, idx.long(), dim=1)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _fn(name, n_ints):
    fn = getattr(cuda_build.load('tile_gather'), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, table, idx, dtype):
    for t, what in ((table, 'table'), (idx, 'idx')):
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError(f'{name}: {what} must be a contiguous tensor '
                             'on the card')
    if table.dtype != dtype or table.ndim != 2:
        raise ValueError(f'{name}: table must be a 2-D {dtype} tensor, got '
                         f'{tuple(table.shape)} {table.dtype}')
    if idx.dtype != torch.int32:
        raise ValueError(f'{name}: idx must be int32, got {idx.dtype}')
    check_current_device(table, name)


def _row_gather_cuda(name, table, idx, dtype, grid_y=None):
    _check(name, table, idx, dtype)
    rows, width = table.shape
    row_bytes = width * table.element_size()
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    if idx.ndim != 1:
        raise ValueError(f'{name}: idx must be [N] or [N, 1]')
    if row_bytes % 16 or rows * SLAB_BYTES > MAX_SMEM:
        raise ValueError(f'{name}: needs rows of a multiple of 16 bytes and '
                         f'at most {MAX_SMEM // SLAB_BYTES} table rows, got '
                         f'{tuple(table.shape)} {table.dtype}')
    n = idx.shape[0]
    if grid_y is None:
        # at most two blocks per SM over all slabs (no ragged last wave),
        # and a block walks >= 256 rows: loading its slab costs as much as
        # copying 256 rows
        slabs = -(-row_bytes // SLAB_BYTES)
        grid_y = max(1, min(2 * N_SM // slabs, -(-n // 256)))
    out = torch.empty((n, width), dtype=table.dtype, device=table.device)
    err = _fn('tile_row_gather', 4)(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, row_bytes,
        n, grid_y, torch.cuda.current_stream(table.device).cuda_stream)
    cuda_build.check(err, name)
    LAUNCHES[name] += 1
    return out


def row_gather_tile(table, idx):
    """Probe kern (:68): float32 table [T, L], idx [T] or [T, 1] int32 ->
    [T, L], gathered inside one resident tile."""
    if table.device.type == 'cpu':
        return row_gather_plain(table, idx)
    return _row_gather_cuda('row_gather_tile', table, idx, torch.float32)


def row_gather_grid(table, idx):
    """Probe kern_g (:98): the same gather for many row tiles against one
    resident float32 table: idx [N] or [N, 1] int32 -> [N, L]."""
    if table.device.type == 'cpu':
        return row_gather_plain(table, idx)
    return _row_gather_cuda('row_gather_grid', table, idx, torch.float32)


def row_gather_tile_bf16(table, idx):
    """Probe kern3 (:155): row_gather_tile on a bfloat16 table."""
    if table.device.type == 'cpu':
        return row_gather_plain(table, idx)
    return _row_gather_cuda('row_gather_tile_bf16', table, idx,
                            torch.bfloat16)


def lane_gather_tile(table, idx):
    """Probe kern2 (:126): float32 table [T, L], idx [T, L] int32 ->
    out[r, c] = table[r, idx[r, c]]."""
    if table.device.type == 'cpu':
        return lane_gather_plain(table, idx)
    name = 'lane_gather_tile'
    _check(name, table, idx, torch.float32)
    rows, width = table.shape
    if tuple(idx.shape) != (rows, width) or 32 * width > MAX_SMEM:
        raise ValueError(f'{name}: idx must have the table\'s shape '
                         f'{tuple(table.shape)} (width <= {MAX_SMEM // 32}),'
                         f' got {tuple(idx.shape)}')
    out = torch.empty_like(table)
    err = _fn('tile_lane_gather', 2)(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, width,
        torch.cuda.current_stream(table.device).cuda_stream)
    cuda_build.check(err, name)
    LAUNCHES[name] += 1
    return out
