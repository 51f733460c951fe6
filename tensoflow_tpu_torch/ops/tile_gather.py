"""Row and lane gathers on the card: the counterpart of the four Pallas
probes of scripts/microbench_r3.py.

    probe (microbench_r3.py)        wrapper here
    kern   :68   row gather, f32    row_gather_tile
    kern_g :98   the same, gridded  row_gather_grid
    kern2  :126  lane gather, f32   lane_gather_tile
    kern3  :155  row gather, bf16   row_gather_tile_bf16

The kernels are csrc/tile_gather.cu.  Its header says what bounds them
(bytes moved over the HBM rate, and for a single tile the latency of two
dependent loads and the launch floor) and how they are laid out: the row
gather reads the table straight from global memory, where L2 serves the
repeated rows, one row x one 512-byte column chunk a warp over a grid
that gives every SM work (``row_gather_geometry``); the lane
gather stages one row a block in shared memory and moves 16 bytes at a
time (``lane_gather_geometry``).  Each wrapper launches its kernel for a
CUDA tensor and computes its plain version (``*_plain``) only for a CPU
tensor; a kernel that fails to build or launch raises.  ``LAUNCHES``
counts launches per probe.  No gradient: the probes have none.  Indices
are int32 and must be in range: the plain version raises otherwise, the
kernel does not check.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.timing import launch_counter
from . import cuda_build
from .stencil import check_current_device

LAUNCHES = launch_counter({'row_gather_tile': 0, 'row_gather_grid': 0,
                           'lane_gather_tile': 0, 'row_gather_tile_bf16': 0})
N_SM = 132                   # the H100's SMs
CHUNK_BYTES = 512            # a warp's share of one row (tile_gather.cu)
LANE_THREADS = 256           # at most, lane gather
LANE_SMEM = 48 * 1024        # the lane gather's row in shared memory


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
# launch geometry
# ---------------------------------------------------------------------------

def row_gather_geometry(n_rows, row_bytes, n_sm=N_SM):
    """(blocks, warps a block, chunks) for tile_row_gather.

    A unit is one row x one 512-byte column chunk, moved by one warp;
    block b serves chunk b % chunks and rows (b // chunks) * warps + w, a
    warp w a row.  The warps a block are the most (<= 8) that still leave
    a block an SM; the grid covers every row in one pass (the H100
    readings behind these choices: csrc/tile_gather.cu)."""
    chunks = -(-(row_bytes // 16) // (CHUNK_BYTES // 16))
    warps = next((w for w in (8, 4, 2)
                  if chunks * -(-n_rows // w) >= n_sm), 1)
    return chunks * -(-n_rows // warps), warps, chunks


def lane_gather_geometry(n_rows, width):
    """(blocks, threads, vec) for tile_lane_gather: one block a table row,
    a thread per four columns (per column where the width is not a
    multiple of four: vec false), at most LANE_THREADS."""
    vec = width % 4 == 0
    units = width // 4 if vec else width
    return n_rows, min(LANE_THREADS, max(32, -(-units // 32) * 32)), vec


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


@functools.lru_cache(maxsize=None)
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _row_gather_cuda(name, table, idx, dtype):
    _check(name, table, idx, dtype)
    width = table.shape[1]
    row_bytes = width * table.element_size()
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    if idx.ndim != 1:
        raise ValueError(f'{name}: idx must be [N] or [N, 1]')
    if row_bytes <= 0 or row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f'{name}: needs rows of a multiple of 16 bytes and '
                         f'a table aligned to 16 bytes, got '
                         f'{tuple(table.shape)} {table.dtype}')
    n = idx.shape[0]
    blocks, warps, _ = row_gather_geometry(n, row_bytes,
                                           _n_sm(table.device.index))
    out = torch.empty((n, width), dtype=table.dtype, device=table.device)
    err = _fn('tile_row_gather', 4)(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), row_bytes, n,
        blocks, warps, torch.cuda.current_stream(table.device).cuda_stream)
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
    if tuple(idx.shape) != (rows, width) or 4 * width > LANE_SMEM:
        raise ValueError(f'{name}: idx must have the table\'s shape '
                         f'{tuple(table.shape)} (width <= {LANE_SMEM // 4}),'
                         f' got {tuple(idx.shape)}')
    out = torch.empty_like(table)
    blocks, threads, vec = lane_gather_geometry(rows, width)
    vec = vec and not (table.data_ptr() | idx.data_ptr()) % 16
    err = _fn('tile_lane_gather', 4)(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), blocks, width,
        threads, int(vec), torch.cuda.current_stream(table.device).cuda_stream)
    cuda_build.check(err, name)
    LAUNCHES[name] += 1
    return out
