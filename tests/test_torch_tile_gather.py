"""The plain versions of the four tile gathers (ops/tile_gather.py), held
to the references the JAX probes themselves check against
(scripts/microbench_r3.py: ``table[idx]`` and ``np.take_along_axis``),
without Pallas, at every shape the probes run and at ragged shapes; the
kernels' launch geometry; and the microbench entry point on the CPU at
its small size.  A gather copies bits: equality is exact.  The kernels
themselves run only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu_torch.bench import microbench_r3
from tensoflow_tpu_torch.ops import tile_gather as tg

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

CASES = microbench_r3.gather_cases(small=True)
ALL_CASES = CASES + microbench_r3.ragged_gather_cases()


@pytest.mark.parametrize('case', ALL_CASES, ids=[c[0] for c in ALL_CASES])
def test_plain_gather_matches_the_probe_reference(case):
    name, fn, plain, tshape, dtype, ishape, hi = case
    rng = np.random.RandomState(0)
    table = rng.randn(*tshape).astype(np.float32)
    idx = rng.randint(0, hi, ishape).astype(np.int32)
    if dtype == torch.bfloat16:
        jt = jnp.asarray(table).astype(jnp.bfloat16)
        ref = np.asarray(jt[idx[:, 0]].astype(jnp.float32))
        t = torch.tensor(np.asarray(jt.astype(jnp.float32))).to(dtype)
    else:
        t = torch.tensor(table)
        ref = (np.take_along_axis(table, idx, axis=1) if name.startswith('lane_gather')
               else table[idx[:, 0]])
    tg.reset_launches()
    got = fn(t, torch.tensor(idx))          # CPU tensors: the plain version
    assert got.dtype == dtype and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert torch.equal(got, plain(t, torch.tensor(idx)))
    assert tg.LAUNCHES == {'row_gather_tile': 0, 'row_gather_grid': 0,
                           'lane_gather_tile': 0, 'row_gather_tile_bf16': 0}


def _moves(geometry, n_rows, row_bytes):
    """How often the row kernel's walk (csrc/tile_gather.cu) moves each
    (row, 512-byte chunk) under ``geometry``; asserts that every chunk
    lies inside the row."""
    blocks, warps, chunks = geometry
    w16 = row_bytes // 16
    assert blocks % chunks == 0 and 1 <= warps <= 8
    stride = blocks // chunks * warps
    b = np.arange(blocks)[:, None]
    c = np.broadcast_to(b % chunks, (blocks, warps))
    assert (32 * c < w16).all()      # a chunk's first word lies in the row
    r = b // chunks * warps + np.arange(warps)[None, :]
    moves = np.zeros((n_rows, chunks), np.int64)
    while (r < n_rows).any():
        np.add.at(moves, (r[r < n_rows], c[r < n_rows]), 1)
        r = r + stride
    return moves


# (rows, row bytes): f32 L=128 / 512 / 1280, bf16 L=1280, the gridded probe
PROBE_ROWS = [(256, 512), (256, 2048), (256, 5120), (256, 2560),
              (512 * 256, 5120)]
RAGGED_ROWS = [(257, 16), (777, 400), (4099, 1288 * 4), (333, 80), (61, 16),
               (1, 16), (3, 70000 * 16)]


@pytest.mark.parametrize('n_sm', [132, 114])
@pytest.mark.parametrize('n_rows,row_bytes', PROBE_ROWS + RAGGED_ROWS)
def test_row_gather_geometry_moves_every_chunk_once(n_rows, row_bytes, n_sm):
    """Every (row, chunk) is moved exactly once, inside the row's bytes;
    a single 256-row tile (f32 L=128 / 512 / 1280, bf16 L=1280) gives
    every SM a block; the gridded probe runs blocks of 8 warps."""
    g = tg.row_gather_geometry(n_rows, row_bytes, n_sm)
    assert (_moves(g, n_rows, row_bytes) == 1).all()
    blocks, warps, _ = g
    if n_rows == 256:
        assert blocks >= n_sm
    if n_rows == 512 * 256:
        assert warps == 8


@pytest.mark.parametrize('n_rows,width', [(256, 128), (256, 512), (256, 4),
                                          (257, 100), (33, 37), (600, 1100),
                                          (256, 12288), (1, 1), (5, 6)])
def test_lane_gather_geometry_fills_the_card(n_rows, width):
    """One block a row (256 rows: every SM has work), whole warps, a
    thread per four columns where the width allows 16-byte words."""
    blocks, threads, vec = tg.lane_gather_geometry(n_rows, width)
    assert blocks == n_rows and vec == (width % 4 == 0)
    assert threads % 32 == 0 and 32 <= threads <= tg.LANE_THREADS
    units = width // 4 if vec else width
    assert min(units, tg.LANE_THREADS) <= threads < units + 32


def test_plain_row_gather_raises_on_an_index_out_of_range():
    t = torch.zeros(4, 8)
    with pytest.raises(IndexError):
        tg.row_gather_tile(t, torch.tensor([0, 4], dtype=torch.int32))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The argument checks of the CUDA path, reached without a card."""
    t = torch.zeros(4, 8)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match='on the card'):
        tg._check('row_gather_tile', t, i, torch.float32)
    with pytest.raises(ValueError, match='on the card'):
        tg._row_gather_cuda('row_gather_tile', t, i, torch.float32)


def test_microbench_runs_small_on_the_cpu(capsys):
    out = microbench_r3.main(['--device', 'cpu', '--small'])
    text = capsys.readouterr().out
    assert 'cpu' in text.splitlines()[0]
    assert sum('ok=True' in l for l in text.splitlines()) == len(CASES)
    assert len(out) == len(CASES) + 4 + 5
    assert all(v >= 0 for v in out.values())

