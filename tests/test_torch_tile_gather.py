"""The plain versions of the four tile gathers (ops/tile_gather.py), held
to the references the JAX probes themselves check against
(scripts/microbench_r3.py: ``table[idx]`` and ``np.take_along_axis``),
without Pallas, at every shape the probes run; and the microbench entry
point on the CPU at its small size.  A gather copies bits: equality is
exact.  The kernels themselves run only on the card (chip_smoke.py).
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


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
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
