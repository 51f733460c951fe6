"""Port stencil head (tensoflow_tpu_torch/ops/stencil.py) vs the JAX
Pallas head run in interpret mode.

The plain PyTorch version's outputs and autograd grads are held to the
JAX `_head` custom VJP (interpret mode, f32) at rtol 1e-6 / atol 2e-6 —
the tolerance of the JAX package's own test_head_vjp_exact.  A second
test holds the CUDA wrapper's CPU dispatch and argument checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.ops import pallas_stencil as ps
from tensoflow_tpu_torch.ops import stencil as pst

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 2e-6


def _inputs(S, B, dynamic, seed=0, C=4, E=5, H=8, O=3, N=16,
            fan_in=False):
    """Head inputs from a seed; with ``fan_in`` the weights are scaled by
    their fan-in's inverse square root (as a layer's init is), which keeps
    z and the outputs O(1) at wide heads."""
    rng = np.random.RandomState(seed)
    pp = [(rng.randn(N, 16 * C) * 0.3).astype(np.float32)
          for _ in range(3 * B)]
    lp = [(rng.randn(N, 4 * C) * 0.3).astype(np.float32)
          for _ in range(3 * B)]
    fr = np.zeros((N, 2 * ps.FS), np.float32)
    sig_static = []
    for b in range(B):
        o = b * ps.FS
        fr[:, o:o + 9] = rng.rand(N, 9)
        fr[:, o + 9] = rng.rand(N) if B > 1 else 1.0
        if dynamic:
            fr[:, o + 10:o + 19] = rng.uniform(0.3, 1.0, (N, 9))
            sig_static.append(None)
        else:
            sig_static.append(((1.0, 0.9, 0.8), (0.7, 0.6, 0.5),
                               (1.0, 1.0, 1.0))[:3])
    pe = (rng.randn(N, E) * 0.3).astype(np.float32)
    rot = (rng.randn(S, 4, E) * 0.5).astype(np.float32)
    s0 = (3 * C + E) ** -0.5 if fan_in else 0.3
    s1 = H ** -0.5 if fan_in else 0.3
    w0p = [(rng.randn(d, H) * s0).astype(np.float32) for d in (C, C, C, E)]
    b0 = (rng.randn(H) * 0.3).astype(np.float32)
    w1 = (rng.randn(H, O) * s1).astype(np.float32)
    b1 = (rng.randn(O) * 0.3).astype(np.float32)
    return dict(pp=pp, lp=lp, fr=fr, sigmas=tuple(sig_static), pe=pe,
                rot=rot, w0p=w0p, b0=b0, w1=w1, b1=b1, C=C, N=N)


def _jax_head(S, B, d):
    """Loss, outputs and grads of the JAX head (interpret mode)."""
    static = (S, 8, 'float32', B, d['C'], d['sigmas'], True)
    fr = jnp.asarray(d['fr'])
    rot = jnp.asarray(d['rot'])

    def outs(args):
        pp, lp, pe, w0p, b0, w1, b1 = args
        oc, oo = ps._head(static, tuple(pp), tuple(lp), fr, pe, rot,
                          tuple(w0p), b0, w1)
        oc = oc + b1[None, :]
        return oc, (oo + b1[0] if oo is not None else None)

    def loss(args):
        oc, oo = outs(args)
        tot = jnp.sum(oc ** 2)
        return tot + (jnp.sum(oo ** 2) if oo is not None else 0.0)

    args = ([jnp.asarray(x) for x in d['pp']],
            [jnp.asarray(x) for x in d['lp']], jnp.asarray(d['pe']),
            [jnp.asarray(x) for x in d['w0p']], jnp.asarray(d['b0']),
            jnp.asarray(d['w1']), jnp.asarray(d['b1']))
    oc, oo = outs(args)
    grads = jax.grad(loss)(args)
    return oc, oo, grads


def _torch_head(S, B, d):
    t = {k: [torch.tensor(x, requires_grad=True) for x in d[k]]
         for k in ('pp', 'lp', 'w0p')}
    pe = torch.tensor(d['pe'], requires_grad=True)
    b0 = torch.tensor(d['b0'], requires_grad=True)
    w1 = torch.tensor(d['w1'], requires_grad=True)
    b1 = torch.tensor(d['b1'], requires_grad=True)
    fr = torch.tensor(d['fr'])
    rot = torch.tensor(d['rot'])
    if S == 7:
        oc, oo = pst.stencil_head(t['pp'], t['lp'], fr, d['sigmas'], pe,
                                  rot, t['w0p'], b0, w1, b1)
        loss = torch.sum(oc ** 2) + torch.sum(oo ** 2)
    else:
        oc = pst.point_head(t['pp'], t['lp'], fr, d['sigmas'], pe, t['w0p'],
                            b0, w1, b1)
        oo = None
        loss = torch.sum(oc ** 2)
    loss.backward()
    grads = ([p.grad for p in t['pp']], [p.grad for p in t['lp']], pe.grad,
             [p.grad for p in t['w0p']], b0.grad, w1.grad, b1.grad)
    return oc, oo, grads


@pytest.mark.parametrize('S,B,dynamic', [(7, 1, False), (7, 2, True),
                                         (1, 1, False), (1, 2, True),
                                         (7, 1, True)])
def test_plain_head_matches_jax_head(S, B, dynamic):
    d = _inputs(S, B, dynamic, seed=S + 10 * B)
    joc, joo, jg = _jax_head(S, B, d)
    toc, too, tg = _torch_head(S, B, d)
    np.testing.assert_allclose(toc.detach().numpy(), np.asarray(joc),
                               rtol=RTOL, atol=ATOL)
    if S == 7:
        np.testing.assert_allclose(too.detach().numpy(), np.asarray(joo),
                                   rtol=RTOL, atol=ATOL)
    jl = jax.tree_util.tree_leaves(jg)
    tl = [g for g in jax.tree_util.tree_leaves(
        tg, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(jl) == len(tl)
    for k, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL, err_msg=f'grad leaf {k}')


def test_plain_head_bf16_close_to_f32():
    """bf16 compute path stays within bf16 tolerance of f32 (the
    tolerance of the JAX package's test_stencil_head_bf16_close)."""
    d = _inputs(7, 1, False, seed=3, C=8, E=9, H=32, O=5, N=64)
    args = [torch.tensor(d['fr']), d['sigmas'], torch.tensor(d['pe']),
            torch.tensor(d['rot']), [torch.tensor(x) for x in d['w0p']],
            torch.tensor(d['b0']), torch.tensor(d['w1']),
            torch.tensor(d['b1'])]
    f32 = pst.stencil_head([torch.tensor(x) for x in d['pp']],
                           [torch.tensor(x) for x in d['lp']], *args)
    b16 = pst.stencil_head([torch.tensor(x).bfloat16() for x in d['pp']],
                           [torch.tensor(x).bfloat16() for x in d['lp']],
                           *args)
    assert float((f32[0] - b16[0]).abs().max()) < 0.1
    assert float((f32[1] - b16[1]).abs().max()) < 0.05


def test_pe_rot_layout_and_mapping():
    """Mapping table and widths match the JAX package's."""
    assert pst.MAPPING7 == ps.MAPPING7
    assert pst.MAPPING1 == ps.MAPPING1
    assert pst.vw(7, 36) == ps._vw(7, 36)
    assert 3 * 36 + 21 < pst.XP == pst.F32_XP == 144


# ---------------------------------------------------------------------------
# host-side layouts of the bf16 (wgmma) kernels
# ---------------------------------------------------------------------------

def _tiled_offset(a, b, width):
    """Element offset of (a, b) in the kernels' operand layout
    (csrc/stencil_sm90.cuh `tiled`, in elements instead of bytes)."""
    return (a // 8) * (width * 8) + (b // 8) * 64 + (a % 8) * 8 + b % 8


@pytest.mark.parametrize('rows,cols', [(8, 8), (16, 24), (144, 256),
                                       (128, 144), (16, 144)])
def test_tile_matrix_round_trips(rows, cols):
    """tile_matrix puts element (a, b) where the kernels read it, and
    untile_matrix brings the plain layout back."""
    m = torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols)
    flat = pst.tile_matrix(m)
    assert flat.shape == (rows * cols,)
    rng = np.random.RandomState(rows + cols)
    for a, b in zip(rng.randint(0, rows, 32), rng.randint(0, cols, 32)):
        assert flat[_tiled_offset(a, b, cols)] == m[a, b]
    assert torch.equal(pst.untile_matrix(flat, rows, cols), m)
    with pytest.raises(ValueError):
        pst.tile_matrix(torch.zeros(rows + 1, cols))


@pytest.mark.parametrize('C,E,H,O', [(36, 21, 256, 129), (4, 5, 8, 3),
                                     (8, 9, 32, 5)])
def test_pack_weights_bf16_round_trips(C, E, H, O):
    """The padded, tiled weight operands hold the bf16-rounded weights at
    their plain positions, zeros elsewhere; padding changes no product."""
    rng = np.random.RandomState(C)
    k0 = 3 * C + E
    w0 = torch.tensor(rng.randn(k0, H).astype(np.float32))
    b0 = torch.tensor(rng.randn(H).astype(np.float32))
    w1 = torch.tensor(rng.randn(H, O).astype(np.float32))
    w0t, b0p, w1t, w1row = pst.pack_weights_bf16(w0, b0, w1)
    assert w0t.dtype == torch.bfloat16 and w1t.dtype == torch.bfloat16
    w0u = pst.untile_matrix(w0t, pst.XP, pst.HP)
    w1u = pst.untile_matrix(w1t, pst.OP, pst.HP)          # W1^T
    assert torch.equal(w0u[:k0, :H], w0.bfloat16())
    assert torch.equal(w1u[:O, :H], w1.t().bfloat16())
    assert float(w0u[k0:].abs().max()) == 0 and float(w0u[:, H:].abs().sum()) == 0
    assert float(w1u[O:].abs().sum()) == 0 and float(w1u[:, H:].abs().sum()) == 0
    assert torch.equal(b0p[:H], b0) and float(b0p[H:].abs().sum()) == 0
    assert torch.equal(w1row[:H], w1[:, 0].bfloat16().float())
    # a padded X row (zero pad columns, the last one 1) through the padded
    # operands gives the plain z and head outputs (f32 sums over another
    # width: rtol 1e-5)
    x = torch.tensor(rng.randn(5, k0).astype(np.float32)).bfloat16()
    xp = torch.zeros(5, pst.XP)
    xp[:, :k0] = x.float()
    xp[:, pst.XP - 1] = 1.0
    z = xp @ w0u.float() + b0p
    np.testing.assert_allclose(z[:, :H].numpy(),
                               (x.float() @ w0.bfloat16().float() + b0).numpy(),
                               rtol=1e-5, atol=1e-4)
    h = torch.nn.functional.softplus(z, beta=100).bfloat16().float()
    np.testing.assert_allclose(
        (h @ w1u.float().t())[:, :O].numpy(),
        (h[:, :H] @ w1.bfloat16().float()).numpy(), rtol=1e-5, atol=1e-4)
    # and its last column turns the dW0 product into db0
    dz = torch.tensor(rng.randn(5, pst.HP).astype(np.float32))
    np.testing.assert_allclose((dz.t() @ xp)[:, pst.XP - 1].numpy(),
                               dz.sum(0).numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('widths', [dict(k0=144, h=256, o=129),
                                    dict(k0=129, h=264, o=129),
                                    dict(k0=129, h=256, o=145)])
def test_pack_weights_bf16_refuses_what_the_kernels_do_not_take(widths):
    with pytest.raises(ValueError):
        pst.pack_weights_bf16(torch.zeros(widths['k0'], widths['h']),
                              torch.zeros(widths['h']),
                              torch.zeros(widths['h'], widths['o']))


@pytest.mark.parametrize('S', [1, 7])
@pytest.mark.parametrize('n', [1, 520, 1003, 131072])
def test_bf16_tiles_and_workspace_sizing(S, n):
    """Row tiles cover a ragged N; the workspace holds, per tile, X, dz,
    the centre h and cotangent, and one partial per block."""
    tn = pst.tile_rows(S)
    assert tn * (7 + 1 if S > 1 else 1) == pst.MR
    tiles = -(-n // tn)
    assert (tiles - 1) * tn < n <= tiles * tn
    n_sm = 132
    total = pst.workspace_bytes_bf16(S, n_sm, n)
    assert total % 256 == 0
    per_tile = 2 * (pst.MR * pst.XP + pst.MR * pst.HP + tn * pst.HP
                    + tn * pst.OP)
    blocks = min(tiles, n_sm)
    partials = 4 * pst.HP * (blocks * (1 + pst.XP)
                             + min(-(-tiles * tn // pst.MR), n_sm) * pst.OP)
    assert tiles * per_tile + partials <= total
    assert total < tiles * per_tile + partials + 7 * 256
    # one more row never shrinks it; a full extra tile grows it
    assert pst.workspace_bytes_bf16(S, n_sm, n + 1) >= total
    assert pst.workspace_bytes_bf16(S, n_sm, n + tn) > total


# ---------------------------------------------------------------------------
# host-side layouts of the float32 kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('C,E,H,O', [(36, 21, 256, 129), (16, 21, 128, 65),
                                     (4, 5, 8, 3), (2, 3, 16, 9)])
def test_pack_weights_f32_round_trips(C, E, H, O):
    """The padded float32 operands hold the weights at their plain
    positions, zeros elsewhere; a padded X row (ones in the last column)
    through them gives the plain z and head outputs, its ones column turns
    the dW0 product into db0, and the transposed dW1 product is dW1."""
    rng = np.random.RandomState(C + H)
    k0 = 3 * C + E
    w0 = torch.tensor(rng.randn(k0, H).astype(np.float32))
    b0 = torch.tensor(rng.randn(H).astype(np.float32))
    w1 = torch.tensor(rng.randn(H, O).astype(np.float32))
    w0p, b0p, w1p, w1row = pst.pack_weights_f32(w0, b0, w1)
    assert w0p.shape == (pst.F32_XP, pst.F32_HP) and w0p.dtype == torch.float32
    assert w1p.shape == (pst.F32_HP, pst.F32_OP) and b0p.shape == (pst.F32_HP,)
    assert torch.equal(w0p[:k0, :H], w0) and torch.equal(w1p[:H, :O], w1)
    assert torch.equal(b0p[:H], b0) and torch.equal(w1row[:H], w1[:, 0])
    assert float(w0p[k0:].abs().sum() + w0p[:, H:].abs().sum()) == 0
    assert float(w1p[H:].abs().sum() + w1p[:, O:].abs().sum()) == 0
    assert float(b0p[H:].abs().sum() + w1row[H:].abs().sum()) == 0
    x = torch.tensor(rng.randn(6, k0).astype(np.float32))
    xp = torch.zeros(6, pst.F32_XP)
    xp[:, :k0] = x
    xp[:, pst.F32_XP - 1] = 1.0
    z = (xp.double() @ w0p.double() + b0p.double())
    np.testing.assert_allclose(z[:, :H].numpy(),
                               (x.double() @ w0.double() + b0.double()).numpy(),
                               rtol=1e-12, atol=1e-12)
    h = torch.nn.functional.softplus(z, beta=100)
    np.testing.assert_allclose((h @ w1p.double())[:, :O].numpy(),
                               (h[:, :H] @ w1.double()).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((h @ w1row.double()).numpy(),
                               (h[:, :H] @ w1[:, 0].double()).numpy(),
                               rtol=1e-12, atol=1e-12)
    dz = torch.tensor(rng.randn(6, pst.F32_HP)).double()
    dw0 = xp.double().t() @ dz                      # [XP, HP]
    np.testing.assert_allclose(dw0[pst.F32_XP - 1].numpy(),
                               dz.sum(0).numpy(), rtol=1e-12)
    g = torch.zeros(6, pst.F32_OP).double()
    g[:, :O] = torch.tensor(rng.randn(6, O))
    dw1t = g.t() @ h                                # dW1^T [OP, HP]
    np.testing.assert_allclose(dw1t[:O, :H].t().numpy(),
                               (h[:, :H].t() @ g[:, :O]).numpy(), rtol=1e-12)


@pytest.mark.parametrize('widths', [dict(k0=144, h=256, o=129),
                                    dict(k0=129, h=264, o=129),
                                    dict(k0=129, h=256, o=145)])
def test_pack_weights_f32_refuses_what_the_kernels_do_not_take(widths):
    with pytest.raises(ValueError):
        pst.pack_weights_f32(torch.zeros(widths['k0'], widths['h']),
                             torch.zeros(widths['h']),
                             torch.zeros(widths['h'], widths['o']))


@pytest.mark.parametrize('S', [1, 7])
@pytest.mark.parametrize('n', [1, 520, 1003, 131072])
def test_f32_tiles_and_workspace_sizing(S, n):
    """Row tiles of 16 cover a ragged N; the persistent grids never exceed
    the tiles; the workspace holds, per tile, X, dz, the centre h and
    cotangent, one dw1row partial per row block and the split-K partials
    of dW0 and dW1^T, whose splits cover every row once."""
    tn = pst.F32_TR
    assert tn * 7 == pst.F32_MT
    tiles = pst.f32_tiles(n)
    assert (tiles - 1) * tn < n <= tiles * tn
    n_sm = 132
    for kern, per_sm in (('fwd', 2), ('bwd', 1)):
        grid = pst.f32_grid(kern, n_sm, n)
        assert grid == min(tiles, per_sm * n_sm)
        assert pst.f32_grid(kern, n_sm, n, per_sm=1) <= grid
    for k in (tiles * tn, tiles * tn * S):
        splits, chunk = pst.f32_splits(n_sm, k)
        assert chunk % pst.F32_AKC == 0 and chunk <= pst.F32_AKMAX
        assert splits <= max(n_sm, -(-k // pst.F32_AKMAX))
        assert (splits - 1) * chunk < k <= splits * chunk
    total = pst.workspace_bytes_f32(S, n_sm, n)
    assert total % 256 == 0
    per_tile = 4 * tn * (S * pst.F32_XP + S * pst.F32_HP + pst.F32_HP
                         + pst.F32_OP)
    part = 4 * pst.F32_XP * pst.F32_HP
    partials = (4 * pst.F32_HP * pst.f32_grid('bwd', n_sm, n)
                + part * (pst.f32_splits(n_sm, tiles * tn * S)[0]
                          + pst.f32_splits(n_sm, tiles * tn)[0]))
    assert tiles * per_tile + partials <= total
    assert total < tiles * per_tile + partials + 7 * 256
    assert pst.workspace_bytes_f32(S, n_sm, n + 1) >= total
    assert pst.workspace_bytes_f32(S, n_sm, n + tn) > total


def test_f32_shared_memory_fits_the_blocks_per_sm():
    """Each float32 kernel's shared memory fits one block's limit, and the
    blocks per SM it is built for fit the SM (the runtime keeps 1 KB of
    each block); the X tile takes the published widths (C=36, E=21,
    3C+E=129) and the toy ones the tests use (C=16 / 4 / 2)."""
    for kern in ('fwd', 'bwd', 'atb'):
        smem = pst.f32_smem_bytes(kern)
        assert smem <= pst.SMEM_PER_BLOCK
        assert (pst.F32_BLOCKS_PER_SM[kern] * (smem + pst.SMEM_RESERVED)
                <= pst.SMEM_PER_SM), kern
    assert pst.f32_smem_bytes('fwd') == 110848
    assert pst.f32_smem_bytes('bwd') == 217344
    for C, E in ((36, 21), (16, 21), (4, 5), (2, 3)):
        assert 3 * C + E < pst.F32_XP
    # 16 rows x 7 points fill the tile: 28 row groups of 4 rows, 16 column
    # groups, the threads the row kernels are built for
    assert pst.F32_MT // 4 * 16 == pst.F32_THREADS['fwd']
    assert pst.F32_MT // 4 * 16 == pst.F32_THREADS['bwd']
    assert pst.F32_XP // 8 * 16 == pst.F32_THREADS['atb']
    assert pst.F32_MS % 4 == 0 and pst.F32_MS >= pst.F32_MT


@pytest.mark.cuda
def test_f32_sizing_matches_the_library_on_the_card():
    """The card runs the float32 kernels at the blocks per SM they are
    built for, without spills, and the library allocates the workspace
    workspace_bytes_f32 documents."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run: python3 chip_smoke.py)')
    import ctypes
    lib = pst._lib('stencil_head_bwd', pst._BWD_ARGS)
    fwd = pst._lib('stencil_head_fwd', pst._FWD_ARGS)
    n_sm = pst._n_sm(torch.device('cuda'))
    for S in (1, 7):
        for B in (1, 2):
            buf = (ctypes.c_int * 4)()
            assert fwd.stencil_head_fwd_f32_info(S, B, buf) == 0
            assert (buf[0], buf[2], buf[3]) == (
                pst.F32_BLOCKS_PER_SM['fwd'], 0, pst.f32_smem_bytes('fwd'))
            assert lib.stencil_head_bwd_f32_info(0, S, B, buf) == 0
            assert (buf[0], buf[2], buf[3]) == (
                pst.F32_BLOCKS_PER_SM['bwd'], 0, pst.f32_smem_bytes('bwd'))
            for n in (1, 520, 1003, 131072):
                assert lib.stencil_head_bwd_workspace(
                    0, S, B, n_sm, n, 36, 21, 256, 129, pst.F32_XP) \
                    == pst.workspace_bytes_f32(S, n_sm, n)
    assert lib.stencil_head_bwd_f32_info(1, 0, 0, buf) == 0
    assert (buf[0], buf[2], buf[3]) == (
        pst.F32_BLOCKS_PER_SM['atb'], 0, pst.f32_smem_bytes('atb'))


# ---------------------------------------------------------------------------
# widths past the fast kernels: the general-width kernels' route
# ---------------------------------------------------------------------------

# NeuS's SDF network at the published C = 36 (E = 3 + 6*6 = 39, 3C+E = 147)
# with H and O just past the fast kernels' 256 and 144
WIDE = dict(C=36, E=39, H=264, O=150, N=16)


@pytest.mark.parametrize('S,B,dynamic', [(7, 2, True), (1, 1, False)])
def test_plain_head_matches_jax_head_past_the_fast_widths(S, B, dynamic):
    """The JAX Pallas head sizes its X scratch from the shapes and takes
    any H and O: the port's plain head (what a CPU tensor takes, and what
    the general kernels are held to on the card) matches it there too,
    outputs and every gradient."""
    d = _inputs(S, B, dynamic, seed=5 + S + B, fan_in=True, **WIDE)
    assert pst.head_route(torch.float32, S, B, WIDE['C'], WIDE['E'],
                          WIDE['H'], WIDE['O']) == 'general'
    joc, joo, jg = _jax_head(S, B, d)
    toc, too, tg = _torch_head(S, B, d)
    assert toc.shape == (WIDE['N'], WIDE['O'])
    np.testing.assert_allclose(toc.detach().numpy(), np.asarray(joc),
                               rtol=RTOL, atol=ATOL)
    if S == 7:
        np.testing.assert_allclose(too.detach().numpy(), np.asarray(joo),
                                   rtol=RTOL, atol=ATOL)
    jl = jax.tree_util.tree_leaves(jg)
    tl = [g for g in jax.tree_util.tree_leaves(
        tg, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(jl) == len(tl)
    for k, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL, err_msg=f'grad leaf {k}')


@pytest.mark.parametrize('C,E,H,O', [(36, 21, 256, 129), (16, 21, 128, 65),
                                     (12, 21, 128, 65), (4, 5, 8, 3),
                                     (4, 21, 32, 17)])
def test_route_takes_the_fast_kernels_at_their_widths(C, E, H, O):
    """The published widths (compressor: C=36, E=21, H=256, O=129), the
    evidence runs' (C=16 / 12, H=128, O=65) and the toy ones keep the fast
    kernels, in both dtypes, for every S and B."""
    for cd in (torch.float32, torch.bfloat16):
        for S in (1, 7):
            for B in (1, 2):
                assert pst.head_route(cd, S, B, C, E, H, O) == 'fast'
    assert pst.fast_takes(True, C, E, H, O) and pst.fast_takes(False, C, E,
                                                                 H, O)


@pytest.mark.parametrize('cd,C,E,H,O', [
    (torch.float32, 36, 39, 256, 257),      # NeuS: 3C+E = 147, O = 257
    (torch.float32, 41, 21, 256, 129),      # 3C+E = 144
    (torch.float32, 36, 21, 260, 129),      # H > 256
    (torch.float32, 36, 21, 256, 145),      # O > 144
    (torch.bfloat16, 36, 39, 256, 257),
    (torch.bfloat16, 18, 21, 256, 129),     # C % 4 != 0
    (torch.bfloat16, 4, 33, 64, 17),        # E > 32
    (torch.bfloat16, 36, 21, 512, 129),     # H > 256
    (torch.float32, 680, 8, 4096, 4096),    # the general kernels' corner
])
def test_route_sends_each_refused_width_to_the_general_kernels(cd, C, E, H,
                                                                O):
    for S in (1, 7):
        for B in (1, 2):
            assert pst.head_route(cd, S, B, C, E, H, O) == 'general'
    # the fast packers still refuse them: they belong to the fast kernels
    pack = pst.pack_weights_bf16 if cd == torch.bfloat16 \
        else pst.pack_weights_f32
    if (3 * C + E >= pst.XP or H > pst.HP or O > pst.OP):
        with pytest.raises(ValueError):
            pack(torch.zeros(3 * C + E, H), torch.zeros(H),
                 torch.zeros(H, O))


@pytest.mark.parametrize('C,E,H,O', [(683, 0, 256, 129), (36, 21, 4100, 129),
                                     (36, 21, 256, 4097)])
def test_route_refuses_past_the_general_limits(C, E, H, O):
    with pytest.raises(ValueError, match='general kernels'):
        pst.head_route(torch.float32, 7, 1, C, E, H, O)
    with pytest.raises(ValueError):
        pst.head_route(torch.float32, 3, 1, 36, 21, 256, 129)


GEN_WIDTHS = [(36, 39, 256, 257), (48, 39, 512, 257), (18, 21, 256, 129),
              (682, 2, 4096, 4096), (1, 1, 1, 1), (36, 21, 260, 145),
              (53, 1, 300, 1000)]


@pytest.mark.parametrize('S', [1, 7])
@pytest.mark.parametrize('widths', GEN_WIDTHS[:5])
def test_general_tiles_and_shared_memory_fit(S, widths):
    """Every width the general kernels take gets a tile of at least one
    row whose block fits the SM's shared memory, at most 112 X rows (28
    row groups of 4 rows), the largest such tile (one row more would not
    fit or is past the cap); the padded widths keep 16-byte rows with room
    for the ones column."""
    C, E, H, O = widths
    k, k4, h4, o4 = pst.gen_dims(*widths)
    assert k == 3 * C + E and k4 > k and k4 % 4 == 0
    assert h4 >= H and o4 >= O and h4 % 4 == 0 and o4 % 4 == 0
    for kind in ('fwd', 'bwd'):
        tr = pst.gen_tile_rows(kind, S, *widths)
        assert 1 <= tr <= pst.GEN_TRMAX[S]
        assert S * tr <= pst.GEN_NT // 16 * 4
        assert pst.gen_smem_bytes(kind, S, *widths, tr) <= pst.SMEM_PER_BLOCK
        if tr < pst.GEN_TRMAX[S]:
            assert pst.gen_smem_bytes(kind, S, *widths, tr + 1) \
                > pst.SMEM_PER_BLOCK
    # the NeuS widths keep full tiles, and two forward blocks a SM
    if widths == (36, 39, 256, 257) and S == 7:
        for kind in ('fwd', 'bwd'):
            assert pst.gen_tile_rows(kind, S, *widths) == pst.GEN_TRMAX[S]
        smem = pst.gen_smem_bytes('fwd', S, *widths, pst.GEN_TRMAX[S])
        assert pst.gen_blocks_per_sm('fwd', smem) == 2


@pytest.mark.parametrize('n', [1, 512, 4096, 131072])
@pytest.mark.parametrize('widths', GEN_WIDTHS)
def test_general_grid_covers_the_tiles(n, widths):
    """At every N the main path gives the general kernels (a render
    chunk's 512, a relight chunk's 4096, a 512^3 step's 131,072), every
    width gets, in both row kernels and for S = 1 and 7, a block that fits
    232,448 bytes with at least one tile, and a persistent grid of at
    least one block and no more than the tiles (one block a SM in the
    backward, at most two in the forward)."""
    for S in (1, 7):
        for kind in ('fwd', 'bwd'):
            tr = pst.gen_tile_rows(kind, S, *widths)
            smem = pst.gen_smem_bytes(kind, S, *widths, tr)
            assert smem <= 232448 and tr >= 1
            tiles = -(-n // tr)
            grid = pst.gen_grid(kind, 132, S, *widths, n)
            assert 1 <= grid <= tiles
            per_sm = pst.gen_blocks_per_sm(kind, smem)
            assert per_sm * (smem + 1024) <= pst.SMEM_PER_SM
            assert grid == min(tiles, 132 * per_sm)
            assert per_sm <= pst.GEN_BLOCKS_PER_SM[kind]


@pytest.mark.parametrize('S', [1, 7])
@pytest.mark.parametrize('widths', GEN_WIDTHS)
def test_general_plan_fits_its_buffers(S, widths):
    """The general kernels' work split at the tile each row kernel takes:
    the forward's layer-1 units (4x8 each) and K groups fit the block's
    threads and a ring slot, their partials the X^T region, and their
    chunks cover every hidden row; the backward's dh groups' partials fit
    one pass's dz^T buffer and their chunks a ring slot; the dX windows
    cover every X column."""
    for kind in ('fwd', 'bwd'):
        p = pst.gen_plan(S, *widths, pst.gen_tile_rows(kind, S, *widths))
        assert p['M'] <= 112 and p['MS'] % 4 == 0 and p['MS'] > p['M']
        assert p['TRP'] % 4 == 0 and p['TRP'] >= p['TR']
        # forward, layer 1
        assert p['g1'] >= 1 and p['kq1'] >= 4
        assert p['rg1'] * p['cgp'] * p['g1'] <= pst.GEN_NT
        assert p['g1'] * p['kq1'] * p['owp'] <= pst.GEN_FSLOT
        assert p['n1pass'] * p['owp'] >= p['O4']
        assert (p['g1'] - 1) * p['TRP'] * p['owp'] <= p['r0f']
        assert p['K4'] * p['MSF'] <= p['r0f'] and p['MSF'] >= p['M']
        # backward, dh and dX
        assert p['gd'] >= 1 and p['kqd'] >= 1
        assert p['TRP'] // 4 * 16 * p['gd'] <= pst.GEN_NT
        assert p['gd'] * p['TRP'] <= p['MS']
        assert p['gd'] * p['kqd'] * pst.GEN_HW <= pst.GEN_BSLOT
        assert p['nwin'] * pst.GEN_DXW >= p['K4']
        assert p['npass'] * pst.GEN_HW >= p['H4']


@pytest.mark.parametrize('S', [1, 7])
@pytest.mark.parametrize('n', [1, 1003, 131072])
def test_general_workspace_sizing(S, n):
    """The general backward's workspace holds X (with its ones column),
    dz, the centre h and cotangent of every tile, one dw1row partial a
    block (of the persistent grid), past one dX window a dX^T scratch a
    block, and the split partials of dW0 and dW1, whose splits of at most
    1024 rows (a multiple of 32) cover every row once."""
    for widths in ((36, 39, 256, 257), (48, 39, 512, 257)):
        tr = pst.gen_tile_rows('bwd', S, *widths)
        grid = pst.gen_grid('bwd', 132, S, *widths, n)
        p = pst.gen_plan(S, *widths, tr)
        k4, h4, o4 = p['K4'], p['H4'], p['O4']
        tiles = -(-n // tr)
        r0, r1 = tiles * S * tr, tiles * tr
        for k in (r0, r1):
            splits, chunk = pst.gen_splits(k)
            assert chunk % 32 == 0 and chunk <= pst.GEN_AKMAX
            assert (splits - 1) * chunk < k <= splits * chunk
        total = pst.gen_workspace_bytes(S, *widths, n, tr, grid)
        assert total % 256 == 0
        dxs = grid * k4 * p['MS'] if p['nwin'] > 1 else 0
        assert (p['nwin'] > 1) == (widths[0] == 48)
        need = 4 * (r0 * (k4 + h4) + r1 * (h4 + o4) + grid * h4 + dxs
                    + pst.gen_splits(r0)[0] * k4 * h4
                    + pst.gen_splits(r1)[0] * h4 * o4)
        assert need <= total < need + 8 * 256
        assert pst.gen_workspace_bytes(S, *widths, n + tr, tr, grid) > total


@pytest.mark.parametrize('cd', [torch.float32, torch.bfloat16])
def test_pack_weights_general_round_trips(cd):
    """The general kernels' operands hold W0 and W1 rounded to the compute
    dtype at their plain positions (W0^T and W1^T too), zeros elsewhere;
    a padded X row through them gives the plain z and head outputs, and
    its ones column turns the dW0 product into db0."""
    C, E, H, O = 5, 7, 30, 13
    rng = np.random.RandomState(3)
    k0 = 3 * C + E
    w0 = torch.tensor(rng.randn(k0, H).astype(np.float32))
    b0 = torch.tensor(rng.randn(H).astype(np.float32))
    w1 = torch.tensor(rng.randn(H, O).astype(np.float32))
    w0p, w0t, b0p, w1p, w1t, w1row = pst.pack_weights_general(w0, b0, w1, cd)
    _, k4, h4, o4 = pst.gen_dims(C, E, H, O)
    assert w0p.shape == (k4, h4) and w1p.shape == (h4, o4)
    assert torch.equal(w0t, w0p.t()) and torch.equal(w1t, w1p.t())
    assert torch.equal(w0p[:k0, :H], w0.to(cd).float())
    assert torch.equal(w1p[:H, :O], w1.to(cd).float())
    assert torch.equal(w1row, w1p[:, 0]) and torch.equal(b0p[:H], b0)
    assert float(w0p[k0:].abs().sum() + w0p[:, H:].abs().sum()) == 0
    assert float(w1p[H:].abs().sum() + w1p[:, O:].abs().sum()) == 0
    x = torch.tensor(rng.randn(6, k0)).double()
    xp = torch.zeros(6, k4).double()
    xp[:, :k0] = x
    xp[:, k0] = 1.0
    z = xp @ w0p.double() + b0p.double()
    np.testing.assert_allclose(
        z[:, :H].numpy(), (x @ w0.to(cd).double() + b0.double()).numpy(),
        rtol=1e-12, atol=1e-12)
    h = torch.nn.functional.softplus(z, beta=100)
    np.testing.assert_allclose((h @ w1p.double())[:, :O].numpy(),
                               (h[:, :H] @ w1.to(cd).double()).numpy(),
                               rtol=1e-12, atol=1e-12)
    dz = torch.tensor(rng.randn(6, h4)).double()
    np.testing.assert_allclose((xp.t() @ dz)[k0].numpy(), dz.sum(0).numpy(),
                               rtol=1e-12)


@pytest.mark.cuda
def test_general_kernels_match_plain_on_the_card():
    """The general kernels, forward and backward, against the plain version
    on the card (the checks chip_smoke.py makes) at small N, the widths'
    sizing as the library computes it, and two bit-identical backward
    runs."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run: python3 chip_smoke.py)')
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    neus, wide, b18 = (36, 39, 256, 257), (48, 39, 512, 257), \
        (18, 21, 256, 129)
    pst.reset_launches()
    for cd in (torch.float32, torch.bfloat16):
        for S, B, n, w in ((7, 1, 1003, neus), (7, 2, 4096, neus),
                           (7, 2, 512, neus), (1, 2, 1003, wide),
                           (7, 1, 1003, wide), (7, 1, 1003, b18)):
            chip_smoke.check_case(f'general S={S} B={B}', n, S, B, cd,
                                  seed=S + B, widths=w)
    assert pst.LAUNCHES == {'stencil_head_fwd': 0, 'stencil_head_bwd': 0}
    assert pst.GENERAL_LAUNCHES['stencil_head_general_bwd'] > 0
    chip_smoke.check_bwd_deterministic(4096, 7, 2, 12, widths=neus)
    lib = pst._gen_lib()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for S in (1, 7):
        for w in (neus, wide, b18):
            for kind in ('fwd', 'bwd'):
                tr = pst.gen_tile_rows(kind, S, *w)
                smem = pst.gen_smem_bytes(kind, S, *w, tr)
                assert lib.stencil_gen_smem(int(kind == 'bwd'), S, *w, tr) \
                    == smem
                # the card holds as many blocks a SM as the grid counts on
                info = chip_smoke.gen_kernel_info(w, kind, S, 2, tr)
                assert info['blocks_per_sm'] >= pst.gen_blocks_per_sm(kind,
                                                                      smem)
                assert info['smem_bytes'] == smem
            for n in (1003, 131072):
                grid = pst.gen_grid('bwd', n_sm, S, *w, n)
                assert lib.stencil_gen_bwd_workspace(S, n, *w, tr, grid) \
                    == pst.gen_workspace_bytes(S, *w, n, tr, grid)
