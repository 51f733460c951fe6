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

RTOL, ATOL = 1e-6, 2e-6


def _inputs(S, B, dynamic, seed=0, C=4, E=5, H=8, O=3, N=16):
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
    w0p = [(rng.randn(d, H) * 0.3).astype(np.float32) for d in (C, C, C, E)]
    b0 = (rng.randn(H) * 0.3).astype(np.float32)
    w1 = (rng.randn(H, O) * 0.3).astype(np.float32)
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
    assert pst.xw(36, 21) == 144 and pst.xw(36, 21) % 16 == 0
