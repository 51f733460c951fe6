"""The NeRF++ background (predict_BG): the port against the JAX package.

  * init_nerf_bg: the same tree of the same shapes, the rgb bias at
    log 0.5;
  * apply_nerf_bg / apply_nerf_bg_density on the same parameters and
    inputs: outputs and the gradients of a random projection (to 1e-5 of
    each leaf's scale);
  * render_background with the same jitter (training) and without it
    (eval): colours to 1e-5, parameter gradients to 1e-4 of the largest;
  * three ShapeTrainer steps at the widths of configs/shape/custom/
    shoe.yaml cut to test size (predict_BG, a black background, Hessian
    and Sparse losses) from JAX-exported parameters and the same draws,
    the background's fold_in(k, 7) jitter included: loss trace to 2e-4,
    and the background net moved by the first step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensoflow_tpu.fields import mlp as jmlp
from tensoflow_tpu.models import shape_renderer as jsr
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.fields import mlp as pmlp
from tensoflow_tpu_torch.models import shape_renderer as psr
from tensoflow_tpu_torch.train.trainer import named_leaves

from test_torch_hierarchical import (_jax_leaves, compare_logs, jax_train,
                                     trainer_pair)

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOE = os.path.join(ROOT, 'configs/shape/custom/shoe.yaml')


def _bg_params(seed=0):
    return jmlp.init_nerf_bg(jax.random.PRNGKey(seed))


def _grads_close(pgrads, jgrads, tol, what, per_leaf=True):
    """Each leaf's gradient to ``tol`` of its own largest magnitude, or
    (per_leaf False) of the largest over the whole net."""
    jl = _jax_leaves(jgrads)
    assert sorted(jl) == sorted(pgrads)
    top = max(float(np.abs(v).max()) for v in jl.values())
    for path, g in pgrads.items():
        scale = (float(np.abs(jl[path]).max()) if per_leaf else top) + 1e-12
        np.testing.assert_allclose(g / scale, jl[path] / scale, rtol=0,
                                   atol=tol, err_msg=f'{what} {path}')


def test_init_nerf_bg_layout_matches_jax():
    jp = jax.tree.map(np.asarray, _bg_params())
    pp = pmlp.init_nerf_bg(torch.Generator().manual_seed(0))
    jl = _jax_leaves(jp)
    pl = dict(named_leaves(pp))
    assert sorted(jl) == sorted(pl)
    for path, v in jl.items():
        assert tuple(pl[path].shape) == v.shape, path
    assert len(pp['pts']) == 8 and pp['pts'][5]['w'].shape[0] == 256 + 84
    np.testing.assert_array_equal(pp['rgb']['b'].numpy(),
                                  np.full(3, np.log(0.5), np.float32))


def test_apply_nerf_bg_matches_jax():
    params = _bg_params(1)
    rng = np.random.RandomState(0)
    n = 64
    pts4 = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    view = rng.randn(n, 3).astype(np.float32)
    w_a, w_r = rng.randn(n, 1).astype(np.float32), rng.randn(n, 3).astype(
        np.float32)

    def jloss(p):
        a, r = jmlp.apply_nerf_bg(p, jnp.asarray(pts4), jnp.asarray(view))
        dens = jmlp.apply_nerf_bg_density(p, jnp.asarray(pts4))
        return jnp.sum(a * w_a) + jnp.sum(r * w_r) + jnp.sum(dens), (a, r,
                                                                      dens)
    (_, (ja, jr, jd)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = named_leaves(pp)
    for _, t in leaves:
        t.requires_grad_(True)
    a, r = pmlp.apply_nerf_bg(pp, torch.from_numpy(pts4),
                              torch.from_numpy(view))
    dens = pmlp.apply_nerf_bg_density(pp, torch.from_numpy(pts4))
    for got, want in ((a, ja), (r, jr), (dens, jd)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    loss = (torch.sum(a * torch.from_numpy(w_a))
            + torch.sum(r * torch.from_numpy(w_r)) + torch.sum(dens))
    g = torch.autograd.grad(loss, [t for _, t in leaves])
    _grads_close({p: x.numpy() for (p, _), x in zip(leaves, g)}, jg, 1e-5,
                 'grad')


def _cfgs(n_bg):
    jr = jsr.ShapeRendererConfig(predict_BG=True, n_bg_samples=n_bg)
    pr = psr.ShapeRendererConfig(predict_BG=True, n_bg_samples=n_bg)
    return jr, pr


def test_render_background_matches_jax():
    """Training (the jitter sorted back into descending inverse radii)
    and eval; rays from outside and from inside the unit sphere.  The
    gradients are held to 1e-4 of the net's largest: the density bias
    sums terms that cancel to ~1e-3 of them (float64 puts the port's and
    the JAX package's float32 sums 5e-5 and 2e-4 from it)."""
    params = _bg_params(2)
    jr, pr = _cfgs(16)
    rng = np.random.RandomState(1)
    rn = 24
    o = rng.randn(rn, 3).astype(np.float32)
    o[: rn // 2] *= 2.5 / np.linalg.norm(o[: rn // 2], axis=-1,
                                         keepdims=True)
    o[rn // 2:] *= 0.3
    d = rng.randn(rn, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = rng.randn(rn, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = named_leaves(pp)
    for _, t in leaves:
        t.requires_grad_(True)
    for is_train in (True, False):
        def jloss(p):
            c = jsr.render_background(p, jr, jnp.asarray(o), jnp.asarray(d),
                                      key, is_train)
            return jnp.sum(c * w), c
        (_, jc), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            params)
        jitter = (torch.from_numpy(np.array(jax.random.uniform(key, (rn, 16))))
                  if is_train else None)
        c = psr.render_background(pp, pr, torch.from_numpy(o),
                                  torch.from_numpy(d), jitter)
        assert bool(torch.isfinite(c).all())
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f'colour (train: {is_train})')
        g = torch.autograd.grad(torch.sum(c * torch.from_numpy(w)),
                                [t for _, t in leaves])
        _grads_close({p: x.numpy() for (p, _), x in zip(leaves, g)}, jg,
                     1e-4, f'grad (train: {is_train})', per_leaf=False)


def test_predict_bg_three_step_trace_matches_jax():
    """The counterpart of the JAX package's test_predict_bg_training as a
    parity trace: shoe.yaml's settings at test widths on the toy scene."""
    over = ['n_bg_samples=16', 'upsample_list=null',
            'update_AlphaMask_lst=null']
    jt, pt = trainer_pair(over, path=SHOE)
    assert jt.rcfg.predict_BG and not jt.rcfg.isBGWhite
    assert pt.rcfg.predict_BG and not pt.rcfg.isBGWhite
    assert 'bg' in pt.params
    bg0 = {p: t.detach().clone() for p, t in named_leaves(pt.params['bg'])}
    jlogs = jax_train(jt, 3)
    plogs = pt.train(n_steps=1, log_every=1)
    moved = [p for p, t in named_leaves(pt.params['bg'])
             if not torch.equal(t.detach(), bg0[p])]
    assert len(moved) == len(bg0)
    plogs += pt.train(n_steps=2, log_every=1)
    assert all(np.isfinite(l['loss']) for l in plogs)
    compare_logs(jlogs, plogs)
