"""Grid upsampling and the p4 patch atlas: the port vs the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
its port:

  * upsample_vm / upsample_tenso_sdf at odd target sizes: fields, grid
    sizes and n_levels to 1e-6;
  * the p4 atlas buffers of pack_vm_patches (equal to JAX's
    pack_impl='p4'), the p4 row gather at n_levels 1-3 with and without
    a level (rows, fr lanes) and the gradient of a loss through it back
    into the field (1e-5);
  * sdf_with_grad_hessian on a p4 atlas at n_levels 3 against the JAX
    package's Pallas route in interpret mode (the p4 gate lowered on both
    sides, so that a small field takes p4 rows);
  * three ShapeTrainer steps across an upsample (upsample_list=[1]) from
    JAX-exported parameters and the same draws: loss trace to 2e-4;
  * a checkpoint resumed across an upsample, and a step after an upsample
    copying nothing but its batch to the device.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.fields import light as jlight
from tensoflow_tpu.fields import tenso_sdf as jsdf
from tensoflow_tpu.models import shape_renderer as jsr
from tensoflow_tpu.ops import tensor_field as jtf
from tensoflow_tpu.train import losses as jlosses
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import occ_state_from_jax, params_from_jax
from tensoflow_tpu_torch.fields import tenso_sdf as psdf
from tensoflow_tpu_torch.ops import tensor_field as ptf
from tensoflow_tpu_torch.train.trainer import ShapeTrainer, named_leaves

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
CFG_PATH = 'configs/shape/syn/compressor_occ.yaml'


def _field(rng, grid, c=4):
    return {'planes': [rng.randn(grid[a], grid[b], c).astype(np.float32)
                       for a, b in ptf.MAT_MODE],
            'lines': [rng.randn(grid[v], c).astype(np.float32)
                      for v in ptf.VEC_MODE]}


def _jf(f):
    return jax.tree.map(jnp.asarray, f)


def _pf(f, grad=False):
    return {k: [torch.tensor(x).requires_grad_(grad) for x in v]
            for k, v in f.items()}


def _close(a, b, rtol=1e-6, atol=1e-6, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# upsample_vm / upsample_tenso_sdf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('src,dst', [((16, 12, 8), (33, 25, 17)),
                                     ((9, 16, 5), (31, 23, 19)),
                                     ((128, 128, 128), (255, 257, 129))])
def test_upsample_vm_matches_jax(src, dst):
    f = _field(np.random.RandomState(sum(dst)), src,
               c=2 if src[0] > 64 else 4)
    jout = jtf.upsample_vm(_jf(f), dst)
    pout = ptf.upsample_vm(_pf(f), dst)
    for k in ('planes', 'lines'):
        for i in range(3):
            assert tuple(pout[k][i].shape) == tuple(jout[k][i].shape)
            _close(pout[k][i], jout[k][i], msg=f'{k}[{i}]')


def test_upsample_tenso_sdf_matches_jax():
    cfgj = jsdf.SDFConfig(grid_size=(16, 12, 8), n_comp=4, sdf_dim=16,
                          app_dim=8, n_levels=2)
    cfgp = psdf.SDFConfig(grid_size=(16, 12, 8), n_comp=4, sdf_dim=16,
                          app_dim=8, n_levels=2)
    rng = np.random.RandomState(5)
    params = {'field': _field(rng, (16, 12, 8)),
              'mlp': [{'w': rng.randn(33, 16).astype(np.float32),
                       'b': rng.randn(16).astype(np.float32)}]}
    res = (35, 27, 19)       # rounded down to multiples of 4 at n_levels 3
    jp, jc = jsdf.upsample_tenso_sdf(jax.tree.map(jnp.asarray, params),
                                     cfgj, res)
    pp, pc = psdf.upsample_tenso_sdf(params_from_jax(params), cfgp, res)
    assert pc.grid_size == jc.grid_size == (32, 24, 16)
    assert pc.n_levels == jc.n_levels == 3
    for k in ('planes', 'lines'):
        for i in range(3):
            _close(pp['field'][k][i], jp['field'][k][i])
    np.testing.assert_array_equal(pp['mlp'][0]['w'].numpy(),
                                  params['mlp'][0]['w'])


# ---------------------------------------------------------------------------
# the p4 atlas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n_levels', [1, 2, 3])
def test_pack_p4_matches_jax(n_levels):
    f = _field(np.random.RandomState(n_levels), (20, 12, 8))
    ja = jtf.pack_vm_patches(_jf(f), n_levels, pack_impl='p4')
    pa = ptf.pack_vm_patches(_pf(f), n_levels, pack_impl='p4')
    assert pa.meta._asdict() == ja.meta._asdict()
    assert pa.meta.plane_fmt == 'p4'
    _close(pa.plane_buf, ja.plane_buf)
    _close(pa.line_buf, ja.line_buf)


def test_pack_format_gate():
    """'auto' takes p4 rows from a 256x256 top plane up, as JAX does."""
    rng = np.random.RandomState(0)
    for grid, fmt in (((256, 256, 4), 'p4'), ((255, 256, 4), 'p16')):
        f = _field(rng, grid, c=1)
        assert ptf.pack_vm_patches(_pf(f)).meta.plane_fmt == fmt
        assert jtf.pack_vm_patches(_jf(f)).meta.plane_fmt == fmt
    with pytest.raises(ValueError, match='pack_impl'):
        ptf.pack_vm_patches(_pf(f), pack_impl='conv')


@pytest.mark.parametrize('n_levels,with_level', [(1, False), (2, False),
                                                 (2, True), (3, True)])
def test_p4_gather_matches_jax(n_levels, with_level):
    """Rows and fr lanes of the p4 gather, and the gradient of a random
    projection of the rows back into the field (gather VJP + pack VJP)."""
    rng = np.random.RandomState(10 * n_levels + with_level)
    grid = (20, 12, 8)
    f = _field(rng, grid)
    n = 53
    xyz = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    level = (rng.uniform(-0.3, n_levels - 0.7, (n,)).astype(np.float32)
             if with_level else None)
    d01 = [1.0 / g for g in grid]

    def jgather(fj):
        atlas = jtf.pack_vm_patches(fj, n_levels, pack_impl='p4')
        return jtf.vm_patch_gather(
            atlas, jnp.asarray(xyz), d01,
            None if level is None else jnp.asarray(level))

    jpp, jlp, jfr, jsig = jgather(_jf(f))
    pf = _pf(f, grad=True)
    atlas = ptf.pack_vm_patches(pf, n_levels, pack_impl='p4')
    ppp, plp, pfr, psig = ptf.vm_patch_gather(
        atlas, torch.tensor(xyz), d01,
        None if level is None else torch.tensor(level))
    assert psig == jsig
    assert len(ppp) == (2 if (n_levels > 1 and with_level) else 1)
    _close(pfr, jfr)
    for b in range(len(jpp)):
        for i in range(3):
            _close(ppp[b][i], jpp[b][i], msg=f'pp[{b}][{i}]')
            _close(plp[b][i], jlp[b][i], msg=f'lp[{b}][{i}]')
    proj_p = rng.randn(*np.shape(jpp[0][0])).astype(np.float32)
    proj_l = rng.randn(*np.shape(jlp[0][0])).astype(np.float32)

    def jloss(fj):
        pp, lp, _, _ = jgather(fj)
        return sum(jnp.sum(p * proj_p) for row in pp for p in row) + sum(
            jnp.sum(l * proj_l) for row in lp for l in row)

    jg = jax.jit(jax.grad(jloss))(_jf(f))
    (sum(torch.sum(p * torch.tensor(proj_p)) for row in ppp for p in row)
     + sum(torch.sum(l * torch.tensor(proj_l)) for row in plp
           for l in row)).backward()
    # the planes' gradients sum the same f32 terms in another order; the
    # line gather's VJP rounds its cotangent to bf16 on both sides
    for i in range(3):
        _close(pf['planes'][i].grad, jg['planes'][i], rtol=1e-5, atol=1e-5,
               msg=f'd planes[{i}]')
        _close(pf['lines'][i].grad, jg['lines'][i], rtol=1e-5, atol=1e-5,
               msg=f'd lines[{i}]')


def test_sdf_with_grad_hessian_on_p4_matches_pallas(monkeypatch):
    """The port's stencil head on a p4 atlas with three mip levels (two
    dynamic-sigma branches per row) against the JAX package's Pallas head
    in interpret mode on its own p4 atlas.  sdf, app and grad agree to
    1e-5 of their scale, and so do the parameter gradients of a random
    projection of them (the lines' to 1e-3, see below).  The hessian
    divides sums of three f32 sdf values by eps^2 = (2/24)^2, so one
    rounding of an sdf moves it by ~1e-5: it and the gradients of a loss
    that includes it agree to 2e-4."""
    monkeypatch.setattr(jtf, 'PACK_P4_MIN_TEXELS', 1)
    monkeypatch.setattr(ptf, 'PACK_P4_MIN_TEXELS', 1)
    grid = (24, 16, 12)
    kw = dict(grid_size=grid, n_comp=4, sdf_dim=32, app_dim=8, n_levels=3,
              sdf_multires=3)
    cfgj = jsdf.SDFConfig(**kw, stencil_impl='pallas', stencil_tile=32)
    cfgp = psdf.SDFConfig(**kw)
    params = jsdf.init_tenso_sdf(jax.random.PRNGKey(3), cfgj)
    k = jax.random.PRNGKey(4)
    params['field'] = jax.tree.map(
        lambda x: x + 0.1 * jax.random.normal(k, x.shape), params['field'])
    w0 = params['mlp'][0]['w']
    params['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(k, w0.shape)
    rng = np.random.RandomState(3)
    n = 64
    xyz = ((rng.rand(n, 3) - 0.5) * 1.9).astype(np.float32)
    level = rng.uniform(0.0, 2.0, (n, 1)).astype(np.float32)
    proj = rng.randn(n, 1 + 8 + 3 + 1).astype(np.float32)
    no_hess = proj.copy()
    no_hess[:, -1] = 0.0

    def outs(sdf, app, grad, nh):
        return [sdf[:, None], app, grad, nh[:, None]]

    def jrun(p):
        o = outs(*jsdf.sdf_with_grad_hessian(
            p, cfgj, jnp.asarray(xyz), jnp.asarray(AABB),
            jnp.asarray(level)))
        return jnp.concatenate(o, -1), o

    @jax.jit
    def jgrads(p):
        g = [jax.grad(lambda q, w=w: jnp.sum(jrun(q)[0] * w))(p)
             for w in (no_hess, proj)]
        return jrun(p)[1], g

    jo, jg = jgrads(params)
    pp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = named_leaves(pp)
    for _, t in leaves:
        t.requires_grad_(True)
    po = outs(*psdf.sdf_with_grad_hessian(
        pp, cfgp, torch.tensor(xyz), torch.tensor(AABB), torch.tensor(level)))
    for name, a, b in zip(('sdf', 'app', 'grad', 'hessian'), po, jo):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a / scale, np.asarray(b) / scale, rtol=0,
               atol=2e-4 if name == 'hessian' else 1e-5, msg=name)
    out = torch.cat(po, -1)
    for w, jgw, tol in ((no_hess, jg[0], 1e-5), (proj, jg[1], 2e-4)):
        pg = torch.autograd.grad(torch.sum(out * torch.tensor(w)),
                                 [t for _, t in leaves], retain_graph=True)
        jl = {tuple(getattr(e, 'key', getattr(e, 'idx', None)) for e in pa):
              np.asarray(v)
              for pa, v in jax.tree_util.tree_leaves_with_path(jgw)}
        for (path, _), g in zip(leaves, pg):
            scale = float(np.abs(jl[path]).max()) + 1e-12
            # the line gather's VJP rounds its cotangent to bf16 on both
            # sides (take_rows_small): a cotangent next to a rounding
            # boundary may round the other way, a 2^-8 step of one term
            _close(g / scale, jl[path] / scale, rtol=0,
                   atol=max(tol, 1e-3) if 'lines' in path else tol,
                   msg=f'grad {path} (hessian in the loss: {tol > 1e-5})')


# ---------------------------------------------------------------------------
# the trainer across an upsample
# ---------------------------------------------------------------------------

OVERRIDES = [
    'database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
    'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=32768',
    'occ_grid_reso=16', 'train_ray_num=64', 'occ_max_samples=48',
    'occ_loss_max_pn=64', 'upsample_list=[1]',
    'compact_samples_per_ray=16', 'name=parity_up']


class _JaxDrawsTrainer(ShapeTrainer):
    """The port's trainer drawing its noise from a JAX key chain that
    mirrors JaxShapeTrainer.train's splits."""

    def __init__(self, cfg, key):
        super().__init__(cfg, device='cpu')
        self.key = key

    def occ_jitter(self, step):
        self.key, k = jax.random.split(self.key)
        r = self.occ_cfg.resolution
        return torch.from_numpy(np.asarray(
            jax.random.uniform(k, (r ** 3, 3))).copy())

    def step_noise(self, step):
        self.key, k = jax.random.split(self.key)
        k_sample, k_occ = jax.random.split(k)
        rn = self.cfg['train_ray_num']
        m = rn * self.rcfg.compact_samples_per_ray
        return {'sample_jitter': torch.from_numpy(np.asarray(
                    jax.random.uniform(k_sample, (rn, 1))).copy()),
                'occ_score': torch.from_numpy(np.asarray(
                    jax.random.uniform(k_occ, (m,))).copy())}


def _jax_run(jt, n_steps):
    """JaxShapeTrainer.train's loop with its step jitted per grid phase
    (as _get_step_fn does); returns the loss terms of each step."""
    fns, logs = {}, []

    def step_fn_for(rcfg, tx):
        if rcfg not in fns:
            @jax.jit
            def step_fn(params, opt_state, occ_state, batch, step, weights,
                        k):
                def loss_fn(p):
                    mips = jlight.build_mips(p['shading']['envlight'],
                                             rcfg.shading.env)
                    out = jsr.train_step_outputs(p, rcfg, mips, occ_state,
                                                 batch, step, k, False, True)
                    total, terms = jlosses.total_loss_shape(out, weights)
                    return total, {**terms, 'sample_num': out['sample_num']}

                (total, terms), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = tx.update(grads, opt_state, params)
                return (optax.apply_updates(params, updates), opt_state,
                        {**terms, 'loss': total})
            fns[rcfg] = step_fn
        return fns[rcfg]

    for step in range(n_steps):
        jt.maybe_set_march_stride(step)
        if step % jt.occ_update_interval == 0:
            jt.rng, k = jax.random.split(jt.rng)
            jt.occ_state = jt._get_occ_update_fn(prune=False)(
                jt.params, jt.occ_state, step, k)
        batch = jt.batcher.next_batch()
        weights = jlosses.schedule_weights(jt.cfg, step)
        assert jt.phase_flags(step) == (False, True)
        jt.rng, k = jax.random.split(jt.rng)
        jt.params, jt.opt_state, terms = step_fn_for(jt.rcfg, jt.tx)(
            jt.params, jt.opt_state, jt.occ_state, batch, step, weights, k)
        logs.append({k_: float(v) for k_, v in terms.items()})
        jt.maybe_adapt_budget(step, terms)
        jt.maybe_update_alpha_mask(step)
        jt.maybe_upsample(step)
    return logs


def test_three_step_trace_across_upsample_matches_jax():
    jcfg = jconfig.load_config(CFG_PATH, overrides=OVERRIDES
                               + ['stencil_impl=pallas', 'stencil_tile=64'])
    jt = JaxShapeTrainer(jcfg)
    k = jax.random.PRNGKey(7)
    w0 = jt.params['sdf']['mlp'][0]['w']
    jt.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        k, w0.shape)
    jt.init_dataset()
    pt = _JaxDrawsTrainer(pconfig.load_config(CFG_PATH, overrides=OVERRIDES),
                          jt.rng)
    pt.set_params(params_from_jax(jax.tree.map(np.asarray, jt.params)))
    pt.occ_state = occ_state_from_jax(jax.tree.map(np.asarray, jt.occ_state))
    pt.init_dataset()

    jlogs = _jax_run(jt, 3)
    plogs = pt.train(n_steps=3, log_every=1)
    # n_to_reso(32768) = 31 per axis, rounded down to a multiple of 2
    assert pt.rcfg.sdf.grid_size == jt.rcfg.sdf.grid_size == (30, 30, 30)
    assert pt.rcfg.sdf.n_levels == jt.rcfg.sdf.n_levels == 2
    assert pt.opt.reset_step == jt.opt_reset_step == 1
    assert pt.n_voxel_list == jt.n_voxel_list == []
    assert pt.rcfg.march_stride == jt.rcfg.march_stride
    for step, (jl, pl) in enumerate(zip(jlogs, plogs)):
        for k_, v in jl.items():
            np.testing.assert_allclose(pl[k_], v, rtol=2e-4, atol=1e-7,
                                       err_msg=f'step {step} {k_}')


SMALL = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
         'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=4096',
         'occ_grid_reso=8', 'train_ray_num=16', 'occ_max_samples=16',
         'occ_loss_max_pn=16', 'upsample_list=[1]',
         'compact_samples_per_ray=8']


def test_checkpoint_resume_after_upsample(tmp_path):
    """Resume across an upsample: the grid size and mip count come from
    the checkpoint, the consumed voxel schedule stays consumed, and the
    parameters and Adam state (moments, count, reset step) come back."""
    cfg = pconfig.load_config(CFG_PATH, overrides=SMALL)
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.train(n_steps=3, log_every=3)           # upsample after step 1
    up = trainer.rcfg.sdf
    assert up.grid_size == (14, 14, 14) and up.n_levels == 2
    path = str(tmp_path / 'model.pkl')
    trainer.save(path)

    t2 = ShapeTrainer(cfg, device='cpu')            # fresh: 8^3, one mip
    assert t2.rcfg.sdf.grid_size == (8, 8, 8)
    t2.load(path)
    assert t2.rcfg.sdf == up
    assert t2.n_voxel_list == trainer.n_voxel_list == []
    assert t2.start_step == 3
    s1, s2 = trainer.opt.state(), t2.opt.state()
    assert (s2['count'], s2['reset_step']) == (s1['count'], 1) == (1, 1)
    for (path_, a), (_, b) in zip(named_leaves(trainer.params),
                                  named_leaves(t2.params)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=path_)
        m1, v1 = s1['moments'][str(path_)]
        m2, v2 = s2['moments'][str(path_)]
        np.testing.assert_array_equal(m1.numpy(), m2.numpy())
        np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    logs = t2.train(n_steps=2, log_every=1)
    assert all(np.isfinite(r['loss']) for r in logs)


def test_step_after_upsample_copies_only_the_batch():
    """With two mip levels the gather reads per-level tables: they come
    from the device-constant cache, so a step still builds one tensor from
    host data, its batch."""
    from torch.overrides import TorchFunctionMode
    cfg = pconfig.load_config(CFG_PATH, overrides=SMALL)
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.train(n_steps=3, log_every=3)
    assert trainer.rcfg.sdf.n_levels == 2
    made = []

    class FromHost(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.tensor, torch.as_tensor) \
                    and not isinstance(args[0], torch.Tensor):
                made.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with FromHost():
        trainer.train(n_steps=1, log_every=1)
    assert made == ['as_tensor'], made
