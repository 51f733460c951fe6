"""Stage 1's photographer light (fields/shading.py human_light) in the
port against the JAX package: predict_human_light, apply_shading with the
blend and its 'human_light' intermediate, render_rays carrying each ray's
pose to its samples (the compacted occupancy-grid path and the dense
path), and a 2-step stage-1 run with the light on.

Neither trainer reads shader_config: the JAX run gets the light by
replacing its renderer config and adding the predictor's parameters; the
port's trainer gets it by having its renderer config replaced before the
parameters are built (``ShapeTrainer(configure=with_human_light)``).
Tolerances: single calls rtol 1e-5 / atol 2e-6 and gradients to
1e-4 of their largest magnitude; the training run at the tolerances of
tests/test_torch_train_step.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.fields import light as jlight
from tensoflow_tpu.fields import mlp as jmlp
from tensoflow_tpu.fields import shading as jshading
from tensoflow_tpu.models import shape_renderer as jsr
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu.train.trainer import make_optimizer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import occ_state_from_jax, params_from_jax
from tensoflow_tpu_torch.fields import light as plight
from tensoflow_tpu_torch.fields import shading as pshading
from tensoflow_tpu_torch.models import shape_renderer as psr
from tensoflow_tpu_torch.train.trainer import named_leaves, with_human_light

from test_torch_train_step import (CFG_PATH, OVERRIDES, _JaxDrawsTrainer,
                                   _jax_run)

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

# a sphere-like initial field (radius 0.5, no PE: the tiny widths' PE
# init has no zero crossing), so that renders meet a surface
SPHERE = ['sdf_multires=0', 'init_radius=0.5']


def _t(x, grad=False):
    t = torch.tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _close(a, b, rtol=1e-5, atol=2e-6, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _grad_close(pg, jg, tol=1e-4, msg=''):
    jg = np.asarray(jg)
    scale = float(np.abs(jg).max()) + 1e-12
    np.testing.assert_allclose(pg.numpy() / scale, jg / scale, atol=tol,
                               err_msg=msg)


def _unit(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _poses(rng, n):
    """Camera poses [n, 3, 4] (rotation, translation ~2 along z): about
    half of random reflected rays meet the camera plane in front."""
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    t = np.concatenate([rng.randn(n, 2, 1) * 0.2,
                        2.0 + rng.rand(n, 1, 1)], 1)
    return np.concatenate([q, t], -1).astype(np.float32)


def _req(tree):
    for t in jax.tree.leaves(tree):
        t.requires_grad_(True)
    return tree


@pytest.fixture(scope='module')
def shading_case():
    rng = np.random.RandomState(13)
    app, n = 16, 64
    kw = dict(app_feats_dim=app, human_light=True)
    scfg_j = jshading.ShadingConfig(env=jlight.EnvLightConfig(max_res=32),
                                    **kw)
    scfg_p = pshading.ShadingConfig(env=plight.EnvLightConfig(max_res=32),
                                    **kw)
    jp = jshading.init_shading(jax.random.PRNGKey(3), scfg_j)
    # a visible light: the predictor starts at exp(log 0.01)
    hl = jp['human_light']['layers'][-1]
    hl['b'] = hl['b'] + 3.0
    return dict(
        scfg_j=scfg_j, scfg_p=scfg_p, jp=jp, n=n,
        pts=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        nrm=_unit(rng, n), view=_unit(rng, n),
        feats=rng.randn(n, app).astype(np.float32),
        refl=_unit(rng, n),
        rough=rng.uniform(0.05, 0.9, (n, 1)).astype(np.float32),
        poses=_poses(rng, n), proj=rng.randn(n, 3).astype(np.float32))


def test_init_shading_human_light_tree_matches_jax(shading_case):
    c = shading_case
    pp = pshading.init_shading(torch.Generator().manual_seed(0), c['scfg_p'])
    jshape = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_leaves_with_path(c['jp'])}
    pshape = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_leaves_with_path(pp)}
    assert pshape == jshape
    assert "['human_light']['layers'][2]['b']" in pshape


def test_predict_human_light_matches_jax(shading_case):
    c = shading_case
    args = (c['pts'], c['refl'], c['poses'], c['rough'])

    def jloss(p):
        hl, hw = jshading.predict_human_light(p, *map(jnp.asarray, args))
        return jnp.sum(hl * c['proj']) + jnp.sum(hw), (hl, hw)

    (_, (jhl, jhw)), jg = jax.value_and_grad(jloss, has_aux=True)(
        c['jp'])
    pp = _req(params_from_jax(jax.tree.map(np.asarray, c['jp'])))
    hl, hw = pshading.predict_human_light(pp, *map(_t, args))
    (torch.sum(hl * _t(c['proj'])) + torch.sum(hw)).backward()
    _close(hl, jhl, msg='light')
    _close(hw, jhw, msg='weight')
    assert 0.2 < float((hw > 0).float().mean()) < 0.9
    for jl, pl in zip(jax.tree.leaves(jg['human_light']),
                      jax.tree.leaves(pp['human_light'])):
        _grad_close(pl.grad, jl)


@pytest.mark.parametrize('with_poses', [True, False])
def test_apply_shading_with_human_light_matches_jax(shading_case,
                                                    with_poses):
    c = shading_case
    poses = c['poses'] if with_poses else None

    def jf(p, nn):
        mips = jlight.build_mips(p['envlight'], c['scfg_j'].env)
        color, _, occ, inter = jshading.apply_shading(
            p, c['scfg_j'], mips, jnp.asarray(c['pts']), nn,
            jnp.asarray(c['view']), jnp.asarray(c['feats']),
            None if poses is None else jnp.asarray(poses), step=5,
            inter_results=True)
        return jnp.sum(color * c['proj']), (color, inter)

    (_, (jc, jinter)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(c['jp'], jnp.asarray(c['nrm']))
    pp = _req(params_from_jax(jax.tree.map(np.asarray, c['jp'])))
    nn = _t(c['nrm'], True)
    mips = plight.build_mips(pp['envlight'], c['scfg_p'].env)
    pc, _, _, pinter = pshading.apply_shading(
        pp, c['scfg_p'], mips, _t(c['pts']), nn, _t(c['view']),
        _t(c['feats']), None if poses is None else _t(poses), step=5,
        inter_results=True)
    torch.sum(pc * _t(c['proj'])).backward()
    _close(pc, jc, msg='color')
    assert sorted(pinter) == sorted(jinter)
    for k, v in jinter.items():
        assert tuple(pinter[k].shape) == np.shape(v), k
        _close(pinter[k], v, msg=k)
    _grad_close(nn.grad, jg[1], msg='normals')
    if with_poses:
        assert float(pinter['human_light'].detach().abs().max()) > 1e-3
        for jl, pl in zip(jax.tree.leaves(jg[0]['human_light']),
                          jax.tree.leaves(pp['human_light'])):
            _grad_close(pl.grad, jl, msg='human_light grad')


# ---------------------------------------------------------------------------
# stage 1 with the light on
# ---------------------------------------------------------------------------

def _jax_trainer_with_light(extra=()):
    cfg = jconfig.load_config(CFG_PATH, overrides=OVERRIDES + list(extra)
                              + ['stencil_impl=pallas', 'stencil_tile=64'])
    t = JaxShapeTrainer(cfg)
    t.rcfg = t.rcfg._replace(shading=t.rcfg.shading._replace(
        human_light=True))
    k = jax.random.PRNGKey(7)
    w0 = t.params['sdf']['mlp'][0]['w']
    t.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        k, w0.shape)
    hl = jmlp.init_predictor(jax.random.PRNGKey(8), 2 * 2 * 6, 4, 3,
                             final_bias=float(np.log(0.01)))
    hl['layers'][-1]['b'] = hl['layers'][-1]['b'] + 3.0
    t.params['shading']['human_light'] = hl
    t.tx, t.opt_state = make_optimizer(cfg, t.params, 0)
    return t


def _port_trainer_like(jt, extra=()):
    cfg = pconfig.load_config(CFG_PATH, overrides=OVERRIDES + list(extra))
    pt = _JaxDrawsTrainer(cfg, jt.rng, configure=with_human_light)
    assert pt.rcfg.shading.human_light
    assert 'human_light' in pt.params['shading']
    pt.set_params(params_from_jax(jax.tree.map(np.asarray, jt.params)))
    pt.occ_state = occ_state_from_jax(jax.tree.map(np.asarray, jt.occ_state))
    return pt


@pytest.fixture(scope='module')
def light_runs():
    jt = _jax_trainer_with_light()
    jt.init_dataset()
    pt = _port_trainer_like(jt)
    pt.init_dataset()
    p0 = {p: t.detach().clone() for p, t in named_leaves(pt.params)}
    jruns, jparams1 = _jax_run(jt, 2)
    plogs = pt.train(n_steps=1, log_every=1)
    leaves = named_leaves(pt.params)
    pgrads = {path: t.grad.clone().numpy() for path, t in leaves}
    pparams1 = {path: t.detach().clone().numpy() for path, t in leaves}
    plogs += pt.train(n_steps=1, log_every=1)
    return dict(jt=jt, pt=pt, jruns=jruns, jparams1=jparams1, plogs=plogs,
                pgrads=pgrads, pparams1=pparams1, p0=p0)


def test_two_step_run_with_human_light_matches_jax(light_runs):
    r = light_runs
    for step, ((jterms, _), pl) in enumerate(zip(r['jruns'], r['plogs'])):
        for k in ('loss', 'loss_rgb', 'loss_eikonal', 'loss_occ',
                  'sample_num'):
            np.testing.assert_allclose(pl[k], jterms[k], rtol=1e-4,
                                       atol=1e-7, err_msg=f'{step} {k}')
    _, jgrads = r['jruns'][0]
    assert sorted(jgrads) == sorted(r['pgrads'])
    for path, jg in jgrads.items():
        scale = float(np.abs(jg).max()) + 1e-12
        np.testing.assert_allclose(r['pgrads'][path] / scale, jg / scale,
                                   atol=1e-3, err_msg=f'grad {path}')
    for path, jp in r['jparams1'].items():
        np.testing.assert_allclose(r['pparams1'][path], jp, rtol=1e-5,
                                   atol=1e-6, err_msg=f'param {path}')
    # the light's MLP moved in the first step
    moved = [p for p in r['p0'] if p[:2] == ('shading', 'human_light')
             and not np.array_equal(r['pparams1'][p], r['p0'][p].numpy())]
    assert moved


@pytest.mark.parametrize('sampler', ['occ_grid', 'dense'])
def test_render_rays_carries_the_poses_like_jax(light_runs, sampler):
    """An evaluation render (deterministic) of one ray batch with each
    sample's pose: the compacted occupancy-grid path gathers it by the
    compaction's source index, the dense path broadcasts it."""
    # untrained trainers on a sphere-like field with a sharp surface
    # (inv_s = e^6): rays through the sphere meet it, and the expected-
    # depth point of the evaluation extras lies on it
    jt = _jax_trainer_with_light(SPHERE)
    jt.params['deviation'] = {
        'variance': jnp.full_like(jt.params['deviation']['variance'], 0.6)}
    pt = _port_trainer_like(jt, SPHERE)
    rcfg_j = jt.rcfg._replace(use_occ_grid=sampler == 'occ_grid')
    rcfg_p = pt.rcfg._replace(use_occ_grid=sampler == 'occ_grid')
    batch = {k: v[:48] for k, v in
             light_runs['jt'].batcher.next_batch().items() if k != 'rgbs'}
    # the toy scene's c2w poses read as w2c put few reflections on the
    # camera plane: poses whose plane half of the reflections meet
    batch['human_poses'] = _poses(np.random.RandomState(5), 48)

    @jax.jit
    def jrender(p, occ):
        mips = jlight.build_mips(p['shading']['envlight'],
                                 rcfg_j.shading.env)
        return jsr.render_rays(p, rcfg_j, mips, occ, batch, 300000, 1.0,
                               jax.random.PRNGKey(0), False,
                               eval_extras=True)

    jout = jrender(jt.params, jt.occ_state)

    def prender(b):
        with torch.no_grad():
            mips = plight.build_mips(pt.params['shading']['envlight'],
                                     rcfg_p.shading.env)
            return psr.render_rays(
                pt.params, rcfg_p, mips, pt.occ_state,
                {k: _t(v) for k, v in b.items()}, 300000, 1.0, None, False,
                eval_extras=True)

    pout = prender(batch)
    for k in ('ray_rgb', 'acc', 'human_light', 'specular_light',
              'normal_vis'):
        _close(pout[k], jout[k], rtol=1e-4, atol=1e-5, msg=k)
    assert float(pout['acc'].max()) > 0.5
    assert float(pout['human_light'].abs().max()) > 1e-3
    # the samples' colours saw the light: without poses they differ
    bare = prender({k: v for k, v in batch.items() if k != 'human_poses'})
    assert float((pout['ray_rgb'] - bare['ray_rgb']).abs().max()) > 1e-4
