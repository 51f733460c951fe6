"""The port's stage-2 (material) trainer against the JAX MaterialTrainer.

A JAX stage-1 trainer writes its checkpoint; convert.geo_checkpoint_from_jax
carries it over; both MaterialTrainers start from the same parameters (the
JAX ones, converted), the same baked trace grid and the same traced
surface hits, and draw the same numbers: the port's step noise is
evaluated with jax.random from the very keys the JAX trainer splits.  The
NIS schedule is cut to single digits, so that three steps cross the three
phases (no NIS, NIS loss, NIS sampling from the frozen copies).

float32 with estimator_dtype='f32'.  Tolerances: loss terms rtol 2e-4;
every parameter gradient within 2e-3 of its largest magnitude; parameters
after Adam within 1e-6 absolute plus 1e-5 relative, except where a
gradient is so small that Adam's first update sign(g)*lr may go either
way; the 3-step loss trace rtol 2e-3.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.models import material_renderer as jmr
from tensoflow_tpu.train import losses as jlosses
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu.train.trainer_mat import MaterialTrainer as JaxMatTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import (geo_checkpoint_from_jax,
                                         packed_sdf_grid_from_jax,
                                         params_from_jax)
from tensoflow_tpu_torch.models import material_renderer as pmr
from tensoflow_tpu_torch.train import checkpoints as pckpt
from tensoflow_tpu_torch.train.trainer import ShapeTrainer, named_leaves
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

GEO = {'name': 'parity_geo', 'database_name': 'toy/sphere_32_4',
       'dataset_dir': 'unused', 'nerfDataType': True, 'train_ray_num': 64,
       'sdf_n_comp': 4, 'sdf_dim': 32, 'app_dim': 16,
       'N_voxel_init': 4096, 'N_voxel_final': 4096,
       'apply_occ_loss': False, 'init_radius': 0.5}
MAT = {'name': 'parity_mat', 'isMaterial': True,
       'database_name': 'toy/sphere_32_4', 'dataset_dir': 'unused',
       'nerfDataType': True, 'train_ray_num': 32, 'bake_resolution': 32,
       'refine_with_neural_sdf': True,
       'shader_cfg': {'diffuse_sample_num': 16, 'specular_sample_num': 8,
                      'nis_diffuse_sample_num': 4,
                      'nis_specular_sample_num': 4, 'nis_start_iter': 3,
                      'nis_loss_iter': 1, 'nis_update_interval': 5,
                      'grid_size': (16, 16, 16), 'light_reso': 8,
                      'mat_n_comp': 4, 'estimator_dtype': 'f32'}}


def _t(x):
    return torch.tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_leaves(tree):
    """{path tuple: numpy leaf}, paths as the port's named_leaves."""
    return {tuple(getattr(e, 'key', getattr(e, 'idx', None)) for e in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_grid(jpg):
    return packed_sdf_grid_from_jax(
        np.asarray(jpg.mid_rows), np.asarray(jpg.blocks),
        np.asarray(jpg.coarse_rows), np.asarray(jpg.aabb), jpg.reso,
        np.asarray(jpg.vis_rows), jpg.vis_pad)


def jax_shade_noise(key, scfg, pn, phase):
    """shade_mixed's draws from the keys it splits, as tensors."""
    k_d, k_s, k_da, k_sa = jax.random.split(key, 4)
    noise = {'az_diffuse': jax.random.uniform(k_da, (pn, 1, 1)),
             'az_specular': jax.random.uniform(k_sa, (pn, 1, 1))}
    if phase.nis_sample_diffuse:
        noise['flow_diffuse'] = jax.random.uniform(
            k_d, (pn, scfg.nis_diffuse_sample_num, 1))
    if phase.nis_sample_specular:
        noise['flow_specular'] = jax.random.uniform(
            k_s, (pn, scfg.nis_specular_sample_num, 1))
    return {k: _t(v) for k, v in noise.items()}


class _JaxDrawsTrainer(MaterialTrainer):
    """The port's trainer drawing its noise from a JAX key chain that
    mirrors the JAX MaterialTrainer.train's splits."""

    def step_noise(self, step, phase):
        self.key, k = jax.random.split(self.key)
        return jax_shade_noise(k, self.rcfg.shader,
                               self.cfg['train_ray_num'], phase)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX trainer, port trainer) on the same geometry, parameters,
    grid and hit batch."""
    d = tmp_path_factory.mktemp('geo')
    jgeo = JaxShapeTrainer(jconfig.load_config(extra=GEO))
    # the geometric init zeroes W0's feature rows: noise them so that the
    # field shapes the baked surface
    w0 = jgeo.params['sdf']['mlp'][0]['w']
    jgeo.params['sdf']['mlp'][0]['w'] = w0 + 0.005 * jax.random.normal(
        jax.random.PRNGKey(7), w0.shape)
    jgeo.save(str(d / 'model.pkl'))
    with open(d / 'model.pkl', 'rb') as f:
        payload = pickle.load(f)
    geo_checkpoint_from_jax(payload, str(d / 'model.pt'))

    jmt = JaxMatTrainer(jconfig.load_config(extra=MAT), str(d / 'model.pkl'))
    jmt.init_dataset()
    # the fields start 1e-4 small: scale them so materials vary by point
    for name in ('mat_field', 'flow_diffuse', 'flow_specular'):
        f = jmt.params[name]['field'] if name.startswith('flow') \
            else jmt.params[name]
        f['planes'] = [x * 3e3 for x in f['planes']]
    jmt.tx, jmt.opt_state = jmt.tx, jmt.tx.init(jmt.params)

    pmt = _JaxDrawsTrainer(pconfig.load_config(extra=MAT),
                           str(d / 'model.pt'), device='cpu')
    pmt.key = jmt.rng
    pmt.own_grid = pmt.grid
    pmt.grid = _port_grid(jmt.grid)
    pmt.set_params(params_from_jax(_np(jmt.params)))
    return jmt, pmt


def test_geo_checkpoint_and_baked_grid_carry_over(pair):
    jmt, pmt = pair
    assert pmt.rcfg.sdf.grid_size == tuple(jmt.rcfg.sdf.grid_size)
    assert pmr.unit_size(pmt.rcfg) == pytest.approx(jmr.unit_size(jmt.rcfg))
    for (pp, pl), (jp, jl) in zip(
            sorted(named_leaves(pmt.geo_params), key=lambda x: str(x[0])),
            sorted(_jax_leaves(jmt.geo_params).items(),
                   key=lambda x: str(x[0]))):
        assert pp == jp
        np.testing.assert_array_equal(pl.numpy(), jl)
    # the port's own bake of the converted checkpoint: the same bfloat16
    # tables up to one rounding step (8 bits of mantissa) where the two
    # float32 SDF evaluations differ in their last bits
    own, ref = pmt.own_grid, pmt.grid
    for name in ('mid_rows', 'blocks', 'coarse_rows'):
        a, b = getattr(own, name).float(), getattr(ref, name).float()
        assert a.shape == b.shape
        assert float(((a - b).abs() / (b.abs() + 1e-3)).max()) < 1e-2, name
        assert float((a == b).float().mean()) > 0.99, name
    assert float((own.vis_rows == ref.vis_rows).float().mean()) > 0.99
    assert own.vis_pad == pytest.approx(ref.vis_pad)


def test_trace_surface_matches_jax(pair):
    """Primary hits of the first 1,500 training rays: hit masks exact,
    depths / points / normals of the hits to 2e-4 (two float32 marches of
    the neural SDF)."""
    jmt, pmt = pair
    info_o = jmt.batcher.batch['rays_o'][:200]
    assert len(info_o) == 200
    rng = np.random.RandomState(0)
    o = np.concatenate([info_o, info_o + 0.3 * rng.randn(200, 3)]).astype(
        np.float32)
    tgt = rng.uniform(-0.4, 0.4, (400, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rcfg = jmt.rcfg
    jout = jax.jit(lambda geo, grid, oo, dd: jmr.trace_surface(
        geo, rcfg, grid, oo, dd))(jmt.geo_params, jmt.grid, jnp.asarray(o),
                                  jnp.asarray(d))
    pout = pmr.trace_surface(pmt.geo_params, pmt.rcfg, pmt.grid, _t(o),
                             _t(d))
    hit = np.array(jout[3])
    np.testing.assert_array_equal(pout[3].numpy(), hit)
    assert 0.05 < hit.mean() < 0.95
    for name, p, j in zip(('inters', 'normals', 'depth'), pout, jout):
        np.testing.assert_allclose(p.numpy()[hit], np.asarray(j)[hit],
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_port_init_dataset_traces_the_same_hits(pair):
    jmt, pmt = pair
    pmt.init_dataset()
    assert pmt.tbn == jmt.tbn
    assert pmt.kept_share == pytest.approx(jmt.tbn / (3 * 32 * 32), rel=1e-6)
    # both batchers shuffle with the same numpy seed
    for k in ('inters', 'normals', 'rays_d', 'rgb'):
        np.testing.assert_allclose(pmt.batcher.batch[k],
                                   jmt.batcher.batch[k], rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def _jax_run(jmt, n_steps):
    """n_steps of the JAX MaterialTrainer.train loop with the step's
    loss_fn (MaterialTrainer._get_step_fn) jitted to also return grads."""
    runs, params1, batches = [], None, []
    for step in range(n_steps):
        jmt.update_flow_copies(step)
        phase = jmt.phase(step)
        batch = jmt.batcher.next_batch()
        batches.append(batch)
        weights = jlosses.schedule_weights(jmt.cfg, step)
        rcfg, tx = jmt.rcfg, jmt.tx

        @jax.jit
        def step_fn(params, opt_state, grid, batch, weights, rng, fc_d,
                    fc_s, phase=phase, step=step):
            def loss_fn(p):
                out = jmr.train_step_outputs(p, rcfg, grid, batch, phase,
                                             rng, jnp.asarray(step), fc_d,
                                             fc_s)
                total, terms = jlosses.total_loss_material(out, weights)
                return total, {'psnr': out['psnr'],
                               'variance': out['variance'], **terms}
            (total, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state,
                    {**aux, 'loss': total}, grads)

        jmt.rng, k = jax.random.split(jmt.rng)
        jmt.params, jmt.opt_state, aux, grads = step_fn(
            jmt.params, jmt.opt_state, jmt.grid, batch, weights, k,
            jmt.flow_copies.get('diffuse'), jmt.flow_copies.get('specular'))
        runs.append(({k_: float(v) for k_, v in aux.items()},
                     _jax_leaves(grads), phase))
        if step == 0:
            params1 = _jax_leaves(jmt.params)
    return runs, params1, batches


@pytest.fixture(scope='module')
def runs(pair):
    jmt, pmt = pair
    jruns, jparams1, batches = _jax_run(jmt, 3)

    class FixedBatches:
        def __init__(self, bs):
            self.bs = list(bs)

        def next_batch(self):
            return self.bs.pop(0)

    pmt.batcher = FixedBatches(batches)
    pmt.start_step = 0
    plogs = pmt.train(n_steps=1, log_every=1)
    leaves = named_leaves(pmt.params)
    pgrads = {path: t.grad.clone().numpy() for path, t in leaves}
    pparams1 = {path: t.detach().clone().numpy() for path, t in leaves}
    phases = [pmt.phase(0)]
    for step in (1, 2):
        plogs += pmt.train(n_steps=1, log_every=1)
        phases.append(pmt.phase(step))
    return dict(jruns=jruns, jparams1=jparams1, plogs=plogs, pgrads=pgrads,
                pparams1=pparams1, phases=phases, pmt=pmt)


def test_step_loss_terms_match_jax(runs):
    j_terms, _, _ = runs['jruns'][0]
    p_terms = runs['plogs'][0]
    assert set(j_terms) <= set(p_terms)
    for k, v in j_terms.items():
        np.testing.assert_allclose(p_terms[k], v, rtol=2e-4, atol=1e-7,
                                   err_msg=k)
    for k in ('secondary_cand_rate', 'secondary_hit_rate',
              'secondary_a1_rate'):
        assert 0.0 <= p_terms[k] <= 1.0


def test_step_grads_match_jax(runs):
    _, j_grads, _ = runs['jruns'][0]
    p_grads = runs['pgrads']
    assert sorted(map(str, j_grads)) == sorted(map(str, p_grads))
    for path, jg in j_grads.items():
        scale = float(np.abs(jg).max()) + 1e-12
        np.testing.assert_allclose(p_grads[path] / scale, jg / scale,
                                   atol=2e-3, err_msg=f'grad {path}')


def test_step_adam_params_match_jax(runs):
    _, j_grads, _ = runs['jruns'][0]
    for path, jp in runs['jparams1'].items():
        pp = runs['pparams1'][path]
        # Adam's first update is lr * g / (|g| + 1e-8): it is settled only
        # where |g| stands clear of 1e-8 and of the two sides' rounding
        g = np.abs(j_grads[path])
        settled = g > max(1e-6, 1e-3 * float(g.max()))
        np.testing.assert_allclose(pp[settled], jp[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=f'param {path}')
        lr = 1e-2 * 1.001
        assert float(np.abs(pp - jp).max()) <= 2 * lr, path


def test_three_step_loss_trace_crosses_the_three_phases(runs):
    assert [l['step'] for l in runs['plogs']] == [1, 2, 3]
    names = []
    for step, ((jt, _, jphase), pl, pphase) in enumerate(
            zip(runs['jruns'], runs['plogs'], runs['phases'])):
        assert tuple(pphase) == tuple(jphase)
        names.append((pphase.nis_loss_diffuse, pphase.nis_sample_diffuse))
        for k in ('loss', 'loss_rgb', 'loss_mat_reg', 'loss_diffuse_light',
                  'loss_nis', 'psnr'):
            np.testing.assert_allclose(pl[k], jt[k], rtol=2e-3, atol=1e-7,
                                       err_msg=f'step {step} {k}')
    assert names == [(False, False), (True, False), (True, True)]
    pmt = runs['pmt']
    # the frozen copies are detached clones the optimizer never sees
    opt_ids = {id(t) for t in pmt.opt.params}
    for t in jax.tree.leaves(pmt.flow_copies):
        assert not t.requires_grad and id(t) not in opt_ids


def test_estimator_variance_matches_jax_in_each_nis_phase(runs):
    """The MC estimator's variance, the metric of the NIS A/B
    (tensoflow_tpu_torch/scripts/ab_material.py), in each of the three
    phases, the step that samples from the frozen flow copies included."""
    for step, ((jt, _, _), pl) in enumerate(zip(runs['jruns'],
                                                runs['plogs'])):
        np.testing.assert_allclose(pl['variance'], jt['variance'],
                                   rtol=2e-3, atol=1e-7,
                                   err_msg=f'step {step}')


def test_material_checkpoint_resume_flow_semantics(runs, tmp_path):
    """Resume as the reference has it: flow params restart from a fresh
    init (with zero moments) and the frozen copies are cleared;
    reset_flows=False restores everything exactly."""
    pmt = runs['pmt']
    path = str(tmp_path / 'mat.pt')
    pmt.save(path)
    ckpt = pckpt.load_checkpoint(path)
    assert {'params', 'kwargs', 'step', 'opt_state',
            'flow_copies'} <= set(ckpt)
    geo = str(tmp_path / 'geo.pt')
    pckpt.save_checkpoint(geo, {
        'step': 0, 'params': pmt.geo_params,
        'kwargs': {'grid_size': list(pmt.rcfg.sdf.grid_size),
                   'sdf_n_comp': 4, 'sdf_dim': 32, 'app_dim': 16,
                   'n_levels': 1, 'sdf_multires': 3,
                   'aabb': [list(a) for a in pmt.rcfg.aabb]}})
    cfg = pconfig.load_config(extra=MAT)

    resumed = MaterialTrainer(cfg, geo, device='cpu')
    resumed.load(path)
    assert resumed.start_step == pmt.start_step == 3
    assert resumed.flow_copies == {}
    assert torch.equal(resumed.params['metallic']['layers'][0]['v'],
                       pmt.params['metallic']['layers'][0]['v'])
    tr = pmt.params['flow_diffuse']['blocks'][0]['layers'][0]['w']
    rs = resumed.params['flow_diffuse']['blocks'][0]['layers'][0]['w']
    assert tr.shape == rs.shape and not torch.allclose(tr, rs)
    assert resumed.opt.count == pmt.opt.count == 3
    moments = resumed.opt.state()['moments']
    for p, (m, v) in moments.items():
        if p.startswith("('flow"):
            assert float(m.abs().max()) == 0.0 and float(v.max()) == 0.0
    assert any(float(m.abs().max()) > 0 for m, _ in moments.values())

    exact = MaterialTrainer(cfg, geo, device='cpu')
    exact.load(path, reset_flows=False)
    assert torch.equal(
        exact.params['flow_diffuse']['blocks'][0]['layers'][0]['w'], tr)
    assert 'diffuse' in exact.flow_copies
    saved, got = pmt.opt.state()['moments'], exact.opt.state()['moments']
    assert sorted(saved) == sorted(got)
    for k, (m0, v0) in saved.items():
        assert torch.equal(m0, got[k][0]) and torch.equal(v0, got[k][1])
    # a resumed trainer goes on training
    exact.init_dataset()
    logs = exact.train(n_steps=1, log_every=1)
    assert logs[0]['step'] == 4 and np.isfinite(logs[0]['loss'])


def test_shape_trainer_checkpoint_roundtrip(tmp_path):
    overrides = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2',
                 'sdf_dim=16', 'app_dim=8', 'N_voxel_init=4096',
                 'N_voxel_final=4096', 'occ_grid_reso=8', 'train_ray_num=16',
                 'occ_max_samples=16', 'occ_loss_max_pn=16',
                 'upsample_list=null', 'compact_samples_per_ray=8']
    cfg = pconfig.load_config('configs/shape/syn/compressor_occ.yaml',
                              overrides=overrides)
    a = ShapeTrainer(cfg, device='cpu')
    a.train(n_steps=2, log_every=1)
    path = str(tmp_path / 'model.pt')
    a.save(path)
    b = ShapeTrainer(cfg, device='cpu')
    b.load(path)
    assert b.start_step == 2 and b.opt.count == 2
    assert b.rcfg == a.rcfg
    for (pa, ta), (pb, tb) in zip(named_leaves(a.params),
                                  named_leaves(b.params)):
        assert pa == pb and torch.equal(ta, tb)
    for k, v in a.occ_state.items():
        assert torch.equal(v, b.occ_state[k])
        assert v.dtype == b.occ_state[k].dtype
    # the resumed trainer goes on from step 2
    logs = b.train(n_steps=1, log_every=1)
    assert logs[0]['step'] == 3 and np.isfinite(logs[0]['loss'])
    # a MaterialTrainer opens what ShapeTrainer.save wrote
    m = MaterialTrainer(pconfig.load_config(extra={
        **MAT, 'database_name': 'toy/sphere_16_2', 'bake_resolution': 16}),
        path, device='cpu')
    assert m.rcfg.sdf.n_comp == 2 and m.grid.vis_rows is not None

