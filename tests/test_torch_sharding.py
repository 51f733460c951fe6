"""The port's multi-device training (parallel/sharding.py) on the CPU.

Two gloo ranks, spawned from this file (``python tests/test_torch_sharding.py
<rank> <ranks> <port> <case file>``), train the same configurations as the
port's single-device trainer in this process; every rank draws the same
global batch and noise and takes its slice.  The configurations make a
per-rank shortcut fail: the stage-1 compaction budget overflows (fewer
slots than valid samples), ``occ_loss_max_pn`` is smaller than the
qualifying samples, and stage 2's refinement, coarse-march and
inner-light budgets overflow with both NIS flows sampling and training.

Tolerances: loss terms rtol 2e-4 / atol 2e-5, as tests/test_sharding.py
holds the JAX sharded step to its single-device step; every gradient
within 1e-4 of its largest magnitude (the ranks' partial sums are added
in another order); the ranks' parameters equal bit for bit.  Against the
JAX package's sharded step on its 8-device CPU mesh (whose 'auto' stencil
route is its split 'xla' route, the port's being the kernels' plain
version): loss terms rtol 1e-4 / atol 1e-6, the spread between those
routes' outputs in tests/test_torch_field_variants.py.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':
    sys.path.insert(0, ROOT)

from tensoflow_tpu_torch import config as pconfig  # noqa: E402
from tensoflow_tpu_torch.parallel import dryrun, sharding  # noqa: E402
from tensoflow_tpu_torch.train.trainer import (ShapeTrainer,  # noqa: E402
                                               named_leaves)
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer  # noqa

RANKS = 2
OCC_CFG = os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml')
HIER_CFG = os.path.join(ROOT, 'configs/shape/syn/compressor.yaml')
# 64 rays x 4 slots against ~20 valid samples a ray; every valid sample
# within the (wide) SDF band qualifies for the occ loss, which takes 16
OCC = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
       'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
       'occ_grid_reso=16', 'train_ray_num=64', 'occ_max_samples=48',
       'occ_loss_max_pn=16', 'occ_sdf_thresh=100.0', 'upsample_list=null',
       'compact_samples_per_ray=4', 'name=shard_occ']
HIER = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
        'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
        'train_ray_num=32', 'n_samples=8', 'n_importance=8',
        'up_sample_steps=2', 'occ_loss_step=0', 'occ_loss_max_pn=16',
        'occ_sdf_thresh=100.0', 'upsample_list=null', 'name=shard_hier']
# the validation case: 16x16 views of the sphere's initial field; a group
# timeout shorter than one rank rendering all four views would take
VAL = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
       'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
       'sdf_multires=0', 'init_radius=0.5', 'test_ray_num=256',
       'split_manul=false', 'name=shard_val']
VIEW_S, VAL_TIMEOUT = 2.5, 6.0
GEO = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
       'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
       'sdf_multires=0', 'init_radius=0.5', 'name=shard_geo']
# both flows sample (copies from step 0) and train (loss from step 0);
# the budgets overflow: fewer slots than candidates, coarse-march rays
# and hits
MAT = {'name': 'shard_mat', 'isMaterial': True,
       'database_name': 'toy/sphere_32_4', 'dataset_dir': 'unused',
       'nerfDataType': True, 'train_ray_num': 128, 'bake_resolution': 32,
       'refine_with_neural_sdf': False,
       'shader_cfg': {'diffuse_sample_num': 16, 'specular_sample_num': 8,
                      'nis_diffuse_sample_num': 8,
                      'nis_specular_sample_num': 8, 'nis_start_iter': 1,
                      'nis_loss_iter': 0, 'nis_update_interval': 1,
                      'grid_size': (16, 16, 16), 'light_reso': 8,
                      'mat_n_comp': 4, 'estimator_dtype': 'f32',
                      'secondary_budget': 0.375, 'a1_budget': 0.125,
                      'inner_light_budget': 0.03125}}


def _noised(trainer, seed):
    """The W0 feature rows noised (the geometric init zeroes them), so the
    gradients run through the field."""
    gen = torch.Generator().manual_seed(seed)
    params = trainer.params
    w0 = params['sdf']['mlp'][0]['w']
    params['sdf']['mlp'][0]['w'] = (
        w0.detach() + 0.05 * torch.randn(w0.shape, generator=gen)).clone()
    trainer.set_params(params)
    return trainer


def _state(trainer):
    leaves = named_leaves(trainer.params)
    return ({str(p): t.grad.clone() for p, t in leaves},
            {str(p): t.detach().clone() for p, t in leaves})


def case_occ(mesh, ctx):
    """Three occupancy-grid steps (the first one's grads kept)."""
    t = _noised(ShapeTrainer(pconfig.load_config(OCC_CFG, overrides=OCC),
                             device='cpu', mesh=mesh), 7)
    t.init_dataset()
    logs = t.train(n_steps=1, log_every=1)
    grads, _ = _state(t)
    logs += t.train(n_steps=2, log_every=1)
    return {'logs': logs, 'grads': grads, 'params': _state(t)[1],
            'cps': t.rcfg.compact_samples_per_ray}


def case_hier(mesh, ctx):
    """One step of the hierarchical sampler with the live occ loss."""
    t = _noised(ShapeTrainer(pconfig.load_config(HIER_CFG, overrides=HIER),
                             device='cpu', mesh=mesh), 8)
    t.init_dataset()
    logs = t.train(n_steps=1, log_every=1)
    grads, params = _state(t)
    return {'logs': logs, 'grads': grads, 'params': params}


def _blobs_grid(t):
    """Three overlapping spheres baked as bake_geometry bakes the field:
    secondary rays from one meet the others."""
    from tensoflow_tpu_torch.models import material_renderer as mr
    from tensoflow_tpu_torch.ops import sdf_trace
    centers = torch.tensor([[-0.35, -0.2, 0.0], [0.35, -0.2, 0.0],
                            [0.0, 0.35, 0.1]])

    def sdf_fun(x):
        return (torch.cdist(x, centers) - 0.33).min(-1, keepdim=True).values
    dense = sdf_trace.bake_sdf_grid(sdf_fun, t.rcfg.aabb,
                                    t.rcfg.bake_resolution)
    return sdf_trace.bake_vis_cache(sdf_trace.pack_sdf_grid(dense),
                                    apex_pad=2.0 * mr.unit_size(t.rcfg))


def case_mat(mesh, ctx):
    """One stage-2 step with both flows sampling and training, on the
    blobs' baked grid (primary hits unrefined)."""
    t = MaterialTrainer(pconfig.load_config(extra=MAT), ctx['geo'],
                        device='cpu', mesh=mesh)
    t.grid = _blobs_grid(t)
    t.init_dataset()
    logs = t.train(n_steps=1, log_every=1)
    ph = t.phase(0)
    grads, params = _state(t)
    return {'logs': logs, 'grads': grads, 'params': params,
            'phase': tuple(ph), 'budgets': _budgets(t)}


def _budgets(t):
    """The step's global secondary-ray count and its slot budgets."""
    from tensoflow_tpu_torch.ops.sdf_trace import budget_slots
    s = t.rcfg.shader
    n = t.cfg['train_ray_num'] * (s.diffuse_sample_num
                                  + s.nis_diffuse_sample_num
                                  + s.nis_specular_sample_num)
    return {'n': n, 'cand': budget_slots(n, s.secondary_budget),
            'a1': budget_slots(n, s.a1_budget),
            'hit': budget_slots(n, min(s.inner_light_budget,
                                       s.secondary_budget))}


def case_jax(mesh, ctx):
    """One occupancy-grid step from the JAX trainer's params, occupancy
    state and draws (written by the test into ctx['jax'])."""
    from tensoflow_tpu_torch.convert import (occ_state_from_jax,
                                             params_from_jax)
    saved = torch.load(ctx['jax'], weights_only=False)

    class Draws(ShapeTrainer):
        def occ_jitter(self, step):
            return saved['occ_jitter']

        def step_noise(self, step):
            return dict(saved['noise'])

    t = Draws(pconfig.load_config(OCC_CFG, overrides=saved['overrides']),
              device='cpu', mesh=mesh)
    t.set_params(params_from_jax(saved['params']))
    t.occ_state = occ_state_from_jax(saved['occ_state'])
    t.init_dataset()
    return {'logs': t.train(n_steps=1, log_every=1)}


def case_validate(mesh, ctx):
    """A validation of four views, each held ctx['view_s'] seconds longer
    than its render takes; returns the PSNR and the views this rank
    rendered."""
    t = ShapeTrainer(pconfig.load_config(HIER_CFG, overrides=VAL),
                     device='cpu', mesh=mesh)
    t.init_dataset()
    t.test_ids = [0, 1, 2, 3]
    seen, view = [], t._view_psnr

    def slow(vid, downsample):
        seen.append(vid)
        time.sleep(ctx.get('view_s', 0.0))
        return view(vid, downsample)
    t._view_psnr = slow
    return {'psnr': t.validate(), 'views': seen}


CASES = {'occ': case_occ, 'hier': case_hier, 'mat': case_mat,
         'jax': case_jax, 'validate': case_validate}


def _worker(rank: int, ranks: int, port: int, ctx_path: str):
    torch.set_num_threads(2)
    with open(ctx_path) as f:
        ctx = json.load(f)
    mesh = sharding.init_multihost(f'localhost:{port}', ranks, rank,
                                   device='cpu', timeout=ctx.get('timeout'))
    out = {name: CASES[name](mesh, ctx) for name in ctx['cases']}
    torch.save(out, os.path.join(ctx['out'], f'rank{rank}.pt'))
    sharding.shutdown(mesh)


def spawn_ranks(tmp, ctx, ranks=RANKS):
    """Run ctx['cases'] on ``ranks`` gloo ranks; returns each rank's
    results."""
    ctx = dict(ctx, out=str(tmp))
    path = os.path.join(str(tmp), 'ctx.json')
    with open(path, 'w') as f:
        json.dump(ctx, f)
    port = dryrun.free_port()
    env = dict(os.environ, OMP_NUM_THREADS='2')
    res = dryrun.spawn(lambda r: [sys.executable, os.path.abspath(__file__),
                                  str(r), str(ranks), str(port), path],
                       ranks, str(tmp), timeout=600, env=env, cwd=str(tmp))
    assert all(rc == 0 for rc, _ in res), '\n'.join(
        f'rank {r} exited with {rc}:\n{out}' for r, (rc, out) in
        enumerate(res))
    return [torch.load(os.path.join(str(tmp), f'rank{r}.pt'),
                       weights_only=False) for r in range(ranks)]


def _geo_checkpoint(path):
    ShapeTrainer(pconfig.load_config(HIER_CFG, overrides=GEO),
                 device='cpu').save(path)


def _jax_sharded_step(path):
    """One step of JaxShapeTrainer(mesh=make_mesh()) on the 8-device CPU
    mesh; its params, occupancy state and draws (the key chain of its
    train loop, as tests/test_torch_train_step.py draws them) go to
    ``path`` for case_jax.  Returns the JAX step's log."""
    import jax
    from tensoflow_tpu import config as jconfig
    from tensoflow_tpu.parallel import sharding as jsharding
    from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
    from test_torch_train_step import _JaxDrawsTrainer

    over = OCC[:-1] + ['name=shard_jax']
    mesh = jsharding.make_mesh()
    assert mesh.devices.size == 8
    jt = JaxShapeTrainer(jconfig.load_config(OCC_CFG, overrides=over),
                         mesh=mesh)
    k = jax.random.PRNGKey(7)
    w0 = jt.params['sdf']['mlp'][0]['w']
    jt.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        k, w0.shape)
    jt.params = jsharding.replicate_tree(mesh, jt.params)
    jt.init_dataset()
    draws = _JaxDrawsTrainer(pconfig.load_config(OCC_CFG, overrides=over),
                             jt.rng)
    draws.maybe_set_march_stride(0)
    torch.save({'overrides': over,
                'params': jax.tree.map(np.asarray, jt.params),
                'occ_state': jax.tree.map(np.asarray, jt.occ_state),
                'occ_jitter': draws.occ_jitter(0),
                'noise': draws.step_noise(0)}, path)
    return jt.train(n_steps=1, log_every=1)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The cases on two ranks (one spawn) and on one device; the JAX
    sharded step."""
    tmp = tmp_path_factory.mktemp('shard')
    ctx = {'cases': ['occ', 'hier', 'mat', 'jax'], 'geo': str(tmp / 'geo.pt'),
           'jax': str(tmp / 'jax.pt')}
    _geo_checkpoint(ctx['geo'])
    jlogs = _jax_sharded_step(ctx['jax'])
    torch.set_num_threads(2)
    single = {name: CASES[name](None, ctx) for name in ('occ', 'hier',
                                                         'mat')}
    return {'single': single, 'jax': jlogs, 'ranks': spawn_ranks(tmp, ctx)}


def _close_terms(got, want, rtol=2e-4, atol=2e-5):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == 'step':
            assert got[k] == v
            continue
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def _close_grads(got, want, tol=1e-4):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = float(w.abs().max()) + 1e-12
        np.testing.assert_allclose((got[k] / scale).numpy(),
                                   (w / scale).numpy(), rtol=0, atol=tol,
                                   err_msg=f'grad {k}')


@pytest.mark.parametrize('case', ['occ', 'hier', 'mat'])
def test_sharded_step_matches_single_device(runs, case):
    """The first step's loss terms (global on every rank) and gradients
    (after the all-reduce) equal the single-device step's."""
    single = runs['single'][case]
    for r, res in enumerate(runs['ranks']):
        _close_terms(res[case]['logs'][0], single['logs'][0])
        _close_grads(res[case]['grads'], single['grads'])


@pytest.mark.parametrize('case', ['occ', 'hier', 'mat'])
def test_ranks_hold_identical_params(runs, case):
    """After the all-reduce and Adam every rank holds the same bits (three
    steps on the occupancy grid, one on the others)."""
    first = runs['ranks'][0][case]['params']
    for res in runs['ranks'][1:]:
        for k, t in first.items():
            assert torch.equal(res[case]['params'][k], t), k
    if case == 'occ':
        assert [r['step'] for r in runs['ranks'][0]['occ']['logs']] == \
            [1, 2, 3]


def test_budgets_overflow_so_shards_must_agree(runs):
    """The configurations take the paths where per-rank compaction or
    selection would differ: the compaction keeps fewer samples than are
    valid, the occ loss selects fewer samples than qualify, and stage 2's
    trace overflows its refinement and inner-light budgets."""
    occ = runs['single']['occ']
    assert occ['logs'][0]['sample_num'] > 2 * occ['cps']
    mat = runs['single']['mat']
    b, log = mat['budgets'], mat['logs'][0]
    assert mat['phase'] == (True, True, True, True)
    assert log['secondary_cand_rate'] * b['n'] > 1.5 * b['cand']
    assert log['secondary_hit_rate'] * b['n'] > 1.5 * b['hit']
    assert log['secondary_a1_rate'] * b['n'] > b['a1']


def test_pad_to_multiple_matches_jax():
    from tensoflow_tpu.parallel import sharding as jsharding
    rng = np.random.RandomState(0)
    batch = {'rays_o': rng.rand(13, 3).astype(np.float32),
             'masks': rng.rand(13, 1).astype(np.float32)}
    for mult in (1, 4, 8, 13, 16):
        got, n = sharding.pad_to_multiple(batch, mult)
        want, jn = jsharding.pad_to_multiple(batch, mult)
        assert n == jn == 13
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])


def test_one_rank_mesh_and_shards():
    """Without a coordinator or a launcher's group: one rank, no
    collectives (every path as without a mesh); the shards of a batch are
    its contiguous slices."""
    mesh = sharding.init_multihost(device='cpu')
    assert (mesh.rank, mesh.size, mesh.distributed) == (0, 1, False)
    assert not sharding.active(mesh)
    two = sharding.Mesh(1, 2, torch.device('cpu'), True)
    batch = {'a': np.arange(8)}
    np.testing.assert_array_equal(sharding.shard_batch(two, batch)['a'],
                                  np.arange(4, 8))
    with pytest.raises(ValueError, match='divide'):
        sharding.shard_range(two, 7)


def test_sharded_step_matches_jax_sharded_step(runs):
    """The port's 2-rank step against JaxShapeTrainer(mesh=make_mesh())
    on the 8-device CPU mesh, from the JAX params and draws."""
    jlog = runs['jax'][0]
    for res in runs['ranks']:
        got = res['jax']['logs'][0]
        for k, v in jlog.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_validation_shares_views_within_a_short_group_timeout(
        tmp_path, monkeypatch):
    """Each rank renders its share of the held-out views and one
    all-reduce gives every rank the mean over all of them, which equals
    the single-device validation.  The group's timeout is shorter than one
    rank rendering all four views would take, so no rank may wait out
    another's renders in a collective."""
    assert 4 * VIEW_S > VAL_TIMEOUT
    monkeypatch.chdir(tmp_path)
    single = case_validate(None, {})
    ranks = spawn_ranks(tmp_path, {'cases': ['validate'],
                                   'timeout': VAL_TIMEOUT,
                                   'view_s': VIEW_S})
    assert single['views'] == [0, 1, 2, 3]
    assert [r['validate']['views'] for r in ranks] == [[0, 2], [1, 3]]
    for r in ranks:
        assert r['validate']['psnr'] == pytest.approx(single['psnr'],
                                                      rel=1e-12)


def test_run_training_multihost_two_cpu_ranks(tmp_path):
    """``run_training --multihost`` with two CPU ranks and one step: both
    ranks train, rank 0 writes the checkpoint and the log."""
    port = dryrun.free_port()
    tiny = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
            'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=512',
            'train_ray_num=16', 'n_samples=8', 'n_importance=8',
            'upsample_list=null', 'init_radius=0.5', 'sdf_multires=0',
            'split_manul=false', 'save_interval=1', 'val_interval=1000',
            'train_log_step=1', 'name=cli_multihost']
    cfg = os.path.join(ROOT, 'configs/shape/toy/sphere.yaml')
    env = dict(os.environ, OMP_NUM_THREADS='2',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                            ''))
    res = dryrun.spawn(
        lambda r: [sys.executable, '-m', 'tensoflow_tpu_torch.run_training',
                   '--cfg', cfg, '--steps', '1', '--device', 'cpu',
                   '--multihost', f'localhost:{port}', '--num-processes',
                   '2', '--process-id', str(r), *tiny],
        2, str(tmp_path), timeout=600, env=env, cwd=str(tmp_path))
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f'rank {r}:\n{out}'
        assert '[mesh] 2 devices' in out, out
        assert f'training done at step 1 (rank {r})' in out, out
    assert 'loss=' in res[0][1] and 'loss=' not in res[1][1]
    assert (tmp_path / 'data/model/cli_multihost/model.pkl').exists()


def test_dryrun_two_gloo_ranks():
    """``python -m tensoflow_tpu_torch.parallel.dryrun --ranks 2`` on the
    CPU: both stages' sharded steps give finite losses."""
    env = dict(os.environ, OMP_NUM_THREADS='2',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                            ''))
    out = subprocess.run(
        [sys.executable, '-m', 'tensoflow_tpu_torch.parallel.dryrun',
         '--ranks', '2', '--device', 'cpu'], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'dryrun(2 ranks): stage-1 loss=' in out.stdout, out.stdout
    assert 'dryrun(2 ranks): stage-2 loss=' in out.stdout, out.stdout


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
