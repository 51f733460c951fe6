"""The port's evidence scripts (tensoflow_tpu_torch/scripts/) against the
JAX repo's scripts/convergence_run.py, convergence_mat.py and
ab_material.py, which are loaded from their files and left unchanged:

  * (a) every config the JAX scripts build (the blobs run, the material
    run's stage 1 and stage 2, the A/B run's stage 1 and its three arms)
    equals the port's, key for key: the JAX trainers are replaced by stubs
    that capture the config;
  * (b) chamfer_vs_gt of the port on converted JAX parameters equals the
    JAX script's at res=32 (rtol 1e-4; both meshes have >= 100 vertices);
  * (c) surface_material_maps of the port on converted stage-2 parameters
    equals the JAX script's (atol 1e-5);
  * (d) each script's run function end to end on the CPU at a toy size:
    the JSON it writes carries every key of the JAX artifact, finite
    values, the device and each phase's wall clock.
"""
import importlib.util
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.fields import mc_shading as jmc
from tensoflow_tpu.train import trainer as jtrainer
from tensoflow_tpu.train import trainer_mat as jtrainer_mat
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.scripts import (ab_material, convergence_mat,
                                         convergence_run, record)
from tensoflow_tpu_torch.train.trainer import ShapeTrainer
from tensoflow_tpu_torch.train.trainer_mat import build_material_config

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Captured(Exception):
    pass


def _load_jax_script(name, monkeypatch):
    """scripts/<name>.py as a module, with sys.argv holding no argument
    (its defaults)."""
    monkeypatch.setattr(sys, 'argv', [f'{name}.py'])
    monkeypatch.setattr(sys, 'path', list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f'jax_script_{name}', os.path.join(ROOT, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_configs(name, monkeypatch, tmp_path):
    """The configs scripts/<name>.py hands its trainers: 'shape' and, past
    a stub stage 1, 'mat' (the first stage-2 trainer it builds)."""
    captured = {}
    stop_at_shape = name == 'convergence_run'

    class Shape:
        def __init__(self, cfg):
            captured['shape'] = cfg
            if stop_at_shape:
                raise _Captured

        def init_dataset(self):
            pass

        def train(self, n_steps, log_every):
            return [{'psnr': 0.0}]

        def save(self, path):
            pass

    def mat(cfg, geo_path):
        captured['mat'] = cfg
        raise _Captured

    monkeypatch.setattr(jtrainer, 'ShapeTrainer', Shape)
    monkeypatch.setattr(jtrainer_mat, 'MaterialTrainer', mat)
    monkeypatch.chdir(tmp_path)
    mod = _load_jax_script(name, monkeypatch)
    with pytest.raises(_Captured):
        mod.main()
    return mod, captured


ARMS = {f'ab_{n}': (n, on, budgeted) for n, on, budgeted in ab_material.ARMS}


@pytest.mark.parametrize('which', ['run', 'mat_shape', 'mat', 'ab_shape',
                                   *ARMS])
def test_configs_equal_the_jax_scripts(which, monkeypatch, tmp_path):
    if which == 'run':
        _, cap = _jax_configs('convergence_run', monkeypatch, tmp_path)
        want, got = cap['shape'], convergence_run.shape_config()
    elif which in ('mat_shape', 'mat'):
        _, cap = _jax_configs('convergence_mat', monkeypatch, tmp_path)
        want = cap['shape' if which == 'mat_shape' else 'mat']
        got = convergence_mat.shape_config() if which == 'mat_shape' else \
            convergence_mat.mat_config('conv_mat',
                                       convergence_mat.shader(1500))
    else:
        mod, cap = _jax_configs('ab_material', monkeypatch, tmp_path)
        if which == 'ab_shape':
            want, got = cap['shape'], convergence_mat.shape_config(
                'ab_mat_shape')
        else:
            name, on, budgeted = ARMS[which]
            # the first arm is the one the JAX script built itself
            if name == 'budgeted_nis':
                assert cap['mat'] == mod.mat_config(
                    jconfig, which, 1500, on, budgeted)
            want = mod.mat_config(jconfig, which, 1500, on, budgeted)
            got = ab_material.mat_config(which, 1500, on, budgeted)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


SMALL_SHAPE = {'database_name': 'toy/sphere_32_4', 'sdf_n_comp': 4,
               'sdf_dim': 32, 'app_dim': 16, 'N_voxel_init': 24 ** 3,
               'N_voxel_final': 24 ** 3, 'upsample_list': None,
               'init_radius': 0.5, 'sdf_multires': 0}


def test_chamfer_equals_the_jax_script(monkeypatch):
    mod = _load_jax_script('convergence_run', monkeypatch)
    cfg = convergence_run.shape_config(extra=SMALL_SHAPE)
    jt = jtrainer.ShapeTrainer(jconfig.load_config(extra=cfg))
    w0 = jt.params['sdf']['mlp'][0]['w']
    jt.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        jax.random.PRNGKey(5), w0.shape)
    pt = ShapeTrainer(cfg, device='cpu')
    pt.set_params(params_from_jax(jax.tree.map(np.asarray, jt.params)))
    want, n_want = mod.chamfer_vs_gt(jt, res=32)
    got, n_got = convergence_run.chamfer_vs_gt(pt, res=32)
    assert n_got == n_want and n_got >= 100
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_surface_material_maps_equal_the_jax_script(monkeypatch):
    mod = _load_jax_script('ab_material', monkeypatch)
    geo = {'grid_size': [24, 24, 24], 'n_levels': 1, 'sdf_n_comp': 4,
           'sdf_dim': 32, 'app_dim': 16, 'sdf_multires': 0,
           'aabb': [[-1.0] * 3, [1.0] * 3]}
    jcfg = mod.mat_config(jconfig, 'maps', 1500, True, True)
    jrcfg = jtrainer_mat.build_material_config(jcfg, geo)
    # initial weights with noise on every leaf: maps that vary over the
    # probe points
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(
            np.float32), jmc.init_mc_shading(jax.random.PRNGKey(3),
                                             jrcfg.shader))
    want = mod.surface_material_maps(types.SimpleNamespace(
        params=jax.tree.map(jnp.asarray, params), rcfg=jrcfg))
    got = ab_material.surface_material_maps(types.SimpleNamespace(
        params=params_from_jax(params),
        rcfg=build_material_config(
            ab_material.mat_config('maps', 1500, True, True), geo),
        device=torch.device('cpu')))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.std(want[k]) > 1e-3, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


# the toy sizes of (d): tiny widths, an analytic-sphere init that has a
# surface, two marks across one upsample, the flows sampling from step 2
TOY_SHAPE = {'database_name': 'toy/sphere_32_4', 'sdf_n_comp': 4,
             'sdf_dim': 32, 'app_dim': 16, 'train_ray_num': 64,
             'init_radius': 0.5, 'sdf_multires': 0}
TOY_RUN = {**TOY_SHAPE, 'database_name': 'toy/blobs_32_4',
           'N_voxel_init': 24 ** 3, 'N_voxel_final': 32 ** 3,
           'occ_grid_reso': 32, 'occ_max_samples': 32,
           'compact_samples_per_ray': 16, 'test_ray_num': 256,
           'occ_warmup_steps': 2, 'occ_loss_step': 1,
           'radiance_field_step': 1, 'anneal_end': 4, 'occ_loss_max_pn': 32}
TOY_MAT_SHAPE = {**TOY_SHAPE, 'N_voxel_init': 24 ** 3,
                 'N_voxel_final': 24 ** 3, 'n_samples': 8,
                 'n_importance': 8, 'up_sample_steps': 2}
TOY_MAT = {'database_name': 'toy/sphere_32_4', 'train_ray_num': 32,
           'bake_resolution': 32,
           'shader_cfg': {'diffuse_sample_num': 16, 'specular_sample_num': 8,
                          'nis_diffuse_sample_num': 4,
                          'nis_specular_sample_num': 4, 'mat_n_comp': 4,
                          'grid_size': (16, 16, 16), 'light_reso': 8,
                          'nis_start_iter': 2, 'nis_loss_iter': 1,
                          'nis_update_interval': 2}}
TOY_RUNS = {
    'blobs_convergence': lambda out: convergence_run.run(
        out, total=4, marks=(2, 4), upsample_list=(2,), chamfer_res=32,
        device='cpu', extra=TOY_RUN),
    'toy_material_convergence': lambda out: convergence_mat.run(
        out, steps=12, shape_steps=2, device='cpu',
        shape_extra=TOY_MAT_SHAPE, mat_extra=TOY_MAT),
    'toy_material_ab': lambda out: ab_material.run(
        out, steps=4, shape_steps=2, seeds=(7,), device='cpu',
        shape_extra=TOY_MAT_SHAPE, mat_extra=TOY_MAT),
}


@pytest.mark.parametrize('name', sorted(TOY_RUNS))
def test_scripts_run_end_to_end_at_toy_size(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # validation writes its tiles under data/
    out = str(tmp_path / f'{name}.json')
    returned = TOY_RUNS[name](out)
    with open(out) as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(returned))
    with open(os.path.join(ROOT, 'data', 'convergence', f'{name}.json')) as f:
        ref = json.load(f)
    assert record.missing_keys(ref, got) == []
    assert record.nonfinite(got) == []
    assert got['card'] is None and got['device'] == 'cpu'
    assert got['phase_wall_s'] and got['launches']
    if name == 'blobs_convergence':
        assert [m['step'] for m in got['chamfer']] == [2, 4]
        grids = [m['grid'][0] for m in got['chamfer']]
        assert grids[0] < grids[1], grids        # the upsample was crossed
        assert min(m['n_verts'] for m in got['chamfer']) >= 100
    elif name == 'toy_material_ab':
        assert list(got['seeds']) == ['7']
        assert got['seeds']['7']['arms'].keys() == got['arms'].keys()


def test_ab_material_seeds_only_runs_add_to_their_record(tmp_path,
                                                         monkeypatch):
    """ab_material --no-config-seed, one seed a call as the ten-seed NIS
    record is gathered: the config's own seed does not run, each call adds
    its seed to the record at --out, and each seed's entry says where it
    ran."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / 'seeds.json')
    for seed in (7, 8):
        ab_material.run(out, steps=4, shape_steps=2, seeds=(seed,),
                        device='cpu', shape_extra=TOY_MAT_SHAPE,
                        mat_extra=TOY_MAT, commit='abc', config_seed=False)
    with open(out) as f:
        got = json.load(f)
    assert 'arms' not in got and 'random_seed' not in got
    assert got['mat_steps'] == 4 and list(got['seeds']) == ['7', '8']
    with open(os.path.join(ROOT, 'data', 'convergence',
                           'toy_material_ab.json')) as f:
        ref = json.load(f)
    want = {k: ref[k] for k in ('arms', 'material_map_mean_abs_delta')}
    for seed, run in got['seeds'].items():
        assert record.missing_keys(want, run) == [], seed
        assert record.nonfinite(run) == [], seed
        assert (run['card'], run['device'], run['git_commit']) == \
            (None, 'cpu', 'abc'), seed
        assert run['phase_wall_s'] and run['launches'], seed
    assert got['seeds']['7']['arms'] != got['seeds']['8']['arms']
