"""Rules of the PyTorch port that no parity test covers.

  * The port and chip_smoke.py import nothing of JAX, optax or the JAX
    package: checked by AST over every module, and by importing every
    port module in a fresh interpreter where ``import jax`` fails.
  * Nor imageio, cv2, PIL or torchvision, which the card's machine lacks
    (one exception: the optional validation-image dump of
    train/metrics_vis.py, skipped without cv2).
  * Every dataset-backed database name dispatches: parse_database_name
    raises NotImplementedError for none of them.
  * No silent CPU: an entry point without an explicit device (both
    trainers, the microbench, the training, mesh, material-,
    geometry-evaluation and relighting CLIs, the evidence scripts) means
    the card and raises
    where CUDA is absent; eval_orb_shape and eval_orb_relight run on the
    host only and take no device.
  * The marching-tetrahedra library is built from the port's own copy of
    its source (csrc/), never from the JAX package's native/.
  * The kernel wrappers take the plain version only for CPU tensors, and
    no ``try`` stands around a build or a launch.
  * A training step, of either stage and on either stage-1 sampler,
    copies nothing from the host but its ray batch.
  * Nothing of stage 1 raises NotImplementedError for the hierarchical
    sampler, the alpha mask or predict_BG.
  * fields/flow.py, fields/mc_shading.py and fields/shading.py raise
    NotImplementedError for no value the JAX package accepts (the flow
    types, shade_fn, use_nis_all, human_light).
  * stencil_impl 'auto' (and 'pallas') takes the stencil kernels' route
    of ops/stencil.py, 'xla' never does, another value raises; a
    stage-1 step with the human light on copies only its batch.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'tensoflow_tpu_torch')
BANNED = ('jax', 'jaxlib', 'optax', 'tensoflow_tpu')


def _port_files():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split('.')[0] in BANNED]
    assert not bad, f'{os.path.relpath(path, ROOT)} imports {bad}'


IMAGING = ('imageio', 'cv2', 'PIL', 'torchvision')
OPTIONAL_DUMP = os.path.join(PKG, 'train', 'metrics_vis.py')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_imaging_package(path):
    bad = [m for m in _imports(path) if m.split('.')[0] in IMAGING]
    if path == OPTIONAL_DUMP:
        assert bad == ['cv2'], bad
        return
    assert not bad, f'{os.path.relpath(path, ROOT)} imports {bad}'


def test_every_dataset_layout_dispatches(tmp_path):
    """No name of a dataset-backed layout raises NotImplementedError; on an
    empty directory each adapter fails reading its files instead."""
    from tensoflow_tpu_torch.data import database as db_mod
    for name in ('tensoSDF/x', 'nerf/x', 'nerf/x/0.8', 'tensoIR/x', 'orb/x',
                 'syn/x', 'real/x/256', 'custom/x/raw_1600', 'custom/x/512'):
        try:
            db_mod.parse_database_name(name, str(tmp_path))
        except NotImplementedError as e:
            raise AssertionError(f'{name}: {e}') from e
        except OSError:
            pass
    with pytest.raises(NotImplementedError):
        db_mod.parse_database_name('unknown/x', str(tmp_path))


def test_port_imports_with_jax_unavailable():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, '.').replace(
            '.__init__', '')
        for p in _port_files() if p.startswith(PKG))
    code = ('import sys\n'
            "for m in ('jax', 'jaxlib', 'optax', 'tensoflow_tpu'):\n"
            '    sys.modules[m] = None\n'
            'import importlib\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            "assert 'jax' not in [k for k, v in sys.modules.items() "
            'if v is not None]\n'
            "print('ok', len(" f'{mods!r}' "))\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith('ok')


def test_trainer_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('a card is present: device=None means the card')
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    cfg = pconfig.load_config(extra={'database_name': 'toy/sphere_16_2'})
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ShapeTrainer(cfg)


SMALL_SHAPE = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
               'app_dim=8', 'N_voxel_init=4096', 'N_voxel_final=4096',
               'occ_grid_reso=8', 'train_ray_num=16', 'occ_max_samples=16',
               'occ_loss_max_pn=16', 'upsample_list=null',
               'compact_samples_per_ray=8', 'init_radius=0.5']
SMALL_MAT = {'isMaterial': True, 'database_name': 'toy/sphere_16_2',
             'nerfDataType': True, 'train_ray_num': 8, 'bake_resolution': 16,
             'shader_cfg': {'diffuse_sample_num': 16,
                            'specular_sample_num': 8,
                            'nis_diffuse_sample_num': 4,
                            'nis_specular_sample_num': 4,
                            'nis_start_iter': 2, 'nis_loss_iter': 1,
                            'nis_update_interval': 5,
                            'grid_size': (16, 16, 16), 'light_reso': 8,
                            'mat_n_comp': 4}}


def _small_geo_checkpoint(tmp_path):
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=SMALL_SHAPE)
    path = str(tmp_path / 'geo.pt')
    ShapeTrainer(cfg, device='cpu').save(path)
    return path


def test_material_trainer_and_microbench_without_device_need_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: device=None means the card')
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.bench import microbench_r3
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    geo = _small_geo_checkpoint(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        MaterialTrainer(pconfig.load_config(extra=SMALL_MAT), geo)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        microbench_r3.main(['--small'])


def test_clis_without_device_need_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present: device=None means the card')
    from tensoflow_tpu_torch import (eval_geo, eval_mat, extract_mesh,
                                     relight_orb, run_training)
    monkeypatch.chdir(tmp_path)
    cfg = os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_training.main(['--cfg', cfg, '--steps', '1', *SMALL_SHAPE])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        extract_mesh.main(['--cfg', cfg, '--resolution', '8', *SMALL_SHAPE])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        eval_mat.main(['--cfg', os.path.join(
            ROOT, 'configs/mat/syn/compressor.yaml'), '--run_nvs'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        eval_geo.main(['--cfg', cfg, *SMALL_SHAPE])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        relight_orb.main(['--cfg', os.path.join(
            ROOT, 'configs/mat/syn/compressor.yaml'), '--hdr', 'env.hdr'])
    from tensoflow_tpu_torch.scripts import (ab_material, convergence_mat,
                                             convergence_run)
    for script in (convergence_run, convergence_mat, ab_material):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            script.main(['--out', str(tmp_path / 'artifact.json')])
    # the Chamfer and relight-metric CLIs are host numpy / scipy: no
    # device to fall back from
    for name in ('eval_orb_shape.py', 'eval_orb_relight.py'):
        src = os.path.join(PKG, name)
        assert not [m for m in _imports(src) if m.split('.')[0] == 'torch']
        assert '--device' not in open(src).read()


def test_marching_tets_builds_the_ports_own_source(tmp_path, monkeypatch):
    """ops/mesh.py compiles csrc/marching_tets.cpp of the port into the
    build directory, and nothing in it names the JAX package's native/."""
    from tensoflow_tpu_torch.ops import mesh
    src = open(os.path.join(PKG, 'ops', 'mesh.py')).read()
    assert 'native' not in src
    assert mesh._SRC == os.path.join(PKG, 'csrc', 'marching_tets.cpp')
    calls = []
    monkeypatch.setattr(mesh, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(mesh.cuda_build.subprocess, 'check_call',
                        lambda cmd: calls.append(cmd) or open(
                            cmd[-1], 'wb').close())
    out = mesh._build_library()
    assert os.path.dirname(out) == str(tmp_path)
    (cmd,) = calls
    assert mesh._SRC in cmd and not any('native' in c for c in cmd)


def test_tile_gather_has_no_try_and_counts_only_at_launches():
    """ops/tile_gather.py: no ``try`` anywhere (a kernel that fails to
    build or launch raises), every public wrapper branches on the
    tensor's device, and the launch count rises in one place only, right
    after the launch's error check."""
    path = os.path.join(PKG, 'ops', 'tile_gather.py')
    src = open(path).read()
    tree = ast.parse(src, path)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    wrappers = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name in ('row_gather_tile', 'row_gather_grid',
                               'row_gather_tile_bf16', 'lane_gather_tile')]
    assert len(wrappers) == 4
    for fn in wrappers:
        assert "table.device.type == 'cpu'" in ast.get_source_segment(src, fn)
    bumps = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)
             and 'LAUNCHES' in ast.unparse(n.target)]
    assert len(bumps) == 2          # the row kernel's and the lane kernel's
    lines = src.splitlines()
    for n in bumps:
        assert 'cuda_build.check(err' in lines[n.lineno - 2]


def test_stencil_head_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper computes the plain version and launches
    nothing; the kernel path refuses anything but CUDA tensors."""
    from tensoflow_tpu_torch.ops import stencil as st
    st.reset_launches()
    n, C, E, H, O = 8, 2, 5, 32, 3
    g = torch.Generator().manual_seed(0)
    pp = [torch.randn(n, 16 * C, generator=g) for _ in range(3)]
    lp = [torch.randn(n, 4 * C, generator=g) for _ in range(3)]
    fr = torch.rand(n, 64, generator=g)
    fr[:, 9] = 1.0
    sig = (((1.0, 1.0, 1.0),) * 3,)
    pe = torch.randn(n, E, generator=g)
    rot = torch.randn(7, 4, E, generator=g)
    w0 = [torch.randn(k, H, generator=g) for k in (C, C, C, E)]
    b0, w1, b1 = (torch.randn(H, generator=g), torch.randn(H, O, generator=g),
                  torch.randn(O, generator=g))
    out = st.stencil_head(pp, lp, fr, sig, pe, rot, w0, b0, w1, b1)
    ref = st.stencil_head_plain(pp, lp, fr, sig, pe, rot, w0, b0, w1, b1)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert st.LAUNCHES == {'stencil_head_fwd': 0, 'stencil_head_bwd': 0}
    with pytest.raises(ValueError, match='on the card'):
        st._check_cuda(pp, 'stencil_head_fwd')
    st._check_shapes(7, 1, C, n, E, H, O, pp, lp, fr, rot, w0, b0)
    with pytest.raises(ValueError, match='inconsistent shapes'):
        st._check_shapes(7, 1, C, n, E, H, O, pp, [l[:, :-1] for l in lp],
                         fr, rot, w0, b0)


def test_training_step_copies_only_the_batch_to_the_device():
    """Every host-to-device copy makes PyTorch wait for the device's
    queue, so a step takes its constants from device_constant and copies
    only the ray batch.  Counted on the CPU as the tensors the port builds
    from host data during a step (after a first step has filled the
    constant cache)."""
    from torch.overrides import TorchFunctionMode
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=['database_name=toy/sphere_16_2', 'sdf_n_comp=2',
                   'sdf_dim=16', 'app_dim=8', 'N_voxel_init=4096',
                   'N_voxel_final=4096', 'occ_grid_reso=8',
                   'train_ray_num=16', 'occ_max_samples=16',
                   'occ_loss_max_pn=16', 'upsample_list=null',
                   'compact_samples_per_ray=8'])
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.train(n_steps=1, log_every=1)
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


def test_no_not_implemented_for_hierarchical_alpha_mask_or_bg():
    """No NotImplementedError left in stage 1's renderer or trainer that
    names the sampler, the alpha mask or the background, and a config
    with all three builds, trains a step across an alpha-mask build and
    keeps its mask."""
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    for rel in ('models/shape_renderer.py', 'train/trainer.py'):
        path = os.path.join(PKG, rel)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and node.exc is not None \
                    and 'NotImplementedError' in ast.unparse(node.exc):
                text = ast.unparse(node.exc).lower()
                assert not any(w in text for w in (
                    'hierarch', 'alpha', 'predict_bg', 'background',
                    'use_occ_grid', 'sampler is')), (rel, text)
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/custom/shoe.yaml'),
        overrides=HIER_SMALL + ['update_AlphaMask_lst=[0]'])
    assert not cfg['use_occ_grid'] and cfg['predict_BG']
    trainer = ShapeTrainer(cfg, device='cpu')
    assert 'bg' in trainer.params and trainer.alpha_mask is None
    logs = trainer.train(n_steps=2, log_every=1)
    assert trainer.alpha_mask is not None
    assert all(r['loss'] == r['loss'] for r in logs)


HIER_SMALL = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
              'app_dim=8', 'N_voxel_init=4096', 'N_voxel_final=4096',
              'train_ray_num=16', 'n_samples=8', 'n_importance=8',
              'occ_loss_max_pn=16', 'upsample_list=null', 'n_bg_samples=8',
              'occ_loss_step=0', 'init_radius=0.5']


def test_hierarchical_step_copies_only_the_batch_to_the_device():
    """The rule of the test above, on the hierarchical sampler with the
    alpha mask, the live-field occ loss, the background and the Gaussian
    loss: a step builds one tensor from host data, its batch (the mask is
    built between steps)."""
    from torch.overrides import TorchFunctionMode
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/custom/shoe.yaml'),
        overrides=HIER_SMALL + ['update_AlphaMask_lst=[0]',
                                'apply_gaussian_loss=true',
                                'gaussianLoss_step=0'])
    trainer = ShapeTrainer(cfg, device='cpu')
    trainer.train(n_steps=2, log_every=1)
    assert trainer.alpha_mask is not None
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


def test_no_not_implemented_for_options_the_jax_package_accepts():
    """Every NotImplementedError left in the flow, the stage-2 shader and
    the stage-1 shading names an outer light the JAX package rejects too;
    each option the JAX package accepts initialises."""
    from tensoflow_tpu_torch.fields import flow, mc_shading, shading
    for rel in ('fields/flow.py', 'fields/mc_shading.py',
                'fields/shading.py'):
        path = os.path.join(PKG, rel)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and node.exc is not None \
                    and 'NotImplementedError' in ast.unparse(node.exc):
                assert 'outer_light_version' in ast.unparse(node.exc), (
                    rel, ast.unparse(node.exc))
    gen = torch.Generator().manual_seed(0)
    small = dict(grid_size=(8, 8, 8), mat_n_comp=2, light_reso=8)
    for over in (dict(flow_type='pwlinear'), dict(flow_type='realnvp'),
                 dict(shade_fn='shade_mixed_all', use_nis_all=True),
                 dict(disable_tensorial=True, disable_reflected=True)):
        cfg = mc_shading.MCShadingConfig(**small, **over)
        params = mc_shading.init_mc_shading(gen, cfg)
        assert ('flow_all' in params) == cfg.use_nis_all
    for ft in ('pwquad', 'pwlinear', 'realnvp'):
        assert flow.FlowConfig(flow_type=ft).param_len > 0
    sp = shading.init_shading(gen, shading.ShadingConfig(
        human_light=True, env=shading.envlight_mod.EnvLightConfig(
            max_res=8)))
    assert 'human_light' in sp


def test_stencil_impl_routes_and_unknown_raises(monkeypatch):
    """'auto' and 'pallas' reach ops/stencil.stencil_head (whose CPU
    tensors take the plain version), 'xla' does not; any other value
    takes the split route too, as in the JAX package, in
    sdf_with_grad_hessian and when a trainer builds its config."""
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.fields import tenso_sdf
    from tensoflow_tpu_torch.ops import stencil
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    calls = []
    real = stencil.stencil_head

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(stencil, 'stencil_head', spy)
    gen = torch.Generator().manual_seed(0)
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3])
    xyz = torch.rand((16, 3), generator=gen) - 0.5
    for impl, n in (('auto', 1), ('pallas', 1), ('xla', 0)):
        cfg = tenso_sdf.SDFConfig(grid_size=(8, 8, 8), n_comp=2, sdf_dim=8,
                                  app_dim=4, stencil_impl=impl)
        params = tenso_sdf.init_tenso_sdf(gen, cfg)
        calls.clear()
        tenso_sdf.sdf_with_grad_hessian(params, cfg, xyz, aabb)
        assert len(calls) == n, impl
    calls.clear()
    tenso_sdf.sdf_with_grad_hessian(
        params, cfg._replace(stencil_impl='cuda'), xyz, aabb)
    assert calls == []
    other = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=SMALL_SHAPE + ['stencil_impl=fused'])
    trainer = ShapeTrainer(other, device='cpu')
    assert tenso_sdf.stencil_route(trainer.rcfg.sdf) == 'split'


@pytest.mark.parametrize('extra', [[], ['stencil_impl=xla']])
def test_option_step_copies_only_the_batch_to_the_device(extra):
    """The rule of test_training_step_copies_only_the_batch_to_the_device
    with the human light on (no override: the light is turned on in the
    renderer config before the parameters are built; each sample's pose
    is gathered from the batch on the device) and on the split stencil
    route."""
    from torch.overrides import TorchFunctionMode
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train import trainer as trainer_mod
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=SMALL_SHAPE + extra)
    trainer = trainer_mod.ShapeTrainer(
        cfg, device='cpu',
        configure=None if extra else trainer_mod.with_human_light)
    assert trainer.rcfg.shading.human_light == (not extra)
    trainer.train(n_steps=1, log_every=1)
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


def _called_from_the_port():
    """Whether the torch function being dispatched was called by a line of
    the port (and not, say, by torch.optim reading its CPU step count)."""
    f = sys._getframe(2)
    while f is not None and os.path.basename(f.f_code.co_filename) in (
            'overrides.py', '_tensor.py'):
        f = f.f_back
    return f is not None and f.f_code.co_filename.startswith(PKG)


def test_stage2_step_copies_only_the_batch_to_the_device(tmp_path):
    """The same rule for the stage-2 step, in its last phase (NIS
    sampling from the frozen flow copies): after three steps have crossed
    the phases and filled the constant cache, a step builds one tensor
    from host data, its batch.  The trace statistics stay on the device:
    they are read at the log cadence only."""
    from torch.overrides import TorchFunctionMode
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
    trainer = MaterialTrainer(pconfig.load_config(extra=SMALL_MAT),
                              _small_geo_checkpoint(tmp_path), device='cpu')
    trainer.train(n_steps=3, log_every=100)
    assert trainer.phase(3).nis_sample_specular
    made, reads = [], []

    class FromHost(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.tensor, torch.as_tensor) \
                    and not isinstance(args[0], torch.Tensor):
                made.append(func.__name__)
            if func in (torch.Tensor.item, torch.Tensor.tolist,
                        torch.Tensor.__float__, torch.Tensor.__bool__,
                        torch.Tensor.cpu, torch.Tensor.numpy) \
                    and _called_from_the_port():
                reads.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with FromHost():
        trainer.train(n_steps=2, log_every=100)
    # log_every logs the first step of a train() call: one read
    assert made == ['as_tensor'] * 2, made
    assert reads == ['tolist'], reads


@pytest.mark.cuda
def test_tile_gather_kernels_match_plain_on_the_card():
    """The four gather kernels against their plain versions (exact), at
    the probes' shapes cut to four row tiles and at the ragged shapes
    (16-byte rows, tables of more than 454 rows, repeated indices)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run: python3 chip_smoke.py)')
    import numpy as np
    from tensoflow_tpu_torch.bench import microbench_r3
    rng = np.random.RandomState(0)
    for case in (microbench_r3.gather_cases(small=True)
                 + microbench_r3.ragged_gather_cases()):
        table, idx = microbench_r3.make_case(case, rng, torch.device('cuda'))
        assert torch.equal(case[1](table, idx), case[2](table, idx)), case[0]


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Kernel fwd + bwd against the plain version on the card (the
    checks chip_smoke.py makes), at a small N."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run: python3 chip_smoke.py)')
    sys.path.insert(0, ROOT)
    import chip_smoke
    for cd in (torch.bfloat16, torch.float32):
        chip_smoke.check_case('S=7 B=1', 4096, 7, 1, cd, seed=1)
        chip_smoke.check_case('S=7 B=2', 4096, 7, 2, cd, seed=2)
        chip_smoke.check_case('S=1 B=1', 4096, 1, 1, cd, seed=3)
        chip_smoke.check_case('S=7 B=1 ragged', 1003, 7, 1, cd, seed=6)
        # fewer row tiles than SMs: the persistent grids run short
        chip_smoke.check_case('S=7 B=1 small', 520, 7, 1, cd, seed=7)
        chip_smoke.check_case('S=1 B=1 small', 520, 1, 1, cd, seed=8)
    # the documented workspace layout is the one the library allocates by
    from tensoflow_tpu_torch.ops import stencil as st
    lib = st._lib('stencil_head_bwd', st._BWD_ARGS)
    n_sm = st._n_sm(torch.device('cuda'))
    for S in (1, 7):
        for n in (520, 1003, 131072):
            assert lib.stencil_head_bwd_workspace(
                1, S, 1, n_sm, n, 36, 21, 256, 129, st.XP) \
                == st.workspace_bytes_bf16(S, n_sm, n)
