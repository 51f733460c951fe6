"""The system under test for ``mat_compressor``: the port's stage-2
trainer (``MaterialTrainer``) at configs/mat/syn/compressor.yaml, in its
NIS-sampling phase, driven through its own ``train`` call.

Set-up trains the stage-1 geometry with the port's ``ShapeTrainer`` at
configs/shape/syn/compressor_occ.yaml's widths on the toy scene for a
fixed number of steps and saves its checkpoint under ``build/``, once a
checkout (later runs load it: ``geometry_path``), and builds
``MaterialTrainer(cfg, checkpoint)`` from it (the bake and the surface-hit
filtering of the training rays), as run_training.py does for
``network: material``.  The trainer's step index is then placed at the
last step before ``nis_start_iter``, and its own ``train`` call runs the
set-up steps up to that step: at it the frozen flow copies are made
(both flows sample from then on, with the NIS loss on since
``nis_loss_iter``) and the budgets are adapted once to this geometry's
trace rates.  After the harness's warm-up, ``capture`` runs the compared
steps through the same ``train`` call the window makes, keeping what the
reference needs, and then places the step index at the next multiple of
the adaptation interval, so that the window's first 499 steps meet
neither a flow-copy refresh nor an adaptation.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
PROGRAM = os.path.join(ROOT, 'tensoflow_tpu_torch')
BAKE_SAMPLE = 4096


def _counts():
    from bench_port.harness.spec import load_module
    return load_module(os.path.join(HERE, 'counts.py'),
                       'bench_counts_mat_compressor')


def _cpu(t):
    return t.detach().to('cpu', copy=True)


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_cpu(v) for v in tree]
    return _cpu(tree)


def spec():
    with open(os.path.join(HERE, 'config.json')) as f:
        return json.load(f)


def split_overrides(overrides):
    """(stage-2 overrides, stage-1 overrides, stage-1 steps or None): an
    override ``geo.<key>=<value>`` goes to the geometry's config, and
    ``geo.steps=<n>`` sets its step count (a shrunk run's)."""
    mat, geo, steps = [], [], None
    for o in overrides:
        if o.startswith('geo.steps='):
            steps = int(o.split('=', 1)[1])
        elif o.startswith('geo.'):
            geo.append(o[4:])
        else:
            mat.append(o)
    return mat, geo, steps


def load_config(seed: int, overrides=()):
    """The port's config as run: compressor.yaml with this folder's cuts,
    checked against the resolved file, then the seed."""
    from tensoflow_tpu_torch import config as config_mod
    sp = spec()
    cfg = config_mod.load_config(os.path.join(HERE, sp['yaml']),
                                 overrides=list(sp['cuts']))
    got = {k: v for k, v in cfg.items() if k != 'random_seed'}
    resolved = dict(sp['resolved'])
    if got != resolved:
        diff = sorted(k for k in set(got) | set(resolved)
                      if got.get(k) != resolved.get(k))
        raise RuntimeError(f'the port resolves the config otherwise: {diff}')
    if overrides:
        config_mod.apply_dotlist(cfg, list(overrides))
    cfg['random_seed'] = int(seed) % 2 ** 32
    return cfg


def geo_config(overrides=()):
    """The stage-1 config the geometry is trained at: compressor_occ.yaml
    with the geometry's cuts (and a shrunk run's overrides), from the
    config's own seed: the geometry stands in for the published stage-1
    checkpoint, one file for every run."""
    from tensoflow_tpu_torch import config as config_mod
    geo = spec()['geometry']
    cfg = config_mod.load_config(os.path.join(HERE, geo['yaml']),
                                 overrides=list(geo['cuts']))
    if overrides:
        config_mod.apply_dotlist(cfg, list(overrides))
    return cfg


def shader_dict(scfg):
    """The shader options the reference reads, as plain values."""
    keys = ('diffuse_sample_num', 'specular_sample_num',
            'nis_diffuse_sample_num', 'nis_specular_sample_num',
            'secondary_budget', 'inner_light_budget', 'a1_budget',
            'estimator_dtype', 'inner_light_exp_max', 'grid_size',
            'mat_n_comp', 'light_reso')
    return {k: getattr(scfg, k) for k in keys}


def geometry_path(prefix, geo_cfg, steps, device):
    """Where the stage-1 geometry's checkpoint is kept: beside ``prefix``
    (the configured path without its ``.pt``), named by a hash of what it
    is trained from: the stage-1 config, the step count, the device kind,
    this file and every file of the program.  The same checkout trains
    it once; a change to any of these trains it anew."""
    h = hashlib.sha256(json.dumps([geo_cfg, steps, device.type],
                                  sort_keys=True, default=str).encode())
    files = [os.path.abspath(__file__)]
    for top, dirs, names in os.walk(PROGRAM):
        dirs[:] = sorted(d for d in dirs if d != '__pycache__')
        files += [os.path.join(top, n) for n in sorted(names)
                  if not n.endswith('.pyc')]
    for f in files:
        h.update(os.path.relpath(f, ROOT).encode())
        with open(f, 'rb') as fh:
            h.update(fh.read())
    base = os.path.splitext(os.path.join(ROOT, prefix))[0]
    return f'{base}-{h.hexdigest()[:16]}.pt'


class System:
    """One material trainer, set up and driven as the cell's traffic
    says."""

    def __init__(self, traffic: dict, seed: int, device='cuda',
                 overrides=()):
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        mat, geo, steps = split_overrides(overrides)
        self.cfg = load_config(seed, mat)
        self.geo_cfg = geo_config(geo)
        self.geo_steps = spec()['geometry']['steps'] if steps is None \
            else steps
        self.rays = self.cfg['train_ray_num']
        self.captured = []
        self.capturing = None
        self.keep_aux = False
        self.step_starts = None
        self.aux = []
        self.stage = {}
        self.adaptations = 0
        self.profiled = None
        self.times = {}

    # -- the hooks the benchmark puts on the trainer instance -----------
    def _hook(self, trainer):
        inner = trainer.train_step

        def train_step(step, batch, weights, noise, phase):
            if self.step_starts is not None:
                self.step_starts.mark()
            rec = self.capturing
            if rec is not None:
                rec.append({'step': step,
                            'batch': {k: _cpu(v) for k, v in batch.items()},
                            'noise': {k: _cpu(v) for k, v in noise.items()},
                            'phase': phase._asdict(),
                            'weights': dict(weights),
                            'shader': shader_dict(trainer.rcfg.shader)})
            aux = inner(step, batch, weights, noise, phase)
            if rec is not None:
                rec[-1]['terms'] = {k: float(v) for k, v in aux.items()}
                if len(rec) == 1:
                    self.m_first = self._moments()[0]
            elif self.keep_aux:
                self.aux.append(aux)
            if self.profiled is not None and 'secondary_cand_rate' in aux:
                self.profiled.append((aux['secondary_cand_rate'],
                                      trainer.rcfg.shader.secondary_budget))
            return aux
        trainer.train_step = train_step

        adapt = trainer._adapt_secondary_budget

        def adapt_budget(*a, **k):
            self.adaptations += 1
            return adapt(*a, **k)
        trainer._adapt_secondary_budget = adapt_budget

    def _moments(self):
        st = self.trainer.opt.state()
        return ({k: _cpu(m) for k, (m, _) in st['moments'].items()},
                {k: _cpu(v) for k, (_, v) in st['moments'].items()})

    def _params(self):
        from tensoflow_tpu_torch.train.checkpoints import named_leaves
        return {str(p): _cpu(t) for p, t in named_leaves(self.trainer.params)}

    # -- set-up -----------------------------------------------------------
    def _geometry(self):
        """The stage-1 geometry's checkpoint: loaded where this checkout
        has trained it, else trained for the fixed step count and written
        (the checkpoints of other keys removed); returns (path, trained)."""
        from tensoflow_tpu_torch.train.trainer import ShapeTrainer
        steps = self.geo_steps
        path = geometry_path(self.cfg['geo_model_path'], self.geo_cfg,
                             steps, self.device)
        if os.path.exists(path):
            return path, False
        shape = ShapeTrainer(self.geo_cfg, device=self.device)
        shape.init_dataset()
        if steps:
            shape.train(n_steps=steps, log_every=steps)
        folder = os.path.dirname(path)
        os.makedirs(folder, exist_ok=True)
        shape.save(path + '.part')
        os.replace(path + '.part', path)
        stem = os.path.basename(
            os.path.splitext(self.cfg['geo_model_path'])[0])
        for name in os.listdir(folder):
            if (name.startswith(stem + '-') and name.endswith('.pt')
                    and os.path.join(folder, name) != path):
                os.remove(os.path.join(folder, name))
        del shape
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        return path, True

    def _bake_hook(self):
        """Keep a seeded sample of the dense bake's voxels while the
        trainer bakes; returns the undo."""
        from tensoflow_tpu_torch.ops import sdf_trace
        orig = sdf_trace.bake_sdf_grid

        def bake(sdf_fun, aabb, resolution=256, **k):
            grid = orig(sdf_fun, aabb, resolution, **k)
            n = resolution ** 3
            idx = np.sort(np.random.default_rng(self.seed % 2 ** 32).choice(
                n, min(BAKE_SAMPLE, n), replace=False))
            vals = grid.values.reshape(-1)[torch.as_tensor(
                idx, device=grid.values.device)]
            self.stage['bake'] = {'idx': idx, 'values': _cpu(vals),
                                  'reso': resolution,
                                  'aabb': np.asarray(aabb, np.float32)}
            return grid
        sdf_trace.bake_sdf_grid = bake

        def undo():
            sdf_trace.bake_sdf_grid = orig
        return undo

    def setup(self):
        """Geometry, trainer, bake and hits, then the trainer's own train
        call up to the measured state."""
        from tensoflow_tpu_torch.models import material_renderer as mr
        from tensoflow_tpu_torch.train.trainer_mat import (
            SEC_BUDGET_INTERVAL, MaterialTrainer)
        clock = time.perf_counter()
        geo_path, trained = self._geometry()
        self.times['stage-1 geometry, ' + (
            'trained (and a first run\'s kernel build)' if trained
            else 'loaded')] = time.perf_counter() - clock
        clock = time.perf_counter()
        undo = self._bake_hook()
        try:
            t = MaterialTrainer(self.cfg, geo_path, device=self.device)
        finally:
            undo()
        self.trainer = t
        self.unit_size = mr.unit_size(t.rcfg)
        self.shader0 = shader_dict(t.rcfg.shader)
        self.stage['init'] = {'params': self._params()}
        self.stage['geo'] = {
            'params': _tree_cpu(t.geo_params),
            'sdf': {'sdf_multires': t.rcfg.sdf.sdf_multires}}
        self.times['trainer and bake'] = time.perf_counter() - clock
        clock = time.perf_counter()
        t.init_dataset()
        self.times['hit filtering'] = time.perf_counter() - clock
        clock = time.perf_counter()
        self._hook(t)
        n = self.traffic['setup_steps']
        scfg = t.rcfg.shader
        # the last set-up step is the one before nis_start_iter: the flow
        # copies are made there, and the budgets adapted after it
        t.start_step = scfg.nis_start_iter - n
        t.train(n_steps=n, log_every=n)
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        self.interval = SEC_BUDGET_INTERVAL
        # the budgets in force from here on, for the operation counts
        # (counts.py reads them from the config)
        scfg = t.rcfg.shader
        self.cfg = {**self.cfg, 'shader_cfg': {
            **(self.cfg.get('shader_cfg') or {}),
            'secondary_budget': scfg.secondary_budget,
            'inner_light_budget': scfg.inner_light_budget}}
        self.n_secondary = _counts().secondary_rays(self.cfg)
        self.times['set-up steps'] = time.perf_counter() - clock
        self.check_state()

    def capture(self):
        """The compared steps, through the window's own ``train`` call,
        with the state before them and what they fed and produced; then
        the step index placed for the window."""
        clock = time.perf_counter()
        t = self.trainer
        m0, v0 = self._moments()
        st = t.opt.state()
        self.before = {
            'params': _tree_cpu(t.params), 'm': m0, 'v': v0,
            'count': st['count'], 'reset_step': st['reset_step'],
            't': {str(p): int(t.opt.opt.state.get(x, {}).get('step', 0))
                  for p, x in zip(t.opt.paths, t.opt.params)},
            'copies': _tree_cpu(t.flow_copies)}
        g = t.grid
        self.grid = {'mid_rows': _cpu(g.mid_rows), 'blocks': _cpu(g.blocks),
                     'coarse_rows': _cpu(g.coarse_rows),
                     'vis_rows': _cpu(g.vis_rows), 'aabb': _cpu(g.aabb),
                     'reso': g.reso, 'vis_pad': g.vis_pad}
        self.capturing = []
        n = self.traffic['compare_steps']
        t.train(n_steps=n, log_every=n)
        self.after = self._params()
        self.captured, self.capturing = self.capturing, None
        # the window from the next multiple of the adaptation interval:
        # its first refresh and adaptation fall at its 500th step
        t.start_step = (t.start_step // self.interval + 1) * self.interval
        self.window_step = t.start_step
        self.times['compared steps'] = time.perf_counter() - clock

    def check_state(self):
        """The measured state is the one the traffic names."""
        t = self.trainer
        ph = t.phase(t.start_step)
        scfg = t.rcfg.shader
        got = {**ph._asdict(), 'adaptations': self.adaptations,
               'estimator_dtype': scfg.estimator_dtype,
               'flow_type': scfg.flow_type,
               'flow_copies': sorted(t.flow_copies)}
        want = self.traffic['expect']
        bad = {k: (got[k], v) for k, v in want.items()
               if k in got and got[k] != v}
        if bad:
            raise RuntimeError(f'the trainer is not in the measured state: '
                               f'{bad} (got, wanted)')

    def run_steps(self, n: int, keep_aux=False):
        self.keep_aux = keep_aux
        self.trainer.train(n_steps=n, log_every=n)
        self.keep_aux = False

    # -- launch counts: the stage-2 step launches no stencil head ---------
    def launches(self):
        from tensoflow_tpu_torch.ops import stencil
        return {**stencil.LAUNCHES, **stencil.GENERAL_LAUNCHES}

    def reset_launches(self):
        from tensoflow_tpu_torch.ops import stencil
        stencil.reset_launches()

    def route(self, launches, steps):
        return 'none' if not any(launches.values()) else f'mixed {launches}'

    # -- the traced stretch -----------------------------------------------
    def ranges(self):
        """Keep the trace rates and budgets of the profiled steps
        (sec_overflow_share); returns the undo."""
        self.profiled = []
        rec = self.profiled

        def undo():
            self.profiled = None
            self.profiled_rates = [(float(c), b) for c, b in rec]
        return undo

    def overflow_share(self):
        """Refinement candidates that found no slot over the profiled
        steps, in percent of the candidates; None without them."""
        from tensoflow_tpu_torch.ops.sdf_trace import budget_slots
        rates = getattr(self, 'profiled_rates', None)
        if not rates:
            return None
        n = self.n_secondary
        cands = [round(c * n) for c, _ in rates]
        over = [max(0, k - budget_slots(n, b))
                for k, (_, b) in zip(cands, rates)]
        return 100.0 * sum(over) / max(sum(cands), 1)

    def release(self):
        """Free the program's state before the reference runs."""
        self.trainer = None
        self.aux = []

    # -- correctness ------------------------------------------------------
    def reference_inputs(self):
        return {'cfg': self.cfg, 'before': self.before, 'grid': self.grid,
                'captured': self.captured, 'after': self.after,
                'm_first': self.m_first, 'stage': self.stage,
                'unit_size': self.unit_size, 'shader': self.shader0}
