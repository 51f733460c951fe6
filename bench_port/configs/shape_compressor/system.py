"""The system under test for ``shape_compressor``: the port's stage-1
trainer (``ShapeTrainer``) at configs/shape/syn/compressor.yaml, driven
through its own ``train`` call.

Set-up builds one trainer from the seed and runs the cut schedule (the
upsamples and the alpha-mask build).  After the harness's warm-up,
``capture`` runs the compared steps through the same ``train`` call the
window makes, on the warmed path the window times, keeping what the
reference needs: the state before them, the batches and draws the
trainer fed, the loss terms, Adam's first moments after the first and
the parameters after the last.  The window goes on from that state.  The
reference follows those steps after the window; the stages it starts
after (the initial parameters, the last upsample, the alpha mask) are
compared on their own.
"""
from __future__ import annotations

import json
import os
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _cpu(t):
    return t.detach().to('cpu', copy=True)


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_cpu(v) for v in tree]
    return _cpu(tree)


def load_config(seed: int, overrides=()):
    """The port's config as run: compressor.yaml with this folder's cuts,
    checked against the resolved file, then the seed."""
    from tensoflow_tpu_torch import config as config_mod
    with open(os.path.join(HERE, 'config.json')) as f:
        spec = json.load(f)
    cfg = config_mod.load_config(os.path.join(HERE, spec['yaml']),
                                 overrides=list(spec['cuts']))
    resolved = dict(spec['resolved'])
    got = {k: v for k, v in cfg.items() if k != 'random_seed'}
    if got != resolved:
        diff = sorted(k for k in set(got) | set(resolved)
                      if got.get(k) != resolved.get(k))
        raise RuntimeError(f'the port resolves the config otherwise: {diff}')
    if overrides:
        config_mod.apply_dotlist(cfg, list(overrides))
    cfg['random_seed'] = int(seed) % 2 ** 32
    return cfg


class System:
    """One trainer, set up and driven as the cell's traffic says."""

    # the benchmark's range around ops.stencil.stencil_head (ranges())
    STENCIL_RANGE = 'bench:stencil_head'

    def __init__(self, traffic: dict, seed: int, device='cuda',
                 overrides=()):
        self.traffic = traffic
        self.device = torch.device(device)
        self.cfg = load_config(seed, overrides)
        self.rays = self.cfg['train_ray_num']
        self.captured = []      # compared steps: inputs and outputs
        self.step_starts = None
        self.aux = []
        self.stage = {}

    # -- the hooks the benchmark puts on the trainer instance -----------
    def _hook(self, trainer):
        inner = trainer.train_step

        def train_step(step, batch, weights, noise, radiance_on, occ_on):
            if self.step_starts is not None:
                self.step_starts.mark()
            rec = self.capturing
            if rec is not None:
                rec.append({'step': step,
                            'batch': {k: _cpu(v) for k, v in batch.items()},
                            'noise': {k: _cpu(v) for k, v in noise.items()}})
            aux = inner(step, batch, weights, noise, radiance_on, occ_on)
            if rec is not None:
                rec[-1]['terms'] = {k: float(v) for k, v in aux.items()}
                if len(rec) == 1:
                    self.m_first = self._moments()[0]
            elif self.keep_aux:
                self.aux.append(aux)
            return aux
        trainer.train_step = train_step

        upsample = trainer.maybe_upsample

        def maybe_upsample(step):
            if step not in (self.cfg.get('upsample_list') or ()):
                return upsample(step)
            before = _tree_cpu(trainer.params['sdf']['field'])
            done = upsample(step)
            if done:
                self.stage['upsample'] = {
                    'before': before,
                    'after': _tree_cpu(trainer.params['sdf']['field']),
                    'grid_size': list(trainer.rcfg.sdf.grid_size)}
            return done
        trainer.maybe_upsample = maybe_upsample

        mask = trainer.maybe_update_alpha_mask

        def maybe_update_alpha_mask(step):
            if step not in (self.cfg.get('update_AlphaMask_lst') or ()):
                return mask(step)
            before = trainer.alpha_mask
            params = _tree_cpu(trainer.params)
            n_levels = trainer.rcfg.sdf.n_levels
            mask(step)
            if trainer.alpha_mask is not before:
                self.stage['alpha_mask'] = {
                    'params': params, 'n_levels': n_levels,
                    'volume': _cpu(trainer.alpha_mask.volume)}
        trainer.maybe_update_alpha_mask = maybe_update_alpha_mask

    def _moments(self):
        st = self.trainer.opt.state()
        return ({k: _cpu(m) for k, (m, _) in st['moments'].items()},
                {k: _cpu(v) for k, (_, v) in st['moments'].items()})

    def _params(self):
        from tensoflow_tpu_torch.train.checkpoints import named_leaves
        return {str(p): _cpu(t) for p, t in named_leaves(self.trainer.params)}

    # -- set-up -----------------------------------------------------------
    def setup(self):
        """Build the trainer from the seed and run the cut schedule to
        the measured state."""
        clock = time.perf_counter()
        from tensoflow_tpu_torch.train.trainer import ShapeTrainer
        self.capturing = None
        self.keep_aux = False
        t = ShapeTrainer(self.cfg, device=self.device)
        self.trainer = t
        self.stage['init'] = {'params': self._params(),
                              'grid_size': list(t.rcfg.sdf.grid_size)}
        self.times = {'imports and trainer': time.perf_counter() - clock}
        clock = time.perf_counter()
        t.init_dataset()
        self.times['scene and rays'] = time.perf_counter() - clock
        clock = time.perf_counter()
        self._hook(t)
        t.train(n_steps=self.traffic['setup_steps'],
                log_every=self.traffic['setup_steps'])
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        self.times['cut schedule (and a first run\'s kernel build)'] = \
            time.perf_counter() - clock
        self.check_state()

    def capture(self):
        """The compared steps, through the window's own ``train`` call,
        with the state before them and what they fed and produced."""
        clock = time.perf_counter()
        t = self.trainer
        m0, v0 = self._moments()
        st = t.opt.state()
        self.before = {
            'params': _tree_cpu(t.params), 'm': m0, 'v': v0,
            'count': st['count'], 'reset_step': st['reset_step'],
            't': {str(p): int(t.opt.opt.state.get(x, {}).get('step', 0))
                  for p, x in zip(t.opt.paths, t.opt.params)},
            'alpha_mask': (None if t.alpha_mask is None
                           else _cpu(t.alpha_mask.volume)),
            'grid_size': list(t.rcfg.sdf.grid_size),
            'n_levels': t.rcfg.sdf.n_levels}
        self.capturing = []
        n = self.traffic['compare_steps']
        t.train(n_steps=n, log_every=n)
        self.after = self._params()
        self.captured, self.capturing = self.capturing, None
        self.times['compared steps'] = time.perf_counter() - clock

    def check_state(self):
        """The measured state is the one the traffic names: its grid, its
        mip levels, its route."""
        t = self.trainer
        want = self.traffic['expect']
        got = {'grid_size': list(t.rcfg.sdf.grid_size),
               'n_levels': t.rcfg.sdf.n_levels,
               'use_occ_grid': t.rcfg.use_occ_grid,
               'alpha_mask': t.alpha_mask is not None,
               'gather_dtype': t.rcfg.sdf.gather_dtype}
        bad = {k: (got[k], v) for k, v in want.items()
               if k in got and got[k] != v}
        if bad:
            raise RuntimeError(f'the trainer is not in the measured state: '
                               f'{bad} (got, wanted)')

    def run_steps(self, n: int, keep_aux=False):
        self.keep_aux = keep_aux
        self.trainer.train(n_steps=n, log_every=n)
        self.keep_aux = False

    # -- the head route ---------------------------------------------------
    def launches(self):
        from tensoflow_tpu_torch.ops import stencil
        return {**stencil.LAUNCHES, **stencil.GENERAL_LAUNCHES}

    def reset_launches(self):
        from tensoflow_tpu_torch.ops import stencil
        stencil.reset_launches()

    def route(self, launches, steps):
        """'fast', 'general' or a description of what ran, from the
        port's launch counters over ``steps`` steps."""
        fast = (launches['stencil_head_fwd'], launches['stencil_head_bwd'])
        gen = (launches['stencil_head_general_fwd'],
               launches['stencil_head_general_bwd'])
        if fast == (steps, steps) and gen == (0, 0):
            return 'fast'
        if gen == (steps, steps) and fast == (0, 0):
            return 'general'
        return f'mixed {launches}'

    # -- the traced stretch -----------------------------------------------
    def ranges(self):
        """Put the benchmark's named range around the stencil head (the
        module attribute fields/tenso_sdf.py calls); returns the undo."""
        from torch.profiler import record_function
        from tensoflow_tpu_torch.ops import stencil
        orig = stencil.stencil_head

        def stencil_head(*a, **k):
            with record_function(self.STENCIL_RANGE):
                return orig(*a, **k)
        stencil.stencil_head = stencil_head

        def undo():
            stencil.stencil_head = orig
        return undo

    def release(self):
        """Free the program's state before the reference runs."""
        self.trainer = None
        self.aux = []

    # -- correctness ------------------------------------------------------
    def reference_inputs(self):
        return {'cfg': self.cfg, 'before': self.before,
                'captured': self.captured, 'after': self.after,
                'm_first': self.m_first, 'stage': self.stage}
