"""The training-step core that both stages' trainers run (train/trainer.py's
ShapeTrainer, train/trainer_mat.py's MaterialTrainer); it imports neither:
``ScheduledAdam``, ``all_reduce_step``, ``batch_to_device``, ``StepGraph``
(a step's forward, loss sum and backward as a CUDA graph) and
``StageTrainer``, the trainers' base, which owns construction,
``set_params``, the step's dispatch, the step key's shared part, ``save``,
``validate``, ``train``'s log and the plumbing of data and views.

Entry points run on the card: a trainer built without ``device`` means
CUDA and raises when CUDA is absent; the CPU runs only with
``device='cpu'``.  Random draws come from explicit torch.Generators
(``init_gen`` on the CPU for the initial parameters, ``gen`` on the
device for the per-step draws).  On a mesh (parallel/sharding.py) the
gradients and the logged terms are summed in one all-reduce before Adam,
only rank 0 writes checkpoints (the others wait at a barrier) and every
rank validates its share of the held-out views.
"""
from __future__ import annotations

import gc
import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import database as db_mod
from ..data import rays as rays_mod
from ..parallel import sharding
from ..utils.timing import LAUNCH_COUNTERS, recording
from . import checkpoints, metrics_vis
from .checkpoints import named_leaves

# eager steps at a new step key before the step is captured (PyTorch's
# whole-network capture warms up on a side stream the same way)
GRAPH_WARMUP_STEPS = 2


def lr_factor_fn(cfg):
    """Cosine decay factor (ref: trainer_inv.py:339-343)."""
    ratio = cfg['lr_decay_target_ratio']
    iters = cfg['lr_decay_iters']

    def factor(step):
        return ((math.cos(math.pi * step / iters) + 1.0) * 0.5 * (1 - ratio)
                + ratio)
    return factor


class ScheduledAdam:
    """Adam (betas 0.9/0.99, eps 1e-8) over the xyz/net/env groups that
    ``label_fn`` (a leaf's path -> its group) assigns, with the cosine
    factor of lr_factor_fn normalised by its value at the reset step:
    optimizer step k (from 0) uses base_lr * factor(reset + k) / f0, the
    count semantics of the JAX package's optax chain (trainer.py:136-160)."""

    def __init__(self, cfg, params, reset_step: int, label_fn):
        self.factor = lr_factor_fn(cfg)
        self.reset_step = reset_step
        self.f0 = self.factor(reset_step)
        self.count = 0
        base = {'xyz': cfg['lr_xyz_init'], 'net': cfg['lr_net_init'],
                'env': cfg['lr_env_init']}
        groups = {'xyz': [], 'net': [], 'env': []}
        for path, t in named_leaves(params):
            groups[label_fn(path)].append((path, t))
        self.paths = [p for g in groups.values() for p, _ in g]
        self.params = [t for g in groups.values() for _, t in g]
        groups = {k: [t for _, t in g] for k, g in groups.items()}
        self.opt = torch.optim.Adam(
            [{'params': ts, 'lr': base[k], 'base_lr': base[k]}
             for k, ts in groups.items() if ts],
            betas=(0.9, 0.99), eps=1e-8)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        # every leaf takes a step, as in optax (a leaf without a gradient
        # decays its moments)
        for t in self.params:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        scale = self.factor(self.reset_step + self.count) / self.f0
        for g in self.opt.param_groups:
            g['lr'] = g['base_lr'] * scale
        self.opt.step()
        self.count += 1

    def state(self):
        """Schedule count, reset step and the Adam moments by leaf path
        (zeros before the first step)."""
        moments = {}
        for path, t in zip(self.paths, self.params):
            st = self.opt.state.get(t, {})
            moments[str(path)] = (
                st.get('exp_avg', torch.zeros_like(t)).detach(),
                st.get('exp_avg_sq', torch.zeros_like(t)).detach())
        return {'count': self.count, 'reset_step': self.reset_step,
                'moments': moments}

    def load_state(self, saved, zero_if=None):
        """Take over state()'s payload; leaves whose path satisfies
        ``zero_if`` restart with zero moments."""
        self.count = int(saved['count'])
        for path, t in zip(self.paths, self.params):
            m, v = saved['moments'][str(path)]
            m = m.to(device=t.device, dtype=t.dtype).clone()
            v = v.to(device=t.device, dtype=t.dtype).clone()
            if zero_if is not None and zero_if(path):
                m.zero_()
                v.zero_()
            self.opt.state[t] = {'step': torch.tensor(float(self.count)),
                                 'exp_avg': m, 'exp_avg_sq': v}


def all_reduce_step(mesh, params, terms: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """On a mesh, sum the gradients of ``params`` and this rank's loss
    terms over the ranks in one all-reduce; returns the global terms."""
    if not sharding.active(mesh):
        return terms
    vals = torch.stack([v.detach().float().reshape(()) for v in
                        terms.values()])
    summed = sharding.all_reduce_grads(mesh, params, vals)
    return dict(zip(terms, summed.unbind(0)))


def batch_to_device(batch: Dict[str, np.ndarray], device):
    """The ray batch in one host-to-device copy (each copy waits for the
    device to run what is queued before it)."""
    arrs = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    flat = torch.as_tensor(np.concatenate([a.reshape(-1)
                                           for a in arrs.values()]),
                           device=device)
    parts = torch.split(flat, [a.size for a in arrs.values()])
    return {k: t.view(a.shape) for (k, a), t in zip(arrs.items(), parts)}


def scalar_views(scalars: Dict[str, float], device=None):
    """``scalars`` (name -> value) in one float32 tensor, and a mapping of
    0-d views of it by name."""
    held = torch.tensor(list(scalars.values()), dtype=torch.float32,
                        device=device)
    return held, dict(zip(scalars, held.unbind(0)))


def _on_side_stream(fn):
    """fn() on a side stream ordered after the current stream's work, and
    the current stream ordered after it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class StepGraph:
    """A training step's forward, loss sum and backward at one step key
    (StageTrainer.step_key), captured once as a CUDA graph and replayed.

    The capture reads static copies of the batch, the draws and the
    step's scalars (by name, in one tensor: scalar_views), which each
    replay refreshes, the scalars by one pinned copy; the gradients stay
    the leaves' ``.grad`` (zeros where the backward does not reach, as
    Adam's step gives them); the terms are stacked in one static tensor,
    cloned after each replay, which also credits the registered launch
    counters (utils/timing.launch_counter) with the capture's launches.
    ``refs`` holds the objects whose ids the key holds, so that no other
    object takes one of them while the graph lives."""

    def __init__(self, key, refs):
        self.key, self.refs = key, refs
        self.warm = 0
        self.graph = None

    def capture(self, body, batch, noise, scalars, leaves):
        """Capture ``body(batch, noise, scalar views) -> (keys, stacked
        terms)`` on static copies of the inputs (``scalars``: name ->
        value); the leaves' grads must be None."""
        self.inputs = [v.clone() for v in (*batch.values(),
                                           *noise.values())]
        self.scalars, views = scalar_views(scalars, leaves[0].device)
        nb = len(batch)
        sbatch = dict(zip(batch, self.inputs[:nb]))
        snoise = dict(zip(noise, self.inputs[nb:]))
        before = [dict(c) for c in LAUNCH_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a dead cycle holding
        # another CUDA graph, freed there, would end the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.keys, self.out = body(sbatch, snoise, views)
        finally:
            if gc_on:
                gc.enable()
        # the capture ran no kernel: count its launches on each replay
        self.credit = [(c, {k: c[k] - b[k] for k in c if c[k] != b[k]})
                       for c, b in zip(LAUNCH_COUNTERS, before)]
        for c, b in zip(LAUNCH_COUNTERS, before):
            c.update(b)
        self.grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                      for t in leaves]

    def replay(self, batch, noise, scalars, leaves):
        """Copy the step's inputs in, replay, and return its terms."""
        torch._foreach_copy_(self.inputs, [*batch.values(),
                                           *noise.values()])
        self.scalars.copy_(torch.tensor(list(scalars.values()),
                                        dtype=torch.float32,
                                        pin_memory=self.scalars.is_cuda),
                           non_blocking=True)
        self.graph.replay()
        for c, d in self.credit:
            for k, n in d.items():
                c[k] += n
        for t, g in zip(leaves, self.grads):
            t.grad = g
        return dict(zip(self.keys, self.out.clone().unbind(0)))


class StageTrainer:
    """What both stages' trainers share.  A stage sets ``group_label`` (a
    leaf's path -> its Adam group) and supplies ``_forward_backward(step,
    batch, weights, noise, *flags, **scalars) -> (extra, terms)`` (flags:
    train_step's arguments after the draws; scalars: step_scalars' names
    as device scalars, absent on the eager path), ``step_scalars``,
    ``_stage_key``, ``_checkpoint``, ``init_dataset``, ``render_image``
    and ``_view_psnr``; its ``train_step`` calls ``_step``."""

    group_label = None
    global_draws = ()        # draws every rank keeps whole (shard_noise)

    def __init__(self, cfg, device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        self.cfg = cfg
        self.init_gen = torch.Generator().manual_seed(cfg['random_seed'])
        self.gen = torch.Generator(device=self.device).manual_seed(
            cfg['random_seed'])
        self.start_step = 0
        self.best_para = 0.0
        # steps by path, and captures (_step)
        self.graph_stats = {'replayed': 0, 'eager': 0, 'captures': 0}
        self._graph = None

    def set_params(self, params, reset_step: int = 0):
        """Install a parameter tree (e.g. convert.params_from_jax) and a
        fresh optimizer rebased at ``reset_step``; on a mesh, rank 0's
        tree is broadcast to every rank."""
        sharding.replicate_tree(self.mesh, params)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        self.params = params
        self.opt = ScheduledAdam(self.cfg, params, reset_step,
                                 self.group_label)

    def shard_noise(self, noise):
        """This rank's slice of the step's draws (each has the rays' axis
        first), but ``global_draws``."""
        if not sharding.active(self.mesh):
            return noise
        lo, hi = sharding.shard_range(self.mesh, self.cfg['train_ray_num'])
        return {k: v if k in self.global_draws else v[lo:hi]
                for k, v in noise.items()}

    # ------------------------------------------------------------------
    def _step(self, step, batch, weights, noise, *flags):
        """train_step's forward, backward and Adam step, whose detached
        terms are each step's own tensors (on a mesh global): where
        graph_engages, the replay of one CUDA graph (StepGraph) while the
        step key holds (at a new key GRAPH_WARMUP_STEPS eager steps on a
        side stream, then a capture), then Adam eagerly; else eager."""
        if not self.graph_engages():
            self.graph_stats['eager'] += 1
            return self._eager_step(step, batch, weights, noise, *flags)
        key = self.step_key(step, batch, weights, noise, *flags)
        g = self._graph
        if g is None or g.key != key:
            self._graph = None          # the old graph's memory goes first
            g = self._graph = StepGraph(key, (
                self.opt.params, self._stage_key(step, *flags)[1]))
        if g.graph is None and g.warm < GRAPH_WARMUP_STEPS:
            g.warm += 1
            self.graph_stats['eager'] += 1
            return _on_side_stream(lambda: self._eager_step(
                step, batch, weights, noise, *flags))
        scalars = {**self.step_scalars(step), **weights}
        if g.graph is None:
            self.opt.zero_grad()
            g.capture(lambda b, n, s: self._graph_body(step, b, n, s, *flags),
                      batch, noise, scalars, self.opt.params)
            self.graph_stats['captures'] += 1
        aux = g.replay(batch, noise, scalars, self.opt.params)
        self.graph_stats['replayed'] += 1
        self.opt.step()
        return aux

    def graph_engages(self) -> bool:
        """Whether train_step replays a CUDA graph: on the card, without a
        mesh, while no profiler records (a replay records no host ranges
        for the profile to read)."""
        return (self.device.type == 'cuda' and not sharding.active(self.mesh)
                and not recording())

    def step_key(self, step: int, batch, weights, noise, *flags):
        """Everything that picks the step's Python control flow or the
        identity of a tensor it reads, beside its inputs' values: the
        stage's part (_stage_key), the parameter leaves (an upsample or a
        load replaces them), the weights' keys and the inputs' shapes.
        The step's scalars (step_scalars, the weights' values) are not a
        part of it."""
        shapes = (tuple((k, tuple(v.shape)) for k, v in d.items())
                  for d in (batch, noise))
        return (self._stage_key(step, *flags)[0],
                tuple(map(id, self.opt.params)), tuple(weights), *shapes)

    def _step_terms(self, extra, terms):
        """What the step returns, undetached, in its order."""
        return {**extra, **terms}

    def _eager_step(self, step, batch, weights, noise, *flags):
        self.opt.zero_grad()
        extra, terms = self._forward_backward(step, batch, weights, noise,
                                              *flags)
        terms = all_reduce_step(self.mesh, self.opt.params, terms)
        self.opt.step()
        return {k: v.detach()
                for k, v in self._step_terms(extra, terms).items()}

    def _graph_body(self, step, batch, noise, scalars, *flags):
        """What the CUDA graph holds: _forward_backward with the stage's
        scalars and the weights read from ``scalars`` (0-d views by name);
        returns the terms' keys and their values stacked."""
        own = {k: scalars[k] for k in self.step_scalars(step)}
        weights = {k: v for k, v in scalars.items() if k not in own}
        extra, terms = self._forward_backward(step, batch, weights, noise,
                                              *flags, **own)
        aux = self._step_terms(extra, terms)
        return list(aux), torch.stack([v.detach().float().reshape(())
                                       for v in aux.values()])

    # ------------------------------------------------------------------
    def _steps(self, n_steps: Optional[int]) -> range:
        """train's steps (the dataset opened first): ``n_steps`` (default
        total_step) from start_step, none at or past total_step."""
        if not hasattr(self, 'batcher'):
            self.init_dataset()
        total = n_steps if n_steps is not None else self.cfg['total_step']
        return range(self.start_step,
                     min(self.start_step + total, self.cfg['total_step']))

    def _log(self, step, aux, log_every, logs, callback):
        """At every log_every-th step and the first: the terms on the host
        (one device read), to ``logs`` and ``callback``."""
        if (step + 1) % log_every == 0 or step == self.start_step:
            vals = torch.stack([v.float() for v in aux.values()])
            host = dict(zip(aux, vals.tolist()))   # one device read
            host['step'] = step + 1
            logs.append(host)
            if callback:
                callback(host)

    # ------------------------------------------------------------------
    def _to_device(self, tree):
        return checkpoints.tree_map(lambda t: t.to(self.device), tree)

    def _restore(self, ckpt, params, reset_step: int, zero_if=None):
        """Resume at ``ckpt`` with ``params``: its Adam state rebased at
        ``reset_step`` (restore_opt_state), else, on a shape mismatch, a
        fresh optimizer rebased at the resume step."""
        self.start_step = ckpt['step']
        self.best_para = ckpt.get('best_para', 0.0)
        self.set_params(params, reset_step)
        if not checkpoints.restore_opt_state(ckpt.get('opt_state'), self.opt,
                                             zero_if):
            self.set_params(params, self.start_step)

    def save(self, path: str):
        """Write the checkpoint: step, best_para, params, Adam state, then
        the stage's entries (_checkpoint); on a mesh rank 0 writes."""
        if self.mesh is None or self.mesh.is_main:
            checkpoints.save_checkpoint(path, {
                'step': self.start_step, 'best_para': self.best_para,
                'params': self.params, 'opt_state': self.opt.state(),
                **self._checkpoint()})
        sharding.barrier(self.mesh)

    # ------------------------------------------------------------------
    def _ray_batch(self, info, masks: bool = False):
        """(ray batch, ray count) in the config's camera convention."""
        make = rays_mod.construct_ray_batch_nerf if self.cfg['nerfDataType'] \
            else rays_mod.construct_ray_batch_w2c
        return make(info, masks)[:2]

    def _open_split(self, masks: bool = False):
        """Open the database and its split; the training rays and count."""
        cfg = self.cfg
        self.database = db_mod.parse_database_name(
            cfg['database_name'], cfg['dataset_dir'],
            isWhiteBG=cfg['isBGWhite'])
        train_ids, test_ids = db_mod.get_database_split(
            self.database, split_manul=cfg['split_manul'])
        self.train_ids, self.test_ids = list(train_ids), list(test_ids)
        info = rays_mod.build_imgs_info(self.database, self.train_ids, masks)
        return self._ray_batch(info, masks)

    def _view_rays(self, pose, K, h: int, w: int):
        """One view's ray batch and its ray count."""
        return self._ray_batch({'imgs': np.zeros((1, h, w, 3), np.float32),
                                'Ks': np.asarray(K, np.float32)[None],
                                'poses': np.asarray(pose, np.float32)[None]})

    @staticmethod
    def _chunks(rays: Dict[str, np.ndarray], rn: int, chunk: int):
        """(chunk, its real rays) of the ``rn`` rays, the last chunk padded
        with copies of its last ray."""
        for ri in range(0, rn, chunk):
            sub = {k: v[ri:ri + chunk] for k, v in rays.items()}
            n_real = min(chunk, rn - ri)
            if n_real < chunk:
                sub = {k: np.concatenate(
                    [v, np.repeat(v[-1:], chunk - n_real, 0)], 0)
                    for k, v in sub.items()}
            yield sub, n_real

    def _view(self, vid, ds: float):
        """View ``vid`` scaled by ``ds``: image, pose, K, height, width."""
        gt = self.database.get_image(vid).astype(np.float32) / 255.0
        K = np.asarray(self.database.get_K(vid), np.float32).copy()
        pose = self.database.get_pose(vid)
        h, w = gt.shape[:2]
        if ds != 1.0:
            h, w = int(h * ds), int(w * ds)
            gt = metrics_vis.resize_linear(gt, h, w)
            K = np.diag([ds, ds, 1.0]).astype(np.float32) @ K
        return gt, pose, K, h, w

    def validate(self, max_views: Optional[int] = None,
                 downsample: Optional[float] = None) -> float:
        """Mean PSNR (the stage's _view_psnr) over the held-out split,
        every view by default.  On a mesh rank r renders views r, r +
        size, ... and every rank gets the mean over all of them (one
        all-reduce), so no rank waits out another's renders in a
        collective."""
        vids = self.test_ids if max_views is None else \
            self.test_ids[:max_views]
        return sharding.global_mean(self.mesh, [
            self._view_psnr(vid, downsample)
            for vid in sharding.rank_share(self.mesh, vids)])
