"""Stage-1 (shape) trainer of the port (counterpart of
tensoflow_tpu/train/trainer.py).

One PyTorch step per training iteration (on the card, on the
hierarchical sampler, its forward and backward replayed as one CUDA
graph: ``ShapeTrainer.train_step``): build the envlight mips,
render the ray batch through the sampler (the occupancy grid, or the NeuS
hierarchical sampler with its alpha mask and, with predict_BG, the NeRF++
background), the TensoSDF stencil head and the split-sum shading, sum the
loss terms, backpropagate and take one Adam step over three parameter
groups (``xyz`` = tensor grids, ``env`` = envlight cubemap, ``net`` =
everything else, the background net included) with the JAX package's
cosine learning-rate factor.  On the occupancy grid the grid is refreshed
every ``occ_update_interval`` steps; on the hierarchical sampler the
alpha mask is rebuilt at the steps of ``update_AlphaMask_lst``.

Entry points run on the card: ``ShapeTrainer(cfg)`` means CUDA and raises
when CUDA is absent; the CPU runs only when the caller passes
``device='cpu'``.  Random draws come from explicit torch.Generators
(``init_gen`` on the CPU for the initial parameters, ``gen`` on the
device for the per-step noise); ``step_noise`` / ``occ_jitter`` are the
only places the loop draws, so a caller can substitute its own draws.

Grid upsampling (``upsample_list``) starts a new grid phase: the field is
resized, one more mip level joins, and Adam restarts with fresh moments
and its cosine factor rebased at that step.  ``render_image`` renders a
full view in chunks without gradients; ``validate`` scores the held-out
views.  As in the JAX package, render_image does not pass the alpha mask.

``mesh=`` (parallel/sharding.py) trains one rank of a ray-sharded data
mesh: params, Adam state and occupancy state are replicated from rank 0;
every rank draws the global batch and the global noise from the same seed
and takes its slice; the renderer's batch-wide statistics are global; the
gradients and the logged terms are summed in one all-reduce before Adam,
so the params stay identical on every rank.  Only rank 0 writes
checkpoints (the others wait at a barrier); every rank validates its
share of the held-out views.
"""
from __future__ import annotations

import gc
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import config as config_mod
from .. import resolve_device
from ..data import database as db_mod
from ..data import rays as rays_mod
from ..fields import light as light_mod
from ..fields import shading as shading_mod
from ..fields import tenso_sdf
from ..models import shape_renderer as sr
from ..ops import grid as grid_mod
from ..ops import stencil
from ..parallel import sharding
from . import checkpoints, losses, metrics_vis
from .checkpoints import named_leaves
from ..utils.timing import recording, span

# the images render_image returns
EVAL_KEYS = ('ray_rgb', 'normal', 'normal_vis', 'acc', 'depth', 'albedo',
             'roughness', 'metallic', 'occ_prob', 'occ_prob_gt',
             'diffuse_color', 'specular_color', 'diffuse_light',
             'specular_light', 'indirect_light')

# adaptive sample-budget buckets and margin (trainer.py:46-47 of the JAX
# package)
BUDGET_BUCKETS = (16, 24, 32, 48, 64, 96, 128)
BUDGET_MARGIN = 1.5

# eager steps at a new step key before the step is captured (PyTorch's
# whole-network capture warms up on a side stream the same way)
GRAPH_WARMUP_STEPS = 2


def build_shape_config(cfg: Dict[str, Any], grid_size, n_levels: int
                       ) -> sr.ShapeRendererConfig:
    sdf_cfg = tenso_sdf.SDFConfig(
        grid_size=tuple(int(g) for g in grid_size),
        n_comp=cfg['sdf_n_comp'], sdf_dim=cfg['sdf_dim'],
        app_dim=cfg['app_dim'], n_levels=n_levels,
        sdf_multires=cfg['sdf_multires'],
        init_radius=float(cfg.get('init_radius', 0.2)),
        gather_dtype=cfg.get('gather_dtype', 'float32'),
        stencil_impl=cfg.get('stencil_impl', 'auto'))
    # shader_config (the photographer light of the reference's custom
    # captures) stays unread, as in the JAX package's build_shape_config:
    # a caller turns the light on in code (ShapeTrainer(configure=
    # with_human_light)) before params are built
    shading_cfg = shading_mod.ShadingConfig(
        app_feats_dim=cfg['app_dim'],
        has_radiance_field=cfg['has_radiance_field'],
        radiance_field_step=cfg['radiance_field_step'],
        env=light_mod.EnvLightConfig(max_res=128))
    return sr.ShapeRendererConfig(
        sdf=sdf_cfg, shading=shading_cfg,
        aabb=tuple(tuple(x) for x in cfg['aabb']),
        std_act=cfg['std_act'], inv_s_init=cfg['inv_s_init'],
        freeze_inv_s_step=cfg['freeze_inv_s_step'],
        n_samples=cfg['n_samples'], n_importance=cfg['n_importance'],
        up_sample_steps=cfg['up_sample_steps'], perturb=cfg['perturb'],
        anneal_end=cfg['anneal_end'], train_ray_num=cfg['train_ray_num'],
        clip_sample_variance=cfg['clip_sample_variance'],
        use_occ_grid=cfg['use_occ_grid'], occ_grid_reso=cfg['occ_grid_reso'],
        step_ratio=cfg['step_ratio'], occ_max_samples=cfg['occ_max_samples'],
        compact_samples_per_ray=cfg.get('compact_samples_per_ray', 64),
        rgb_loss=cfg['rgb_loss'], apply_occ_loss=cfg['apply_occ_loss'],
        apply_tv_loss=cfg['apply_tv_loss'],
        apply_sparse_loss=cfg['apply_sparse_loss'],
        apply_hessian_loss=cfg['apply_hessian_loss'],
        apply_gaussian_loss=cfg['apply_gaussian_loss'],
        gaussian_loss_step=cfg['gaussianLoss_step'],
        occ_loss_step=cfg['occ_loss_step'],
        occ_loss_max_pn=cfg['occ_loss_max_pn'],
        occ_sdf_thresh=cfg['occ_sdf_thresh'],
        apply_mask_loss=cfg['apply_mask_loss'],
        has_radiance_field=cfg['has_radiance_field'],
        radiance_field_step=cfg['radiance_field_step'],
        isBGWhite=cfg['isBGWhite'], predict_BG=cfg['predict_BG'],
        n_bg_samples=cfg.get('n_bg_samples', 32))


def lr_factor_fn(cfg):
    """Cosine decay factor (ref: trainer_inv.py:339-343)."""
    ratio = cfg['lr_decay_target_ratio']
    iters = cfg['lr_decay_iters']

    def factor(step):
        return ((math.cos(math.pi * step / iters) + 1.0) * 0.5 * (1 - ratio)
                + ratio)
    return factor


def param_group_label(path) -> str:
    """xyz = tensor grids; env = envlight cubemap; net = everything else
    (ref: trainer_inv.py:111-126)."""
    if 'field' in path:
        return 'xyz'
    if 'envlight' in path:
        return 'env'
    return 'net'


class ScheduledAdam:
    """Adam (betas 0.9/0.99, eps 1e-8) over the xyz/net/env groups with
    the cosine factor of lr_factor_fn normalised by its value at the reset
    step: optimizer step k (from 0) uses base_lr * factor(reset + k) / f0,
    the count semantics of the JAX package's optax chain
    (trainer.py:136-160)."""

    def __init__(self, cfg, params, reset_step: int, label_fn=None):
        label_fn = label_fn or param_group_label
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


def _batch_to_device(batch: Dict[str, np.ndarray], device):
    """The ray batch in one host-to-device copy (each copy waits for the
    device to run what is queued before it)."""
    arrs = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    flat = torch.as_tensor(np.concatenate([a.reshape(-1)
                                           for a in arrs.values()]),
                           device=device)
    parts = torch.split(flat, [a.size for a in arrs.values()])
    return {k: t.view(a.shape) for (k, a), t in zip(arrs.items(), parts)}


def with_human_light(rcfg: sr.ShapeRendererConfig
                     ) -> sr.ShapeRendererConfig:
    """``rcfg`` with stage 1's human light on (no config key reads it)."""
    return rcfg._replace(shading=rcfg.shading._replace(human_light=True))


def step_scalars(rcfg: sr.ShapeRendererConfig, step: int,
                 weights: Dict[str, float]):
    """The step's scalars that change from step to step, in the order the
    captured step reads them (scalar_views): the cosine anneal ratio,
    then the schedule weights."""
    return [sr.cos_anneal_ratio(rcfg, step), *weights.values()]


def scalar_views(scalars: torch.Tensor, weight_keys):
    """(anneal ratio, weights) as 0-d views of step_scalars' values held in
    one tensor."""
    return scalars[0], dict(zip(weight_keys, scalars[1:].unbind(0)))


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
    """The stage-1 step's forward, loss sum and backward at one step key
    (ShapeTrainer.step_key), captured once as a CUDA graph and replayed.

    The capture reads static copies of the batch, the draws and the
    step's scalars (step_scalars), which each replay refreshes; the
    gradients it writes stay the leaves' ``.grad`` (a leaf the backward
    does not reach gets zeros, as Adam's step gives it); the returned terms
    are stacked in one static tensor, cloned after each replay.  The
    port's stencil-head launch counters are credited with the captured
    step's launches on each replay, since the kernels run once a replay.
    ``refs`` holds the objects whose ids the key holds, so that no other
    object takes one of those ids while the graph lives."""

    def __init__(self, key, refs):
        self.key, self.refs = key, refs
        self.warm = 0
        self.graph = None

    def capture(self, body, batch, noise, scalars, leaves):
        """Capture ``body(batch, noise, scalars) -> (keys, stacked terms)``
        on static copies of the inputs; the leaves' grads must be None."""
        self.inputs = [v.clone() for v in (*batch.values(),
                                           *noise.values())]
        self.scalars = scalars.clone()
        nb = len(batch)
        sbatch = dict(zip(batch, self.inputs[:nb]))
        snoise = dict(zip(noise, self.inputs[nb:]))
        self.counters = (stencil.LAUNCHES, stencil.GENERAL_LAUNCHES)
        before = [dict(c) for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a dead cycle holding
        # another CUDA graph, freed there, would end the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.keys, self.out = body(sbatch, snoise, self.scalars)
        finally:
            if gc_on:
                gc.enable()
        # the capture ran no kernel: count its launches on each replay
        self.credit = [{k: c[k] - b[k] for k in c}
                       for c, b in zip(self.counters, before)]
        for c, b in zip(self.counters, before):
            c.update(b)
        self.grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                      for t in leaves]

    def replay(self, batch, noise, scalars, leaves):
        """Copy the step's inputs in, replay, and return its terms."""
        torch._foreach_copy_(self.inputs, [*batch.values(),
                                           *noise.values()])
        self.scalars.copy_(torch.tensor(scalars, dtype=torch.float32,
                                        pin_memory=True), non_blocking=True)
        self.graph.replay()
        for c, d in zip(self.counters, self.credit):
            for k, n in d.items():
                c[k] += n
        for t, g in zip(leaves, self.grads):
            t.grad = g
        return dict(zip(self.keys, self.out.clone().unbind(0)))


class ShapeTrainer:
    """End-to-end stage-1 training (geometry reconstruction)."""

    def __init__(self, cfg: Dict[str, Any], device=None, mesh=None,
                 configure=None):
        """``configure`` (rcfg -> rcfg, e.g. with_human_light) edits the
        renderer config before the parameters are built."""
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        self.cfg = cfg
        self.init_gen = torch.Generator().manual_seed(cfg['random_seed'])
        self.gen = torch.Generator(device=self.device).manual_seed(
            cfg['random_seed'])
        self.n_voxel_list = config_mod.voxel_schedule(cfg)
        n0 = self.n_voxel_list.pop(0)
        grid_size = config_mod.n_to_reso(n0, cfg['aabb'])
        self.rcfg = build_shape_config(cfg, grid_size, cfg['max_levels'])
        if configure is not None:
            self.rcfg = configure(self.rcfg)
        params = sr.init_shape_renderer(self.init_gen, self.rcfg, self.device)
        self.occ_cfg = grid_mod.OccGridConfig(resolution=cfg['occ_grid_reso'])
        self.occ_state = grid_mod.init_occ_grid(self.occ_cfg, self.device)
        self.alpha_mask = None
        self.start_step = 0
        self.best_para = 0.0
        self.occ_update_interval = 100
        self._budget_ema = None
        # steps by path, and captures (train_step)
        self.graph_stats = {'replayed': 0, 'eager': 0, 'captures': 0}
        self._graph = None
        self.set_params(params)

    def set_params(self, params, reset_step: int = 0):
        """Install a parameter tree (e.g. convert.params_from_jax) and a
        fresh optimizer rebased at ``reset_step``; on a mesh, rank 0's
        tree is broadcast to every rank."""
        sharding.replicate_tree(self.mesh, params)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        self.params = params
        self.opt = ScheduledAdam(self.cfg, params, reset_step)

    # ------------------------------------------------------------------
    def init_dataset(self):
        cfg = self.cfg
        self.database = db_mod.parse_database_name(
            cfg['database_name'], cfg['dataset_dir'],
            isWhiteBG=cfg['isBGWhite'])
        train_ids, test_ids = db_mod.get_database_split(
            self.database, split_manul=cfg['split_manul'])
        self.train_ids, self.test_ids = list(train_ids), list(test_ids)
        info = rays_mod.build_imgs_info(self.database, self.train_ids,
                                        cfg['apply_mask_loss'])
        if cfg['nerfDataType']:
            batch, _, _, _ = rays_mod.construct_ray_batch_nerf(
                info, cfg['apply_mask_loss'])
        else:
            batch, _, _, _ = rays_mod.construct_ray_batch_w2c(
                info, cfg['apply_mask_loss'])
        batch = rays_mod.filter_rays_aabb(batch, cfg['aabb'])
        self.batcher = rays_mod.RayBatcher(batch, cfg['train_ray_num'],
                                           cfg['random_seed'])

    # ------------------------------------------------------------------
    # random draws
    # ------------------------------------------------------------------
    def step_noise(self, step: int) -> Dict[str, torch.Tensor]:
        """The training step's draws (sampler jitter, occ-loss scores, the
        background's jitter)."""
        return sr.draw_noise(self.gen, self.rcfg, self.cfg['train_ray_num'],
                             self.device)

    def shard_noise(self, noise):
        """This rank's slice of the per-ray draws; ``occ_score`` stays the
        global draw (the renderer takes the scores of its global slots)."""
        if not sharding.active(self.mesh):
            return noise
        out = dict(noise)
        lo, hi = sharding.shard_range(self.mesh, self.cfg['train_ray_num'])
        for k in ('sample_jitter', 'bg_jitter'):
            if k in out:
                out[k] = out[k][lo:hi]
        return out

    def occ_jitter(self, step: int) -> torch.Tensor:
        """Uniform [R^3, 3] draws jittering the occ-update cell centers."""
        r = self.occ_cfg.resolution
        return torch.rand((r ** 3, 3), generator=self.gen,
                          device=self.device)

    # ------------------------------------------------------------------
    # one occupancy update / one training step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def occ_update(self, step: int, prune: bool):
        occ_cfg = self.occ_cfg
        centers = grid_mod.occ_grid_cell_centers(occ_cfg, self.device)
        cell = (occ_cfg.aabb_max - occ_cfg.aabb_min) / occ_cfg.resolution
        pts = centers + (self.occ_jitter(step) - 0.5) * cell
        alphas = sr.compute_occ_alpha_chunked(self.params, self.rcfg, pts)
        # bake the SDF at the unjittered lattice in the same pass: the
        # occ-loss march reads it instead of the live field
        sdf = sr.compute_sdf_chunked(self.params, self.rcfg, centers)
        self.occ_state = grid_mod.update_occ_grid(
            self.occ_state, occ_cfg, alphas, sdf=sdf, prune=prune)

    def train_step(self, step: int, batch: Dict[str, torch.Tensor],
                   weights: Dict[str, float], noise, radiance_on: bool,
                   occ_on: bool) -> Dict[str, torch.Tensor]:
        """Forward, backward and one Adam step; returns the detached loss
        terms (``loss`` = their sum), psnr, std and sample_num, each step
        its own tensors.  On a mesh the batch and noise are this rank's
        (shard_noise) and everything returned is global.

        Where graph_engages, the forward, loss sum and backward run as the
        replay of one CUDA graph (StepGraph) while the step key
        (step_key) holds: at a new key, GRAPH_WARMUP_STEPS eager steps on
        a side stream, then a capture.  Adam stays eager.  Elsewhere (on
        the CPU, on a mesh, on the occupancy-grid route, under a profiler)
        the step runs eagerly.  The occupancy-grid route stays eager
        because its grid refresh replaces ``occ_state`` and its budget and
        stride can change every occ_update_interval steps; no benchmark
        cell times it yet."""
        if not self.graph_engages():
            self.graph_stats['eager'] += 1
            return self._eager_step(step, batch, weights, noise,
                                    radiance_on, occ_on)
        key = self.step_key(step, batch, weights, noise, radiance_on, occ_on)
        g = self._graph
        if g is None or g.key != key:
            self._graph = None          # the old graph's memory goes first
            g = self._graph = StepGraph(key, (self.opt.params,
                                              self.alpha_mask))
        if g.graph is None and g.warm < GRAPH_WARMUP_STEPS:
            g.warm += 1
            self.graph_stats['eager'] += 1
            return _on_side_stream(lambda: self._eager_step(
                step, batch, weights, noise, radiance_on, occ_on))
        scalars = step_scalars(self.rcfg, step, weights)
        if g.graph is None:
            self.opt.zero_grad()

            def body(b, n, s):
                return self._graph_body(step, b, n, s, tuple(weights),
                                        radiance_on, occ_on)
            g.capture(body, batch, noise,
                      torch.tensor(scalars, dtype=torch.float32,
                                   device=self.device), self.opt.params)
            self.graph_stats['captures'] += 1
        aux = g.replay(batch, noise, scalars, self.opt.params)
        self.graph_stats['replayed'] += 1
        self.opt.step()
        return aux

    def graph_engages(self) -> bool:
        """Whether train_step replays a CUDA graph: on the card, without a
        mesh, on the hierarchical sampler, while no profiler records (a
        replay records no host ranges for the profile to read)."""
        return (self.device.type == 'cuda' and not sharding.active(self.mesh)
                and not self.rcfg.use_occ_grid and not recording())

    def step_key(self, step: int, batch, weights, noise, radiance_on: bool,
                 occ_on: bool):
        """Everything that picks the step's Python control flow or the
        identity of a tensor it reads, beside its inputs' values: the
        renderer config (grid, levels, widths, route), the parameter
        leaves (an upsample replaces them), the alpha mask's volume, the
        phase gates, the weights' keys and the inputs' shapes."""
        rc = self.rcfg
        return (rc, tuple(map(id, self.opt.params)),
                None if self.alpha_mask is None
                else id(self.alpha_mask.volume),
                radiance_on, occ_on,
                rc.freeze_inv_s_step is not None
                and step < rc.freeze_inv_s_step,
                step > rc.gaussian_loss_step, step > rc.radiance_field_step,
                tuple(weights),
                tuple((k, tuple(v.shape)) for k, v in batch.items()),
                tuple((k, tuple(v.shape)) for k, v in noise.items()))

    def _forward_backward(self, step, batch, weights, noise, radiance_on,
                          occ_on, anneal=None):
        """The step's forward, loss sum and backward; returns (psnr, std
        and sample_num; the loss terms with their sum, ``loss``), both
        undetached and this rank's."""
        p = self.params
        with span('tf.forward'):
            mips = light_mod.build_mips(p['shading']['envlight'],
                                        self.rcfg.shading.env)
            outputs = sr.train_step_outputs(
                p, self.rcfg, mips, self.occ_state, batch, step, noise,
                radiance_on, occ_on, alpha_mask=self.alpha_mask,
                mesh=self.mesh, anneal=anneal)
            total, terms = losses.total_loss_shape(outputs, weights,
                                                   self.mesh)
        with span('tf.backward'):
            total.backward()
        return ({k: outputs[k] for k in ('psnr', 'std', 'sample_num')},
                {**terms, 'loss': total})

    def _eager_step(self, step, batch, weights, noise, radiance_on, occ_on):
        self.opt.zero_grad()
        extra, terms = self._forward_backward(step, batch, weights, noise,
                                              radiance_on, occ_on)
        terms = all_reduce_step(self.mesh, self.opt.params, terms)
        self.opt.step()
        return {k: v.detach() for k, v in {**extra, **terms}.items()}

    def _graph_body(self, step, batch, noise, scalars, weight_keys,
                    radiance_on, occ_on):
        """What the CUDA graph holds: _forward_backward with the anneal
        ratio and the weights read from ``scalars`` (step_scalars' values
        in one tensor); returns the terms' keys and their values stacked."""
        anneal, weights = scalar_views(scalars, weight_keys)
        extra, terms = self._forward_backward(step, batch, weights, noise,
                                              radiance_on, occ_on, anneal)
        aux = {**extra, **terms}
        return list(aux), torch.stack([v.detach().float().reshape(())
                                       for v in aux.values()])

    # ------------------------------------------------------------------
    def occ_warmup_steps(self) -> int:
        return int(self.cfg.get('occ_warmup_steps', 10000))

    def maybe_set_march_stride(self, step: int):
        """During the occ no-prune warmup the binary grid is fully
        occupied, so the per-ray budget strides the candidate lattice to
        cover the whole ray; afterwards the stride returns to 1."""
        if not self.rcfg.use_occ_grid:
            return
        if step < self.occ_warmup_steps():
            want = max(-(-sr.n_march_candidates(self.rcfg)
                         // self.rcfg.occ_max_samples), 1)
        else:
            want = 1
        if want != self.rcfg.march_stride:
            self.rcfg = self.rcfg._replace(march_stride=want)

    def phase_flags(self, step: int):
        radiance_on = (self.cfg['has_radiance_field']
                       and step > self.cfg['radiance_field_step'])
        occ_on = step >= self.cfg['occ_loss_step']
        return radiance_on, occ_on

    def maybe_adapt_budget(self, step: int, aux):
        """Right-size the compaction budget to the live occupancy every
        occ-update interval (EMA of mean valid samples per ray x margin,
        rounded up to a bucket)."""
        if not (self.rcfg.use_occ_grid
                and self.cfg.get('adaptive_sample_budget', True)):
            return
        if step % self.occ_update_interval != 0 or 'sample_num' not in aux:
            return
        mean = float(aux['sample_num'])
        self._budget_ema = (mean if self._budget_ema is None
                            else 0.5 * self._budget_ema + 0.5 * mean)
        cap = int(self.cfg.get('compact_samples_per_ray', 64))
        need = self._budget_ema * BUDGET_MARGIN
        bucket = next((b for b in BUDGET_BUCKETS if b >= need and b <= cap),
                      cap)
        if bucket != self.rcfg.compact_samples_per_ray:
            self.rcfg = self.rcfg._replace(compact_samples_per_ray=bucket)

    def maybe_update_alpha_mask(self, step: int):
        """Alpha-mask refresh schedule (ref: trainer_inv.py:272-279), on
        the hierarchical sampler only: a 128^3 mask of the field after this
        step's update."""
        lst = self.cfg.get('update_AlphaMask_lst')
        if self.rcfg.use_occ_grid or not lst or step not in lst:
            return
        self.alpha_mask = sr.build_alpha_mask(
            self.params, self.rcfg,
            mul_length=self.cfg.get('mul_length', 10),
            alpha_thresh=self.cfg.get('alphaMask_thres', 1e-4))

    def maybe_upsample(self, step: int) -> bool:
        """Grid upsample + optimizer reset (ref: trainer_inv.py:283-291):
        the next grid of the voxel schedule, one more mip level, the MLP
        carried over, fresh Adam moments with the cosine factor rebased at
        this step.  The occupancy state and the budget EMA carry over."""
        ul = self.cfg.get('upsample_list')
        if not ul or step not in ul or not self.n_voxel_list:
            return False
        n_vox = self.n_voxel_list.pop(0)
        reso = config_mod.n_to_reso(n_vox, self.cfg['aabb'])
        new_sdf, new_sdf_cfg = tenso_sdf.upsample_tenso_sdf(
            self.params['sdf'], self.rcfg.sdf, reso)
        self.rcfg = self.rcfg._replace(sdf=new_sdf_cfg)
        self.set_params({**self.params, 'sdf': new_sdf}, reset_step=step)
        return True

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save(self, path: str):
        """Write the checkpoint (on a mesh: rank 0 writes, every rank
        waits for it)."""
        if self.mesh is None or self.mesh.is_main:
            self._write(path)
        sharding.barrier(self.mesh)

    def _write(self, path: str):
        checkpoints.save_checkpoint(path, {
            'step': self.start_step,
            'best_para': self.best_para,
            'params': self.params,
            'opt_state': self.opt.state(),
            'occ_state': self.occ_state,
            'alpha_mask': checkpoints.pack_alpha_mask(self.alpha_mask),
            'N_voxel_list': self.n_voxel_list,
            'march_stride': self.rcfg.march_stride,
            'compact_samples_per_ray': self.rcfg.compact_samples_per_ray,
            'kwargs': {
                'grid_size': list(self.rcfg.sdf.grid_size),
                'n_levels': self.rcfg.sdf.n_levels,
                'sdf_n_comp': self.rcfg.sdf.n_comp,
                'sdf_dim': self.rcfg.sdf.sdf_dim,
                'app_dim': self.rcfg.sdf.app_dim,
                'sdf_multires': self.rcfg.sdf.sdf_multires,
                'aabb': [list(a) for a in self.rcfg.aabb],
            },
        })

    def load(self, path: str):
        ckpt = checkpoints.load_checkpoint(path)
        kw = ckpt['kwargs']
        self.rcfg = build_shape_config(
            self.cfg, kw['grid_size'], kw['n_levels'])._replace(
                march_stride=ckpt['march_stride'],
                compact_samples_per_ray=ckpt['compact_samples_per_ray'])
        to_dev = lambda t: t.to(self.device)   # noqa: E731
        self.occ_state = checkpoints.tree_map(to_dev, ckpt['occ_state'])
        self.alpha_mask = checkpoints.unpack_alpha_mask(
            ckpt.get('alpha_mask'), self.device)
        self.n_voxel_list = list(ckpt['N_voxel_list'])
        self.start_step = ckpt['step']
        self.best_para = ckpt.get('best_para', 0.0)
        # restore the Adam moments + schedule count against the ORIGINAL
        # reset step (ref: trainer_inv.py:108-113); a shape mismatch falls
        # back to a fresh optimizer rebased at the resume step
        saved = ckpt.get('opt_state')
        reset = saved['reset_step'] if saved else self.start_step
        self.set_params(checkpoints.tree_map(to_dev, ckpt['params']), reset)
        if not checkpoints.restore_opt_state(saved, self.opt):
            self.set_params(self.params, self.start_step)

    # ------------------------------------------------------------------
    def train(self, n_steps: Optional[int] = None, log_every: int = 100,
              callback=None):
        if not hasattr(self, 'batcher'):
            self.init_dataset()
        total = n_steps if n_steps is not None else self.cfg['total_step']
        end_step = min(self.start_step + total, self.cfg['total_step'])
        logs = []
        for step in range(self.start_step, end_step):
            with span('tf.step'):
                self.maybe_set_march_stride(step)
                if (self.rcfg.use_occ_grid
                        and step % self.occ_update_interval == 0):
                    self.occ_update(step,
                                    prune=step >= self.occ_warmup_steps())
                batch = _batch_to_device(sharding.shard_batch(
                    self.mesh, self.batcher.next_batch()), self.device)
                weights = losses.schedule_weights(self.cfg, step)
                radiance_on, occ_on = self.phase_flags(step)
                aux = self.train_step(
                    step, batch, weights,
                    self.shard_noise(self.step_noise(step)), radiance_on,
                    occ_on)
                if (step + 1) % log_every == 0 or step == self.start_step:
                    vals = torch.stack([v.float() for v in aux.values()])
                    host = dict(zip(aux, vals.tolist()))  # one device read
                    host['step'] = step + 1
                    logs.append(host)
                    if callback:
                        callback(host)
                self.maybe_adapt_budget(step, aux)
                self.maybe_update_alpha_mask(step)
                self.maybe_upsample(step)
        self.start_step = end_step
        return logs

    # ------------------------------------------------------------------
    # rendering / validation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_image(self, pose, K, h: int, w: int,
                     step: Optional[int] = None,
                     chunk: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Full-frame render (ref: shapeRenderer.py:568-668) in chunks of
        ``test_ray_num`` rays, the last one padded with copies of its last
        ray; returns the EVAL_KEYS images [h, w, k] on the host.  The alpha
        mask is not applied: the JAX package's render_image does not pass
        it (trainer.py:490-493 there)."""
        step = step if step is not None else 300000
        chunk = chunk or self.cfg['test_ray_num']
        info = {'imgs': np.zeros((1, h, w, 3), np.float32),
                'Ks': np.asarray(K, np.float32)[None],
                'poses': np.asarray(pose, np.float32)[None]}
        if self.cfg['nerfDataType']:
            batch, rn, _, _ = rays_mod.construct_ray_batch_nerf(info)
        else:
            batch, rn, _, _ = rays_mod.construct_ray_batch_w2c(info)
        del batch['rgbs']
        mips = light_mod.build_mips(self.params['shading']['envlight'],
                                    self.rcfg.shading.env)
        out = {k: [] for k in EVAL_KEYS}
        for ri in range(0, rn, chunk):
            sub = {k: v[ri:ri + chunk] for k, v in batch.items()}
            n_real = len(sub['rays_o'])
            if n_real < chunk:
                sub = {k: np.concatenate(
                    [v, np.repeat(v[-1:], chunk - n_real, 0)], 0)
                    for k, v in sub.items()}
            res = sr.render_rays(
                self.params, self.rcfg, mips, self.occ_state,
                _batch_to_device(sub, self.device), step, 1.0, None, False,
                radiance_on=self.cfg['has_radiance_field'],
                eval_extras=True)
            for k in EVAL_KEYS:
                out[k].append(res[k][:n_real].float().cpu().numpy())
        return {k: np.concatenate(v, 0).reshape(h, w, -1)
                for k, v in out.items()}

    def validate(self, max_views: Optional[int] = None,
                 downsample: Optional[float] = None) -> float:
        """Mean PSNR over the held-out split (ref: trainer_inv.py:217-237),
        every view by default; writes each view's diagnostic tile where
        cv2 imports (metrics_vis.eval_and_dump).  On a mesh rank r
        renders views r, r + size, ... and every rank gets the mean over
        all of them (one all-reduce), so no rank waits out another's
        renders in a collective."""
        vids = self.test_ids if max_views is None else \
            self.test_ids[:max_views]
        return sharding.global_mean(self.mesh, [
            self._view_psnr(vid, downsample)
            for vid in sharding.rank_share(self.mesh, vids)])

    def _view_psnr(self, vid, downsample) -> float:
        ds = downsample if downsample is not None else (
            self.cfg['downsample_ratio'] if self.cfg['test_downsample_ratio']
            else 1.0)
        gt = self.database.get_image(vid).astype(np.float32) / 255.0
        K = np.asarray(self.database.get_K(vid), np.float32).copy()
        pose = self.database.get_pose(vid)
        h, w = gt.shape[:2]
        if ds != 1.0:
            h, w = int(h * ds), int(w * ds)
            gt = metrics_vis.resize_linear(gt, h, w)
            K = np.diag([ds, ds, 1.0]).astype(np.float32) @ K
        out = self.render_image(pose, K, h, w)
        return metrics_vis.eval_and_dump(gt, out, self.cfg['name'],
                                         self.start_step, vid)['psnr']
