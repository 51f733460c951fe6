"""Stage-2 (material) trainer of the port (counterpart of
tensoflow_tpu/train/trainer_mat.py).

  * the stage-1 checkpoint is loaded and its SDF baked to the packed trace
    grid once;
  * all training rays are traced against the baked SDF in chunks on the
    device; misses are dropped on the host (one-time preprocessing, ref:
    materialRenderer.py:383-417);
  * per step: slice ``train_ray_num`` hits, shade, sum the loss terms,
    backpropagate and take one eager Adam step; on the card the shade,
    loss sum and backward are the replay of one CUDA graph
    (``MaterialTrainer.train_step``); the only host-to-device copy of a
    step is its batch, and the trace statistics are read by the host
    only every SEC_BUDGET_INTERVAL steps and at ``log_every``;
  * frozen flow copies are refreshed on the reference schedule
    (ref: fields.py:1050-1065): detached clones the optimizer never sees;
    with ``use_nis_all`` the combined flow's copy takes the 'diffuse'
    slot, before flow_diffuse's (which then overwrites it);
  * render_image / validate render held-out views in chunks of 512 rays:
    primary trace, the analytic eval pass and, once the flow copies exist,
    the ``_nis`` pass;
  * the spans ``tf.step`` (one step of ``train``), ``tf.forward`` and
    ``tf.backward`` (utils/timing.span; inside the forward,
    fields/mc_shading.py opens ``tf.mat_field``, ``tf.flow``,
    ``tf.sec_trace`` and ``tf.lights``) record only under a profiler.

Entry points run on the card: ``MaterialTrainer(cfg, path)`` means CUDA and
raises when CUDA is absent; the CPU runs only with ``device='cpu'``.

``mesh=`` (parallel/sharding.py) trains one rank of a data mesh: the hit
batch is sharded; params, flow copies, the baked SDF grid and the frozen
geometry are replicated (every rank traces the same hits in
``init_dataset``); the shader's slot budgets come from the global ray
count and its trace rates are global; gradients and logged terms are
summed in one all-reduce before Adam.  Only rank 0 writes checkpoints;
every rank validates its share of the held-out views.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..parallel import sharding
from ..data import database as db_mod
from ..data import rays as rays_mod
from ..fields import mc_shading, tenso_sdf
from ..models import material_renderer as mr
from ..utils.timing import recording, span
from . import checkpoints, losses, metrics_vis
from .checkpoints import named_leaves
from .trainer import (ScheduledAdam, _batch_to_device, all_reduce_step,
                      graphed_step, scalar_views)

# adaptive secondary-trace budget: the trainer re-buckets the slot budget
# to the measured candidate rate, so that compaction cost tracks the
# scene's actual self-occlusion
SEC_BUDGET_BUCKETS = (0.125, 0.1875, 0.25, 0.3125, 0.375, 0.5, 0.75)
SEC_BUDGET_MARGIN = 1.3
SEC_BUDGET_INTERVAL = 500
# hit-slot budget of the inner-light MLP compaction, re-bucketed to the
# measured secondary hit rate; overflow degrades to the outer light only
INNER_BUDGET_BUCKETS = (0.03125, 0.0625, 0.125, 0.25, 0.5)
INNER_BUDGET_MARGIN = 1.5
# coarse-march budget when the visibility cache is baked
A1_BUDGET_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)
A1_BUDGET_MARGIN = 1.15

STEP_BATCH_KEYS = ('inters', 'normals', 'rays_d', 'rgb')
# what render_image returns for each pixel, before the '_nis' copies
RENDER_KEYS = ('rgb_pr', 'normal', 'specular_light', 'specular_color',
               'diffuse_light', 'diffuse_color', 'albedo', 'metallic',
               'roughness', 'visibility', 'indirect_light')


def mat_param_group_label(path) -> str:
    """xyz = all VM grids (material + flow fields); env = envlight cubemap;
    net = MLPs (ref: fields.py:1580-1595 get_optparam_groups)."""
    if 'planes' in path or 'lines' in path:
        return 'xyz'
    if 'outer_light' in path and 'base' in path:
        return 'env'
    return 'net'


def build_material_config(cfg: Dict[str, Any], geo_kwargs: Dict[str, Any]
                          ) -> mr.MaterialRendererConfig:
    shader_over = dict(cfg.get('shader_cfg') or {})
    base = mc_shading.MCShadingConfig()
    valid = {k: tuple(v) if isinstance(v, list) else v
             for k, v in shader_over.items() if k in base._fields}
    shader = base._replace(**valid)
    mc_shading.check_supported(shader)
    sdf_cfg = tenso_sdf.SDFConfig(
        grid_size=tuple(geo_kwargs['grid_size']),
        n_comp=geo_kwargs['sdf_n_comp'], sdf_dim=geo_kwargs['sdf_dim'],
        app_dim=geo_kwargs['app_dim'], n_levels=geo_kwargs['n_levels'],
        sdf_multires=geo_kwargs.get('sdf_multires', 3),
        gather_dtype=cfg.get('gather_dtype', 'float32'),
        stencil_impl=cfg.get('stencil_impl', 'auto'))
    return mr.MaterialRendererConfig(
        shader=shader, sdf=sdf_cfg,
        aabb=tuple(tuple(x) for x in geo_kwargs['aabb']),
        train_ray_num=cfg['train_ray_num'],
        test_ray_num=cfg['test_ray_num'],
        rgb_loss=cfg['rgb_loss'], reg_mat=cfg['reg_mat'],
        reg_diffuse_light=cfg['reg_diffuse_light'],
        reg_diffuse_light_lambda=cfg['reg_diffuse_light_lambda'],
        std_act=cfg['std_act'], inv_s_init=cfg['inv_s_init'],
        bake_resolution=cfg.get('bake_resolution', 256),
        trace_packed=cfg.get('trace_packed', True),
        refine_with_neural_sdf=cfg.get('refine_with_neural_sdf', True))


def _clone_tree(tree):
    return checkpoints.tree_map(lambda t: t.detach().clone(), tree)


def step_scalars(step: int, weights: Dict[str, float]):
    """The stage-2 step's scalars that change from step to step, in the
    order the captured step reads them (trainer.scalar_views): the
    material clamps' factor, then the schedule weights."""
    return [mr.reg_minmax_factor(step), *weights.values()]


def _step_terms(outputs, terms):
    """What train_step returns, undetached: psnr, variance, the loss
    terms, the trace rates, then ``loss``."""
    aux = {'psnr': outputs['psnr'], 'variance': outputs['variance'],
           **{k: v for k, v in terms.items() if k != 'loss'}}
    for k in ('secondary_cand_rate', 'secondary_hit_rate',
              'secondary_a1_rate'):
        if k in outputs:
            aux[k] = outputs[k]
    aux['loss'] = terms['loss']
    return aux


class MaterialTrainer:
    def __init__(self, cfg: Dict[str, Any], geo_ckpt_path: str, device=None,
                 mesh=None):
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        self.cfg = cfg
        self.init_gen = torch.Generator().manual_seed(cfg['random_seed'])
        self.gen = torch.Generator(device=self.device).manual_seed(
            cfg['random_seed'])

        geo_ckpt = checkpoints.load_checkpoint(geo_ckpt_path)
        self.rcfg = build_material_config(cfg, geo_ckpt['kwargs'])
        self.geo_params = checkpoints.tree_map(
            lambda t: t.detach().to(self.device),
            {'sdf': geo_ckpt['params']['sdf'],
             'deviation': geo_ckpt['params']['deviation']})
        self.grid = mr.bake_geometry(self.geo_params, self.rcfg, self.device)

        self.flow_copies: Dict[str, Any] = {}
        self.start_step = 0
        self.best_para = 0.0
        # steps by path, and captures (train_step)
        self.graph_stats = {'replayed': 0, 'eager': 0, 'captures': 0}
        self._graph = None
        self.set_params(mc_shading.init_mc_shading(
            self.init_gen, self.rcfg.shader, self.device))

    def set_params(self, params, reset_step: int = 0):
        """Install a parameter tree (e.g. convert.params_from_jax) and a
        fresh optimizer rebased at ``reset_step``; on a mesh, rank 0's
        tree is broadcast to every rank."""
        sharding.replicate_tree(self.mesh, params)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        self.params = params
        self.opt = ScheduledAdam(self.cfg, params, reset_step,
                                 label_fn=mat_param_group_label)

    # ------------------------------------------------------------------
    def init_dataset(self, max_train_rays: Optional[int] = None):
        cfg = self.cfg
        self.database = db_mod.parse_database_name(
            cfg['database_name'], cfg['dataset_dir'],
            isWhiteBG=cfg['isBGWhite'])
        train_ids, test_ids = db_mod.get_database_split(
            self.database, split_manul=cfg['split_manul'])
        self.train_ids, self.test_ids = list(train_ids), list(test_ids)
        info = rays_mod.build_imgs_info(self.database, self.train_ids)
        if cfg['nerfDataType']:
            batch, rn, _, _ = rays_mod.construct_ray_batch_nerf(info)
        else:
            batch, rn, _, _ = rays_mod.construct_ray_batch_w2c(info)
        batch = {'rays_o': batch['rays_o'], 'rays_d': batch['dirs'],
                 'rgb': batch['rgbs'], 'human_poses': batch['human_poses']}
        if max_train_rays is not None and rn > max_train_rays:
            idx = np.random.RandomState(0).choice(rn, max_train_rays, False)
            batch = {k: v[idx] for k, v in batch.items()}
        batch = self._trace_filter(batch)
        self.batcher = rays_mod.RayBatcher(batch, cfg['train_ray_num'],
                                           cfg['random_seed'])
        self.tbn = len(batch['rays_o'])

    def _trace_filter(self, batch, chunk: int = 65536):
        """One-time surface-hit preprocessing (ref: 383-417): trace all
        train rays, keep the hits with their intersections, normals and
        depths."""
        n = len(batch['rays_o'])
        keep = {k: [] for k in
                list(batch.keys()) + ['inters', 'normals', 'depth']}
        for i in range(0, n, chunk):
            o = torch.as_tensor(batch['rays_o'][i:i + chunk],
                                dtype=torch.float32, device=self.device)
            d = torch.as_tensor(batch['rays_d'][i:i + chunk],
                                dtype=torch.float32, device=self.device)
            inters, normals, depth, hit = mr.trace_surface(
                self.geo_params, self.rcfg, self.grid, o, d)
            hit = hit.cpu().numpy()
            for k in batch:
                keep[k].append(batch[k][i:i + chunk][hit])
            keep['inters'].append(inters.cpu().numpy()[hit])
            keep['normals'].append(normals.cpu().numpy()[hit])
            keep['depth'].append(depth.cpu().numpy()[hit])
        out = {k: np.concatenate(v, 0) for k, v in keep.items()}
        self.kept_share = len(out['rays_o']) / max(n, 1)
        print(f'surface-hit filtering: kept {len(out["rays_o"])}/{n} '
              f'({self.kept_share:.1%})')
        return out

    # ------------------------------------------------------------------
    def update_flow_copies(self, step: int):
        """(ref: fields.py:1050-1065)"""
        scfg = self.rcfg.shader
        s1 = step + 1
        due = (s1 >= scfg.nis_start_iter
               and (s1 - scfg.nis_start_iter) % scfg.nis_update_interval == 0)
        # the combined flow (shade_mixed_all) rides in the diffuse slot;
        # with use_nis_diffuse on too, flow_diffuse's copy replaces it
        # (the reference's order, kept as it is)
        if scfg.use_nis_all and due:
            self.flow_copies['diffuse'] = _clone_tree(self.params['flow_all'])
        if scfg.use_nis_diffuse and due:
            self.flow_copies['diffuse'] = _clone_tree(
                self.params['flow_diffuse'])
        if scfg.use_nis_specular and due:
            self.flow_copies['specular'] = _clone_tree(
                self.params['flow_specular'])

    def phase(self, step: int) -> mc_shading.ShadePhase:
        """The step's phase flags.  The NIS-loss flags follow
        use_nis_diffuse / use_nis_specular even for shade_mixed_all, whose
        combined-flow loss therefore needs one of them on (the
        reference's gating, kept as it is)."""
        scfg = self.rcfg.shader
        return mc_shading.ShadePhase(
            nis_sample_diffuse=('diffuse' in self.flow_copies),
            nis_sample_specular=('specular' in self.flow_copies),
            nis_loss_diffuse=(scfg.use_nis_diffuse
                              and step >= scfg.nis_loss_iter),
            nis_loss_specular=(scfg.use_nis_specular
                               and step >= scfg.nis_loss_iter))

    def step_keys(self):
        """The hit-batch columns a step takes to the device: the human
        poses only where the shader blends in the human light."""
        return STEP_BATCH_KEYS + (('human_poses',)
                                  if self.rcfg.shader.human_lights else ())

    def step_noise(self, step: int, phase) -> Dict[str, torch.Tensor]:
        """The training step's draws (the flow priors' and the analytic
        samplers' azimuth rolls); the only place the loop draws."""
        return mc_shading.draw_shade_noise(
            self.gen, self.rcfg.shader, self.cfg['train_ray_num'], phase,
            self.device)

    def shard_noise(self, noise):
        """This rank's slice of the step's draws (each has the points'
        axis first)."""
        if not sharding.active(self.mesh):
            return noise
        lo, hi = sharding.shard_range(self.mesh, self.cfg['train_ray_num'])
        return {k: v[lo:hi] for k, v in noise.items()}

    def train_step(self, step: int, batch: Dict[str, torch.Tensor],
                   weights: Dict[str, float], noise, phase
                   ) -> Dict[str, torch.Tensor]:
        """Forward, backward and one Adam step; returns the detached loss
        terms (``loss`` = their sum), psnr, variance and the trace
        rates, all still on the device, each step its own tensors.  On a
        mesh the batch and noise are this rank's and everything returned
        is global.

        Where graph_engages, the forward, loss sum and backward run as the
        replay of one CUDA graph (trainer.graphed_step) while the step key
        (step_key) holds: at a new key, GRAPH_WARMUP_STEPS eager steps on
        a side stream, then a capture.  Adam stays eager.  Elsewhere (on
        the CPU, on a mesh, under a profiler) the step runs eagerly."""
        if not self.graph_engages():
            self.graph_stats['eager'] += 1
            return self._eager_step(step, batch, weights, noise, phase)

        def body(b, n, s):
            return self._graph_body(step, b, n, s, tuple(weights), phase)
        return graphed_step(
            self, self.step_key(step, batch, weights, noise, phase),
            (self.opt.params, dict(self.flow_copies), self.grid),
            lambda: self._eager_step(step, batch, weights, noise, phase),
            body, batch, noise, step_scalars(step, weights))

    def graph_engages(self) -> bool:
        """Whether train_step replays a CUDA graph: on the card, without a
        mesh, while no profiler records (a replay records no host ranges
        for the profile to read)."""
        return (self.device.type == 'cuda' and not sharding.active(self.mesh)
                and not recording())

    def step_key(self, step: int, batch, weights, noise, phase):
        """Everything that picks the step's Python control flow or the
        identity of a tensor it reads, beside its inputs' values: the
        renderer config (widths and the slot budgets, which an adaptation
        re-buckets), the parameter leaves, the frozen flow copies' leaves
        (update_flow_copies replaces them with fresh clones), the baked
        grid, the phase flags, the weights' keys and the inputs' shapes.
        The material clamps' factor is a scalar of the step
        (step_scalars), not a part of the key."""
        copies = tuple((slot, tuple(id(t) for _, t in named_leaves(tree)))
                       for slot, tree in sorted(self.flow_copies.items()))
        return (self.rcfg, tuple(map(id, self.opt.params)), copies,
                id(self.grid), phase, tuple(weights),
                tuple((k, tuple(v.shape)) for k, v in batch.items()),
                tuple((k, tuple(v.shape)) for k, v in noise.items()))

    def _forward_backward(self, step, batch, weights, noise, phase,
                          reg_minmax=None):
        """The step's forward, loss sum and backward; returns (the
        renderer's outputs, the loss terms with their sum, ``loss``), both
        undetached and this rank's."""
        with span('tf.forward'):
            outputs = mr.train_step_outputs(
                self.params, self.rcfg, self.grid, batch, phase, noise,
                step, self.flow_copies.get('diffuse'),
                self.flow_copies.get('specular'), mesh=self.mesh,
                reg_minmax=reg_minmax)
            total, terms = losses.total_loss_material(outputs, weights,
                                                      self.mesh)
        with span('tf.backward'):
            total.backward()
        return outputs, {**terms, 'loss': total}

    def _eager_step(self, step, batch, weights, noise, phase):
        self.opt.zero_grad()
        outputs, terms = self._forward_backward(step, batch, weights, noise,
                                                phase)
        terms = all_reduce_step(self.mesh, self.opt.params, terms)
        self.opt.step()
        return {k: v.detach() for k, v in _step_terms(outputs, terms).items()}

    def _graph_body(self, step, batch, noise, scalars, weight_keys, phase):
        """What the CUDA graph holds: _forward_backward with the clamps'
        factor and the weights read from ``scalars`` (step_scalars' values
        in one tensor); returns the terms' keys and their values
        stacked."""
        reg_minmax, weights = scalar_views(scalars, weight_keys)
        outputs, terms = self._forward_backward(step, batch, weights, noise,
                                                phase, reg_minmax)
        aux = _step_terms(outputs, terms)
        return list(aux), torch.stack([v.detach().float().reshape(())
                                       for v in aux.values()])

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
                self.update_flow_copies(step)
                phase = self.phase(step)
                host_batch = self.batcher.next_batch()
                batch = _batch_to_device(sharding.shard_batch(
                    self.mesh, {k: host_batch[k]
                                for k in self.step_keys()}), self.device)
                weights = losses.schedule_weights(self.cfg, step)
                aux = self.train_step(
                    step, batch, weights,
                    self.shard_noise(self.step_noise(step, phase)), phase)
                if ((step + 1) % SEC_BUDGET_INTERVAL == 0
                        and 'secondary_cand_rate' in aux):
                    # the JAX step hands its trainer the candidate and hit
                    # rates only, so the a1 budget keeps its configured
                    # value
                    self._adapt_secondary_budget(
                        float(aux['secondary_cand_rate']),
                        float(aux['secondary_hit_rate']))
            if (step + 1) % log_every == 0 or step == self.start_step:
                vals = torch.stack([v.float() for v in aux.values()])
                host = dict(zip(aux, vals.tolist()))   # one device read
                host['step'] = step + 1
                logs.append(host)
                if callback:
                    callback(host)
        self.start_step = end_step
        return logs

    # ------------------------------------------------------------------
    def _adapt_secondary_budget(self, cand_rate: float,
                                hit_rate: float = -1.0,
                                a1_rate: float = -1.0):
        """Re-bucket the secondary-trace refinement budget to the live
        candidate rate, and the inner-light hit budget to the live hit
        rate (a new bucket only changes Python integers)."""
        scfg = self.rcfg.shader
        if not (0.0 < scfg.secondary_budget < 1.0):
            return
        want = next((b for b in SEC_BUDGET_BUCKETS
                     if b >= cand_rate * SEC_BUDGET_MARGIN),
                    SEC_BUDGET_BUCKETS[-1])
        repl = {}
        if want != scfg.secondary_budget:
            repl['secondary_budget'] = want
        if hit_rate >= 0.0 and 0.0 < scfg.inner_light_budget < 1.0:
            want_h = next((b for b in INNER_BUDGET_BUCKETS
                           if b >= hit_rate * INNER_BUDGET_MARGIN),
                          INNER_BUDGET_BUCKETS[-1])
            if want_h != scfg.inner_light_budget:
                repl['inner_light_budget'] = want_h
        if a1_rate >= 0.0 and 0.0 < scfg.a1_budget < 1.0:
            want_a = next((b for b in A1_BUDGET_BUCKETS
                           if b >= a1_rate * A1_BUDGET_MARGIN),
                          A1_BUDGET_BUCKETS[-1])
            if want_a != scfg.a1_budget:
                repl['a1_budget'] = want_a
        if repl:
            self.rcfg = self.rcfg._replace(shader=scfg._replace(**repl))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_chunk(self, o, d, with_nis: bool) -> Dict[str, torch.Tensor]:
        """One chunk of the view: trace, eval_outputs; returns the
        RENDER_KEYS (then their '_nis' copies, then 'hit') as [n, k]
        float32 tensors on the device."""
        inters, normals, _, hit = mr.trace_surface(
            self.geo_params, self.rcfg, self.grid, o, d)
        noise = mc_shading.draw_eval_noise(
            self.gen, self.rcfg.shader, o.shape[0], self.device) \
            if with_nis else None
        out = mr.eval_outputs(
            self.params, self.rcfg, self.grid,
            {'inters': inters, 'normals': normals, 'rays_d': d},
            self.flow_copies.get('diffuse'), self.flow_copies.get('specular'),
            with_nis, noise)
        keys = list(RENDER_KEYS) + ([k + '_nis' for k in RENDER_KEYS]
                                    if with_nis else [])
        res = {k: out[k].float().reshape(o.shape[0], -1) for k in keys}
        res['hit'] = hit.float()[:, None]
        return res

    def render_image(self, pose, K, h: int, w: int, chunk: int = 512
                     ) -> Dict[str, np.ndarray]:
        """Novel-view render (ref: materialRenderer.py:641-752) in chunks
        of ``chunk`` rays, the last one padded with copies of its last ray.
        Every image is zeroed where the primary ray misses; ``rgb_pr``
        (not ``rgb_pr_nis``) gets the white background there.  Returns
        [h, w, k] images on the host and ``hit_mask`` [h, w, 1]."""
        info = {'imgs': np.zeros((1, h, w, 3), np.float32),
                'Ks': np.asarray(K, np.float32)[None],
                'poses': np.asarray(pose, np.float32)[None]}
        if self.cfg['nerfDataType']:
            batch, rn, _, _ = rays_mod.construct_ray_batch_nerf(info)
        else:
            batch, rn, _, _ = rays_mod.construct_ray_batch_w2c(info)
        rays = {'o': batch['rays_o'], 'd': batch['dirs']}
        with_nis = 'diffuse' in self.flow_copies
        cols, widths = [], {}
        for ri in range(0, rn, chunk):
            sub = {k: v[ri:ri + chunk] for k, v in rays.items()}
            n_real = len(sub['o'])
            if n_real < chunk:
                sub = {k: np.concatenate(
                    [v, np.repeat(v[-1:], chunk - n_real, 0)], 0)
                    for k, v in sub.items()}
            sub = _batch_to_device(sub, self.device)
            res = self.render_chunk(sub['o'], sub['d'], with_nis)
            widths = {k: v.shape[1] for k, v in res.items()}
            # one device-to-host copy a chunk
            cols.append(torch.cat(list(res.values()), -1)[:n_real].cpu())
        flat = torch.cat(cols, 0).numpy()
        hit = flat[:, -1:]
        img, at = {}, 0
        for k, wd in widths.items():
            if k != 'hit':
                img[k] = (flat[:, at:at + wd] * hit).reshape(h, w, wd)
            at += wd
        img['rgb_pr'] = img['rgb_pr'] + (1.0 - hit.reshape(h, w, 1))
        img['hit_mask'] = hit.reshape(h, w, 1)
        return img

    def validate(self, max_views: Optional[int] = None,
                 downsample: float = 1.0) -> float:
        """Mean PSNR over the held-out split at full resolution by default
        (ref: trainer_mat.py validate), of ``rgb_pr_nis`` with the white
        background added once the flow copies exist, else of ``rgb_pr``;
        max_views / downsample subsample it.  On a mesh rank r renders
        views r, r + size, ... and every rank gets the mean over all of
        them (one all-reduce)."""
        vids = self.test_ids if max_views is None else \
            self.test_ids[:max_views]
        return sharding.global_mean(self.mesh, [
            self._view_psnr(vid, downsample)
            for vid in sharding.rank_share(self.mesh, vids)])

    def _view_psnr(self, vid, downsample) -> float:
        gt = self.database.get_image(vid).astype(np.float32) / 255.0
        K = np.asarray(self.database.get_K(vid), np.float32).copy()
        pose = self.database.get_pose(vid)
        h, w = gt.shape[:2]
        if downsample != 1.0:
            h, w = int(h * downsample), int(w * downsample)
            gt = metrics_vis.resize_linear(gt, h, w)
            K = np.diag([downsample, downsample, 1.0]).astype(
                np.float32) @ K
        out = self.render_image(pose, K, h, w)
        key = 'rgb_pr_nis' if 'rgb_pr_nis' in out else 'rgb_pr'
        pr = out[key]
        if key == 'rgb_pr_nis':
            pr = pr + (1.0 - out['hit_mask'])
        mse = float(np.mean((pr - gt) ** 2))
        return float(-10.0 * np.log10(max(mse, 1e-10)))

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
            'flow_copies': self.flow_copies,
            'kwargs': {
                'aabb': [list(a) for a in self.rcfg.aabb],
                'grid_size': list(self.rcfg.sdf.grid_size),
            },
        })

    def load(self, path: str, reset_flows: bool = True):
        """Resume.  With ``reset_flows`` (the reference's resume semantics,
        ref: trainer_inv.py:102: 'flow' keys filtered out of the restored
        state dict) the NIS flows restart from a fresh init with zero Adam
        moments and the frozen sampling copies are cleared; pass False to
        restore them exactly."""
        ckpt = checkpoints.load_checkpoint(path)
        to_dev = lambda t: t.to(self.device)   # noqa: E731
        restored = checkpoints.tree_map(to_dev, ckpt['params'])
        if reset_flows:
            fresh = mc_shading.init_mc_shading(
                self.init_gen, self.rcfg.shader, self.device)
            for name in list(restored):
                if name.startswith('flow'):
                    restored[name] = fresh[name]
            self.flow_copies = {}
        else:
            self.flow_copies = checkpoints.tree_map(
                to_dev, ckpt.get('flow_copies', {}))
        self.start_step = ckpt['step']
        self.best_para = ckpt.get('best_para', 0.0)
        # stage 2 never reshapes params: restore the Adam moments +
        # schedule count against reset_step=0 (ref: trainer_inv.py:108-113)
        self.set_params(restored, 0)
        zero_if = (lambda path: str(path[0]).startswith('flow')) \
            if reset_flows else None
        if not checkpoints.restore_opt_state(ckpt.get('opt_state'),
                                             self.opt, zero_if):
            self.set_params(restored, self.start_step)
