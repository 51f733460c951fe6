"""Stage-1 (shape) trainer of the port (counterpart of
tensoflow_tpu/train/trainer.py).

Stage 1's own parts live here (config, Adam groups, forward and backward,
draws, step-key part, schedules, ``train``'s body, ``load``, rendering);
the step's engine is train/engine.py's (``ScheduledAdam`` re-exported).

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

``step_noise`` / ``occ_jitter`` are the only places the loop draws, so a
caller can substitute its own draws.

Grid upsampling (``upsample_list``) starts a new grid phase: the field is
resized, one more mip level joins, and Adam restarts with fresh moments
and its cosine factor rebased at that step.  ``render_image`` renders a
full view in chunks without gradients; ``validate`` scores the held-out
views.  As in the JAX package, render_image does not pass the alpha mask.

``mesh=`` (parallel/sharding.py) trains one rank of a ray-sharded data
mesh: params, Adam state and occupancy state are replicated from rank 0;
every rank draws the global batch and the global noise from the same seed
and takes its slice; the renderer's batch-wide statistics are global; the
params stay identical on every rank (train/engine.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import config as config_mod
from ..data import rays as rays_mod
from ..fields import light as light_mod
from ..fields import shading as shading_mod
from ..fields import tenso_sdf
from ..models import shape_renderer as sr
from ..ops import grid as grid_mod
from ..parallel import sharding
from ..utils.timing import span
from . import checkpoints, losses, metrics_vis
from .checkpoints import named_leaves  # noqa: F401  (re-exported)
from .engine import ScheduledAdam, StageTrainer, batch_to_device  # noqa: F401

# the images render_image returns
EVAL_KEYS = ('ray_rgb', 'normal', 'normal_vis', 'acc', 'depth', 'albedo',
             'roughness', 'metallic', 'occ_prob', 'occ_prob_gt',
             'diffuse_color', 'specular_color', 'diffuse_light',
             'specular_light', 'indirect_light')

# adaptive sample-budget buckets and margin (trainer.py:46-47 of the JAX
# package)
BUDGET_BUCKETS = (16, 24, 32, 48, 64, 96, 128)
BUDGET_MARGIN = 1.5


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


def param_group_label(path) -> str:
    """xyz = tensor grids; env = envlight cubemap; net = everything else
    (ref: trainer_inv.py:111-126)."""
    if 'field' in path:
        return 'xyz'
    if 'envlight' in path:
        return 'env'
    return 'net'


def with_human_light(rcfg: sr.ShapeRendererConfig
                     ) -> sr.ShapeRendererConfig:
    """``rcfg`` with stage 1's human light on (no config key reads it)."""
    return rcfg._replace(shading=rcfg.shading._replace(human_light=True))


class ShapeTrainer(StageTrainer):
    """End-to-end stage-1 training (geometry reconstruction)."""

    group_label = staticmethod(param_group_label)
    # the renderer takes the occ-loss scores of its global slots
    global_draws = ('occ_score',)

    def __init__(self, cfg: Dict[str, Any], device=None, mesh=None,
                 configure=None):
        """``configure`` (rcfg -> rcfg, e.g. with_human_light) edits the
        renderer config before the parameters are built."""
        super().__init__(cfg, device, mesh)
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
        self.occ_update_interval = 100
        self._budget_ema = None
        self.set_params(params)

    # ------------------------------------------------------------------
    def init_dataset(self):
        cfg = self.cfg
        batch, _ = self._open_split(cfg['apply_mask_loss'])
        batch = rays_mod.filter_rays_aabb(batch, cfg['aabb'])
        self.batcher = rays_mod.RayBatcher(batch, cfg['train_ray_num'],
                                           cfg['random_seed'])

    # -- random draws --------------------------------------------------
    def step_noise(self, step: int) -> Dict[str, torch.Tensor]:
        """The training step's draws (sampler jitter, occ-loss scores, the
        background's jitter)."""
        return sr.draw_noise(self.gen, self.rcfg, self.cfg['train_ray_num'],
                             self.device)

    def occ_jitter(self, step: int) -> torch.Tensor:
        """Uniform [R^3, 3] draws jittering the occ-update cell centers."""
        r = self.occ_cfg.resolution
        return torch.rand((r ** 3, 3), generator=self.gen,
                          device=self.device)

    # -- one occupancy update / one training step ----------------------
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
        """Forward, backward and one Adam step (engine.StageTrainer._step)
        on this rank's batch and draws (shard_noise); returns the detached
        loss terms (``loss`` = their sum), psnr, std and sample_num.  The
        occupancy-grid route stays eager (graph_engages): its
        grid refresh replaces ``occ_state`` and its budget and stride can
        change every occ_update_interval steps; no benchmark cell times
        it yet."""
        return self._step(step, batch, weights, noise, radiance_on, occ_on)

    def graph_engages(self) -> bool:
        """The engine's rule, on the hierarchical sampler only."""
        return super().graph_engages() and not self.rcfg.use_occ_grid

    def step_scalars(self, step: int) -> Dict[str, float]:
        """The stage-1 step's own scalar that changes from step to step:
        the cosine anneal ratio, by _forward_backward's name for it."""
        return {'anneal': sr.cos_anneal_ratio(self.rcfg, step)}

    def _stage_key(self, step: int, radiance_on: bool, occ_on: bool):
        """step_key's stage-1 part: the renderer config (grid, levels,
        widths, route), the alpha mask's volume (a refresh replaces it)
        and the phase gates; and the mask, whose volume's id it holds."""
        rc, mask = self.rcfg, self.alpha_mask
        return (rc, None if mask is None else id(mask.volume),
                radiance_on, occ_on,
                rc.freeze_inv_s_step is not None
                and step < rc.freeze_inv_s_step,
                step > rc.gaussian_loss_step,
                step > rc.radiance_field_step), mask

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

    # -- checkpointing -------------------------------------------------
    def _checkpoint(self):
        return {
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
        }

    def load(self, path: str):
        ckpt = checkpoints.load_checkpoint(path)
        kw = ckpt['kwargs']
        self.rcfg = build_shape_config(
            self.cfg, kw['grid_size'], kw['n_levels'])._replace(
                march_stride=ckpt['march_stride'],
                compact_samples_per_ray=ckpt['compact_samples_per_ray'])
        self.occ_state = self._to_device(ckpt['occ_state'])
        self.alpha_mask = checkpoints.unpack_alpha_mask(
            ckpt.get('alpha_mask'), self.device)
        self.n_voxel_list = list(ckpt['N_voxel_list'])
        # restore the Adam moments + schedule count against the ORIGINAL
        # reset step (ref: trainer_inv.py:108-113)
        saved = ckpt.get('opt_state')
        self._restore(ckpt, self._to_device(ckpt['params']),
                      saved['reset_step'] if saved else ckpt['step'])

    # ------------------------------------------------------------------
    def train(self, n_steps: Optional[int] = None, log_every: int = 100,
              callback=None):
        logs, steps = [], self._steps(n_steps)
        for step in steps:
            with span('tf.step'):
                self.maybe_set_march_stride(step)
                if (self.rcfg.use_occ_grid
                        and step % self.occ_update_interval == 0):
                    self.occ_update(step,
                                    prune=step >= self.occ_warmup_steps())
                batch = batch_to_device(sharding.shard_batch(
                    self.mesh, self.batcher.next_batch()), self.device)
                weights = losses.schedule_weights(self.cfg, step)
                radiance_on, occ_on = self.phase_flags(step)
                aux = self.train_step(
                    step, batch, weights,
                    self.shard_noise(self.step_noise(step)), radiance_on,
                    occ_on)
                self._log(step, aux, log_every, logs, callback)
                self.maybe_adapt_budget(step, aux)
                self.maybe_update_alpha_mask(step)
                self.maybe_upsample(step)
        self.start_step = steps.stop
        return logs

    # -- rendering / validation ----------------------------------------
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
        batch, rn = self._view_rays(pose, K, h, w)
        del batch['rgbs']
        mips = light_mod.build_mips(self.params['shading']['envlight'],
                                    self.rcfg.shading.env)
        out = {k: [] for k in EVAL_KEYS}
        for sub, n_real in self._chunks(batch, rn, chunk):
            res = sr.render_rays(
                self.params, self.rcfg, mips, self.occ_state,
                batch_to_device(sub, self.device), step, 1.0, None, False,
                radiance_on=self.cfg['has_radiance_field'],
                eval_extras=True)
            for k in EVAL_KEYS:
                out[k].append(res[k][:n_real].float().cpu().numpy())
        return {k: np.concatenate(v, 0).reshape(h, w, -1)
                for k, v in out.items()}

    def _view_psnr(self, vid, downsample) -> float:
        """validate's PSNR of one view (ref: trainer_inv.py:217-237), by
        default at the test downsampling; writes its diagnostic tile."""
        ds = downsample if downsample is not None else (
            self.cfg['downsample_ratio'] if self.cfg['test_downsample_ratio']
            else 1.0)
        gt, pose, K, h, w = self._view(vid, ds)
        out = self.render_image(pose, K, h, w)
        return metrics_vis.eval_and_dump(gt, out, self.cfg['name'],
                                         self.start_step, vid)['psnr']
