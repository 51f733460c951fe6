"""Stage-2 Monte-Carlo PBR shader with neural importance sampling
(counterpart of tensoflow_tpu/fields/mc_shading.py).

Per surface point, the rendering integral is estimated with
cosine-hemisphere diffuse samples + GGX specular samples, optionally mixed
with samples drawn from frozen copies of the conditional normalizing
flows; secondary-ray radiance = sphere-traced visibility (baked SDF grid)
selecting between an inner-light MLP (hit) and the trainable environment
cubemap (miss).  Dense ``[points, samples]`` layout with an NoL>0 mask.

Two estimators: ``shade_fn='shade_mixed'`` (separate diffuse and specular
sample sets, each with its own flow) and ``'shade_mixed_all'`` (one
direction set for both lobes, one combined flow ``flow_all``, whose frozen
copy rides in the diffuse-copy slot as in the reference); each with the
three outer lights ('envlight' cubemap, 'direction' and
'sphere_direction' MLPs), the photographer ``human_lights`` blend and the
three flow types of fields/flow.py.

Random draws: ``draw_shade_noise`` makes the step's draws from a
torch.Generator (``draw_eval_noise`` the realnvp prior's normals that an
evaluation pass also consumes); ``shade_mixed``/``shade_mixed_all``/
``mc_forward`` take them ready-made as ``noise`` (the parity tests hand in
jax.random's numbers).  The secondary trace runs under torch.no_grad():
it is non-differentiable in the reference too, and ~30 taps on 1.8M rays
would otherwise keep their inputs for a backward pass that never uses
them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device_constant
from ..ops import sdf_trace, tensor_field as tfield
from ..ops.brdf import (distribution_ggx, fresnel_schlick,
                        geometry as brdf_geometry)
from ..ops.grid import compact_indices_mesh, compact_take, scatter_back
from ..ops.math import (contraction, get_camera_plane_intersection,
                        get_sphere_intersection, ide_dim,
                        integrated_dir_encoding,
                        integrated_positional_encoding, linear_to_srgb,
                        pe_dim, positional_encoding, safe_normalize,
                        saturate_dot, xla_linspace)
from ..ops.samplers import (direction_table, direction_to_angle,
                            half_angles_to_directions,
                            sample_diffuse_directions,
                            sample_specular_directions)
from ..parallel import sharding
from ..utils.timing import span
from . import flow as flow_mod
from . import light as light_mod
from . import mlp

EPS = 1e-6
OUTER_LIGHTS = ('envlight', 'direction', 'sphere_direction')


class MCShadingConfig(NamedTuple):
    """(ref: fields.py:619-667 default_cfg)"""
    diffuse_sample_num: int = 512
    specular_sample_num: int = 256
    light_exp_max: float = 5.0
    inner_light_exp_max: float = 5.0
    outer_light_version: str = 'envlight'
    geometry_type: str = 'schlick'
    shade_fn: str = 'shade_mixed'
    reg_min_max: bool = True
    random_azimuth: bool = True
    human_lights: bool = False

    # NIS
    use_nis_all: bool = False
    use_nis_diffuse: bool = True
    use_nis_specular: bool = True
    grid_size: Tuple[int, int, int] = (512, 512, 512)
    nis_sample_num: int = 64
    nis_diffuse_sample_num: int = 64
    nis_specular_sample_num: int = 32
    nis_start_iter: int = 1000
    nis_loss_iter: int = 500
    nis_update_interval: int = 1000
    use_half_diffuse: bool = True
    use_half_specular: bool = True
    use_half_all: bool = True
    light_reso: int = 128
    flow_type: str = 'pwquad'
    disable_tensorial: bool = False
    disable_reflected: bool = False
    # fraction of secondary rays budgeted for the inner-light MLP; hits
    # are compacted to this budget, overflow falls back to the outer light
    # (0 or >= 1: dense, no compaction)
    inner_light_budget: float = 0.5
    # fraction of secondary rays budgeted for full-fidelity trace
    # refinement (ops/sdf_trace.sphere_trace_budget); 0 or >= 1 traces
    # every ray at full fidelity.  The trainer adapts it.
    secondary_budget: float = 0.375
    # fraction of secondary rays budgeted for the coarse march when the
    # packed grid carries a visibility cache; 0 or >= 1: dense march.
    a1_budget: float = 0.625

    # material field
    mat_n_comp: int = 36
    mat_n_levels: int = 3

    # dtype of the wide [pn, sn, 3] estimator chains (BRDF weights, light
    # mixing): 'bf16' halves their traffic; every reduction over the
    # samples axis accumulates in float32, and the flow chains, the trace
    # and direction sampling stay float32.
    estimator_dtype: str = 'bf16'           # 'f32' | 'bf16'

    @property
    def mat_feature_dim(self) -> int:
        return self.mat_n_comp * 3

    @property
    def flow(self) -> flow_mod.FlowConfig:
        return flow_mod.FlowConfig(
            grid_size=self.grid_size, flow_type=self.flow_type,
            disable_tensorial=self.disable_tensorial,
            disable_reflected=self.disable_reflected)


def check_supported(cfg: MCShadingConfig):
    """Raise for an outer light or a flow type the JAX package rejects
    too.  (Any shade_fn other than 'shade_mixed_all' takes shade_mixed,
    as in the reference's dispatch.)"""
    if cfg.outer_light_version not in OUTER_LIGHTS:
        raise NotImplementedError(cfg.outer_light_version)
    if cfg.flow_type not in flow_mod.FLOW_TYPES:
        raise ValueError(f'unknown flow_type {cfg.flow_type!r}')


def init_mc_shading(gen: torch.Generator, cfg: MCShadingConfig,
                    device='cpu') -> Dict[str, Any]:
    """(ref: fields.py:668-760)"""
    check_supported(cfg)
    pos_dim = pe_dim(3, 8)
    sph_dim = ide_dim(5)
    params: Dict[str, Any] = {
        'mat_field': tfield.init_vm_random(gen, cfg.grid_size,
                                           cfg.mat_n_comp, device=device),
        'metallic': mlp.init_predictor(gen, cfg.mat_feature_dim, 1, 2,
                                       device=device),
        'roughness': mlp.init_predictor(gen, cfg.mat_feature_dim, 1, 2,
                                        device=device),
        'albedo': mlp.init_predictor(gen, cfg.mat_feature_dim, 3, 2,
                                     device=device),
        'feats_network': mlp.init_material_feats(gen, pe_dim(3, 8),
                                                 device=device),
        'inner_light': mlp.init_predictor(
            gen, pos_dim + sph_dim, 3, 4, final_bias=float(np.log(0.5)),
            device=device),
    }
    if cfg.outer_light_version == 'envlight':
        params['outer_light'] = light_mod.init_env_light(
            light_mod.EnvLightConfig(max_res=cfg.light_reso), device)
    else:
        d_in = sph_dim * (2 if cfg.outer_light_version == 'sphere_direction'
                          else 1)
        params['outer_light'] = mlp.init_predictor(
            gen, d_in, 3, 4, final_bias=float(np.log(0.5)), device=device)
    if cfg.human_lights:
        params['human_light'] = mlp.init_predictor(
            gen, 2 * 2 * 6, 4, 4, final_bias=float(np.log(0.02)),
            device=device)
    if cfg.use_nis_all:
        params['flow_all'] = flow_mod.init_tenso_flow(gen, cfg.flow, device)
    if cfg.use_nis_diffuse:
        params['flow_diffuse'] = flow_mod.init_tenso_flow(gen, cfg.flow,
                                                          device)
    if cfg.use_nis_specular:
        params['flow_specular'] = flow_mod.init_tenso_flow(gen, cfg.flow,
                                                           device)
    return params


# ---------------------------------------------------------------------------
# materials (ref: fields.py:776-810, 1010-1017)
# ---------------------------------------------------------------------------

def mat_pack(params, cfg: MCShadingConfig):
    """Pack the material VM field into its gather atlas, once per step,
    for ``packed=`` below."""
    return tfield.pack_vm_field(params['mat_field'], cfg.mat_n_levels)


def tenso_feature(params, cfg: MCShadingConfig, pts, aabb, packed=None):
    """Material-field features at level 0: from the raw planes (stage 2
    evaluates this field at a few thousand points per step), or from
    ``packed`` (mat_pack), the same numbers."""
    xyz01 = contraction(pts, aabb)
    if packed is None:
        return tfield.vm_features(params['mat_field'], xyz01)
    return tfield.vm_features_packed(packed, xyz01)


def predict_materials(params, cfg: MCShadingConfig, pts, aabb, packed=None):
    feats = tenso_feature(params, cfg, pts, aabb, packed)
    metallic = mlp.apply_predictor(params['metallic'], feats, 'sigmoid')
    roughness = mlp.apply_predictor(params['roughness'], feats, 'sigmoid')
    rmax, rmin = 1.0, 0.04 ** 2
    roughness = roughness * (rmax - rmin) + rmin
    albedo = mlp.apply_predictor(params['albedo'], feats, 'sigmoid')
    return metallic, roughness, albedo


# ---------------------------------------------------------------------------
# lights (ref: fields.py:905-975)
# ---------------------------------------------------------------------------

def get_inner_lights(params, cfg: MCShadingConfig, points, view_out_dirs,
                     normals):
    """(ref: fields.py:905-911) view_out_dirs points AWAY from surface."""
    pos_enc = positional_encoding(points, 8)
    normals = safe_normalize(normals)
    v = safe_normalize(view_out_dirs)
    refl = torch.sum(v * normals, -1, keepdim=True) * normals * 2 - v
    dir_enc = integrated_dir_encoding(refl, 0.0, 5)
    # under the bf16 estimator policy the 4x256 MLP's products take
    # bf16-rounded operands (float32 result; see mlp.apply_linear_mixed)
    dd = torch.bfloat16 if cfg.estimator_dtype == 'bf16' else None
    return mlp.apply_predictor(
        params['inner_light'], torch.cat([pos_enc, dir_enc], -1),
        'exp', cfg.inner_light_exp_max, dot_dtype=dd)


def predict_outer_lights(params, cfg: MCShadingConfig, points, directions):
    """(ref: fields.py:913-933)"""
    if cfg.outer_light_version == 'envlight':
        return light_mod.direct_light(params['outer_light'], directions)
    enc = integrated_dir_encoding(directions, 0.0, 5)
    if cfg.outer_light_version == 'sphere_direction':
        # the point pulled inside the unit sphere, then where its ray
        # leaves that sphere (a true division: a Python scalar over a
        # tensor is a reciprocal and a product in PyTorch, one rounding
        # more than the reference)
        norm = torch.clamp(torch.linalg.norm(points, dim=-1, keepdim=True),
                           min=1e-8)
        pts = points * torch.clamp(torch.full_like(norm, 0.999) / norm,
                                   max=1.0)
        sphere_pts = pts + directions * get_sphere_intersection(
            pts, directions)
        enc = torch.cat([enc, integrated_dir_encoding(sphere_pts, 0.0, 5)],
                        -1)
    elif cfg.outer_light_version != 'direction':
        raise NotImplementedError(cfg.outer_light_version)
    return mlp.apply_predictor(params['outer_light'], enc, 'exp',
                               cfg.light_exp_max)


def get_human_light(params, points, directions, human_poses):
    """Photographer reflection estimate on the camera plane
    (ref: fields.py:935-949).  points, directions [..., 3]; human_poses as
    get_camera_plane_intersection takes them.  Returns (light [..., 3],
    blend weight [..., 1])."""
    inter, dists, hits = get_camera_plane_intersection(points, directions,
                                                       human_poses)
    mean = inter[..., :2] * 0.3
    hits = hits & (torch.linalg.norm(mean, dim=-1) < 1.5) & (dists > 0)
    hits_f = hits.to(points.dtype)[..., None]
    mean = mean * hits_f
    enc = integrated_positional_encoding(mean, torch.zeros_like(mean), 0, 6)
    hl = mlp.apply_predictor(params['human_light'], enc, 'exp', 5.0) * hits_f
    return hl[..., :3], torch.clamp(hl[..., 3:], 0.0, 1.0)


def _near_masked(lights, depth, eps):
    return lights * (depth > eps).to(lights.dtype)


def get_lights(params, cfg: MCShadingConfig, grid, unit_size, points,
               directions, human_poses=None, normals=None, stats=None,
               mesh=None):
    """Secondary-ray radiance for a dense [pn, sn, 3] direction set
    (ref: fields.py:951-975).

    grid: a PackedSDFGrid or SDFGrid, or a callable ``(o, d) -> (inters,
    normals, depth, hit)`` that owns all origin offsets (exact tracer hook
    for analytic tests).  normals: optional [pn,3] launch-surface normals;
    when given, trace origins are lifted ~1.5 mid cells along the normal
    (in addition to the reference's 2*unit_size ray offset,
    materialRenderer.py:223): an SDF *grid* cannot separate a tangent ray
    from its own launch surface as an exact-mesh BVH does.  The normals
    also drive the analytic launch-corridor certification of the budgeted
    trace.  With an active ``mesh`` the points are this rank's slice of
    the global batch: the slot budgets come from the global ray count,
    each slot is held by the rank the global compaction gives it, and the
    trace rates are global.  Returns (lights [pn,sn,3], hit_mask
    [pn,sn])."""
    shape = points.shape[:-1]
    eps = 1e-5
    o = (points + directions * eps).reshape(-1, 3)
    d = directions.reshape(-1, 3)
    n_rays = o.shape[0]
    if sharding.active(mesh):
        n_rays = n_rays * mesh.size

    with span('tf.lights'):
        outer = predict_outer_lights(params, cfg, o, d)
        if cfg.human_lights and human_poses is not None:
            # one pose [3,4] per point serves its rays: [pn, sn, 3] rays
            # against [pn, 3, 4] poses in a batched product, never a
            # [pn * sn, 3, 4] copy
            hl, hw = get_human_light(params, o.view(shape + (3,)),
                                     d.view(shape + (3,)), human_poses)
            outer = outer * (1.0 - hw.reshape(-1, 1)) \
                + (hl * hw).reshape(-1, 3)

    if callable(grid):
        with torch.no_grad():
            inters, t_normals, depth, hit = grid(o.detach(), d.detach())
        inner = get_inner_lights(params, cfg, inters, -d, t_normals)
        lights = _near_masked(torch.where(hit[:, None], inner, outer),
                              depth, eps)
        return lights.reshape(*shape, 3), hit.reshape(shape)

    packed = isinstance(grid, sdf_trace.PackedSDFGrid)
    budgeted = packed and 0.0 < cfg.secondary_budget < 1.0
    with span('tf.sec_trace'), torch.no_grad():
        d_ng = d.detach()
        o_trace = o.detach() + 2.0 * unit_size * d_ng
        h0 = None
        if normals is not None:
            ext = torch.mean(grid.aabb[1] - grid.aabb[0])
            if packed:
                m_cell = ext / (grid.mid_rows.shape[0] - 1)
            else:
                m_cell = ext / grid.resolution
            nrm = normals.detach()[:, None, :].expand(
                shape + (3,)).reshape(-1, 3)
            o_trace = o_trace + 1.5 * m_cell * nrm
            h0 = torch.sum(d_ng * nrm, -1)
        if budgeted:
            # budgeted trace: dense launch certification + ONE shared
            # compaction for trace refinement AND the inner-light MLP
            m = sdf_trace.budget_slots(n_rays, cfg.secondary_budget)
            vis_rows = None
            # per-point cache rows are only sound when the bake reserved
            # an apex pad covering the 2*unit_size ray-direction offset
            # (the trace itself falls back to per-ray rows otherwise)
            pad_ok = (isinstance(unit_size, (int, float))
                      and 2.0 * float(unit_size) <= grid.vis_pad + 1e-9)
            if (grid.vis_rows is not None and normals is not None
                    and points.ndim == 3 and pad_ok
                    and 0.0 < cfg.a1_budget < 1.0):
                # ONE visibility-cache row per surface point: all of a
                # point's sn rays share the launch cell
                rv = grid.vis_rows.shape[0]
                lo_g, hi_g = grid.aabb[0], grid.aabb[1]
                base = points.detach()[:, 0, :] \
                    + 1.5 * m_cell * normals.detach()
                u01 = torch.clamp((base - lo_g) / (hi_g - lo_g), 0.0, 1.0)
                ci = torch.clamp(torch.round(u01 * (rv - 1)).long(),
                                 0, rv - 1)
                flat_i = (ci[:, 0] * rv + ci[:, 1]) * rv + ci[:, 2]
                vis_rows = torch.index_select(
                    grid.vis_rows.reshape(-1, 8), 0,
                    torch.clamp(flat_i, 0, rv ** 3 - 1))        # [pn,8]
            res = sdf_trace.sphere_trace_budget(
                grid, o_trace, d_ng, m, h0=h0, a1_budget=cfg.a1_budget,
                vis_rows_flat=vis_rows, mesh=mesh)
            hit_slots = res.hit_m & res.slot_mask
            if stats is not None:
                # diagnostics for the trainer's adaptive budget: device
                # scalars, read by the host at its log/adapt cadence
                counts = sharding.global_sum(mesh, torch.stack([
                    torch.sum(res.cand.float()),
                    torch.sum(hit_slots.float()),
                    torch.sum(res.a1_need.float())])) / n_rays
                stats['secondary_cand_rate'], stats['secondary_hit_rate'], \
                    stats['secondary_a1_rate'] = counts.unbind(0)
        else:
            # dense fallback: trace every ray at full fidelity
            inters, t_normals, depth, hit = sdf_trace.sphere_trace(
                grid, o_trace, d_ng)

    if budgeted:
        with span('tf.lights'):
            if 0.0 < cfg.inner_light_budget < 1.0:
                # second compaction: the 4x256 inner-light MLP only runs
                # on HIT slots; overflow beyond the hit budget falls back
                # to the outer light (visibility stays exact, only the
                # light value degrades)
                m2 = sdf_trace.budget_slots(
                    n_rays, min(cfg.inner_light_budget,
                                cfg.secondary_budget))
                src2, mask2, dest2 = compact_indices_mesh(hit_slots, m2,
                                                          mesh)
                m2 = src2.shape[0]
                pay = torch.cat([res.inters, res.view_out, res.normals], -1)
                pm2 = compact_take(pay, src2, dest2, mask2)
                inner2 = get_inner_lights(params, cfg, pm2[:, 0:3],
                                          pm2[:, 3:6], pm2[:, 6:9])
                inner_m = scatter_back(inner2, dest2, src=src2,
                                       slot_mask=mask2)
                use_inner_m = hit_slots & (dest2 < m2)
            else:
                inner_m = get_inner_lights(params, cfg, res.inters,
                                           res.view_out, res.normals)
                use_inner_m = res.hit_m
        with span('tf.sec_trace'):
            # ONE wide expansion for lights + depth + hit
            payload_m = torch.cat(
                [inner_m, res.depth_m[:, None],
                 res.hit_m[:, None].to(inner_m.dtype),
                 use_inner_m[:, None].to(inner_m.dtype)], -1)
            full = scatter_back(payload_m, res.dest, src=res.src,
                                slot_mask=res.slot_mask)
            hit = full[:, 4] > 0.5              # overflow/miss -> fill 0
            depth = torch.where(hit, full[:, 3], torch.full_like(
                full[:, 3], sdf_trace.MISS_DEPTH))[:, None].detach()
            lights = torch.where(full[:, 5:6] > 0.5, full[:, 0:3], outer)
            lights = _near_masked(lights, depth, eps)
        return lights.reshape(*shape, 3), hit.reshape(shape)

    with span('tf.lights'):
        if 0.0 < cfg.inner_light_budget < 1.0:
            # compact hit rays before the inner-light MLP; overflow beyond
            # the budget falls back to the outer light
            src, slot_mask, dest = compact_indices_mesh(
                hit, max(int(n_rays * cfg.inner_light_budget), 1), mesh)
            m = src.shape[0]
            payload = torch.cat([inters, -d, t_normals], dim=-1)
            pm = compact_take(payload, src, dest, slot_mask)
            inner_m = get_inner_lights(params, cfg, pm[:, 0:3], pm[:, 3:6],
                                       pm[:, 6:9])
            inner = scatter_back(inner_m, dest, src=src,
                                 slot_mask=slot_mask)
            lights = torch.where((hit & (dest < m))[:, None], inner, outer)
        else:
            inner = get_inner_lights(params, cfg, inters, -d, t_normals)
            lights = torch.where(hit[:, None], inner, outer)
        lights = _near_masked(lights, depth, eps)
    return lights.reshape(*shape, 3), hit.reshape(shape)


# ---------------------------------------------------------------------------
# the mixed-estimator shader (ref: fields.py:1075-1335)
# ---------------------------------------------------------------------------

class ShadePhase(NamedTuple):
    """Phase flags, derived from the step on the host (ref gates at
    fields.py:1082,1160,1257,1295)."""
    nis_sample_diffuse: bool = False
    nis_sample_specular: bool = False
    nis_loss_diffuse: bool = False
    nis_loss_specular: bool = False


def _prior_noise(gen, cfg: MCShadingConfig, pn: int, sn: int, device):
    """A flow prior's draw: realnvp's standard normals [pn, sn, 2], else
    the lattice prior's azimuth roll [pn, sn, 1]."""
    if cfg.flow_type == 'realnvp':
        return torch.randn((pn, sn, 2), generator=gen, device=device)
    return torch.rand((pn, sn, 1), generator=gen, device=device)


def draw_shade_noise(gen: torch.Generator, cfg: MCShadingConfig, pn: int,
                     phase: ShadePhase, device) -> Dict[str, torch.Tensor]:
    """The draws one training call of the shader consumes.  shade_mixed:
    the flow priors' draws (when the phase samples from a flow copy) and
    the analytic samplers' azimuth rolls [pn, 1, 1].  shade_mixed_all: the
    combined flow's prior draw, then its azimuth roll (the reference's
    k_f, k_a)."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    noise = {}
    if cfg.shade_fn == 'shade_mixed_all':
        if phase.nis_sample_diffuse:
            noise['flow_all'] = _prior_noise(gen, cfg, pn,
                                             cfg.nis_sample_num, device)
        if cfg.random_azimuth:
            noise['az_all'] = u(pn, 1, 1)
        return noise
    if phase.nis_sample_diffuse:
        noise['flow_diffuse'] = _prior_noise(
            gen, cfg, pn, cfg.nis_diffuse_sample_num, device)
    if phase.nis_sample_specular:
        noise['flow_specular'] = _prior_noise(
            gen, cfg, pn, cfg.nis_specular_sample_num, device)
    if cfg.random_azimuth:
        noise['az_diffuse'] = u(pn, 1, 1)
        if not phase.nis_sample_specular:
            noise['az_specular'] = u(pn, 1, 1)
    return noise


def draw_eval_noise(gen: torch.Generator, cfg: MCShadingConfig, pn: int,
                    device) -> Dict[str, torch.Tensor]:
    """The draws of an evaluation's ``_nis`` pass (both flow copies
    sampled): none for the lattice prior, which rolls only while training;
    realnvp's Gaussian prior draws its normals at evaluation too, as in
    the reference."""
    if cfg.flow_type != 'realnvp':
        return {}
    if cfg.shade_fn == 'shade_mixed_all':
        return {'flow_all': _prior_noise(gen, cfg, pn, cfg.nis_sample_num,
                                         device)}
    return {'flow_diffuse': _prior_noise(gen, cfg, pn,
                                         cfg.nis_diffuse_sample_num, device),
            'flow_specular': _prior_noise(
                gen, cfg, pn, cfg.nis_specular_sample_num, device)}


def _flow_sample_halfvec(flow_params, fcfg, pts, aabb, view_angles01,
                         roughness, normals, view_dirs, sn, train, draw):
    """Draw sn half-vector samples from a (frozen) flow and convert them
    to outgoing directions + solid-angle pdf (ref: fields.py:1084-1113).
    draw: the prior's draw (_prior_noise); a lattice prior without one
    takes no roll."""
    if fcfg.flow_type != 'realnvp':
        train = train and draw is not None
    angles01, logq = flow_mod.flow_sample(
        flow_params, fcfg, None, pts, aabb, view_angles01, roughness, sn,
        train=train, noise=draw)
    angles_half = torch.cat(
        [angles01[..., :1] * (2 * math.pi),
         angles01[..., 1:2] * (0.5 * math.pi)], -1)
    dirs, angles, hov, theta = half_angles_to_directions(
        angles_half, normals, view_dirs)
    # flow_sample returns -log q; the reference exponentiates -logqx
    prob = torch.exp(-torch.clamp(logq, -8.0, 8.0)) / torch.clamp(
        4.0 * math.pi ** 2 * hov * torch.sin(theta), min=EPS)
    return dirs, angles, prob, angles_half, hov


def _split_noise(noise, is_train: bool):
    """(flow-prior draws, azimuth rolls): the rolls only while training."""
    noise = noise or {}
    az = {k: v for k, v in noise.items() if k.startswith('az_')} \
        if is_train else {}
    return {k: v for k, v in noise.items() if k.startswith('flow_')}, az


def _view_angles01(normals, view_dirs):
    view_angles = direction_to_angle(normals, view_dirs[:, None, :])[:, 0]
    return view_angles / device_constant(
        'view_angle_scale', lambda: [2 * np.pi, 0.5 * np.pi],
        view_angles.device, view_angles.dtype)


def _halfvec_x(half):
    """Half-vector angles -> the flow's unit-square coordinates."""
    return torch.clamp(torch.cat(
        [half[..., 0:1] / (2 * math.pi),
         half[..., 1:2] / (0.5 * math.pi)], -1), EPS, 1 - EPS)


def shade_mixed(params, cfg: MCShadingConfig, grid, unit_size, aabb,
                pts, normals, view_dirs, metallic, roughness, albedo,
                phase: ShadePhase, noise: Optional[Dict[str, Any]],
                is_train: bool, flow_diffuse_copy=None,
                flow_specular_copy=None, human_poses=None, mesh=None):
    """The MC estimator (ref: fields.py:1075-1335), dense and masked.

    noise: draw_shade_noise's dict (None or missing keys: no roll, as at
    eval; an evaluation takes only draw_eval_noise's flow-prior draws).
    mesh: on an active mesh the points are this rank's shard; the trace
    budgets, the variances and the NIS losses' means are global (the
    losses this rank's shares).  Returns (colors [pn,3], outputs dict)."""
    noise, az = _split_noise(noise, is_train)
    fcfg = cfg.flow
    f32 = torch.float32
    dev = pts.device

    view_angles01 = _view_angles01(normals, view_dirs)

    # ---------------- diffuse sampling ----------------
    dtable = direction_table(cfg.diffuse_sample_num, dev)
    d_dirs2, _, d_prob2, d_half2 = sample_diffuse_directions(
        dtable, normals, view_dirs, az.get('az_diffuse'))
    if phase.nis_sample_diffuse:
        with span('tf.flow'):
            d_dirs1, _, d_prob1, d_half1, _ = _flow_sample_halfvec(
                flow_diffuse_copy, fcfg, pts, aabb, view_angles01,
                roughness, normals, view_dirs, cfg.nis_diffuse_sample_num,
                is_train, noise.get('flow_diffuse'))
        diffuse_dirs = torch.cat([d_dirs1, d_dirs2], 1)
        diffuse_prob = torch.cat([d_prob1, d_prob2], 1)
        diffuse_half = torch.cat([d_half1, d_half2], 1)
    else:
        diffuse_dirs, diffuse_prob, diffuse_half = d_dirs2, d_prob2, d_half2

    h_diff = safe_normalize(view_dirs[:, None, :] + diffuse_dirs)
    hov_diff = saturate_dot(h_diff, view_dirs[:, None, :])

    # ---------------- specular sampling ----------------
    # unlike the diffuse branch (flow + analytic CONCAT, ref
    # fields.py:1115-1120), the reference REPLACES the analytic GGX samples
    # with the flow samples when the specular flow copy is live
    # (ref fields.py:1160-1206)
    if phase.nis_sample_specular:
        with span('tf.flow'):
            spec_dirs, _, spec_prob, spec_half, _ = _flow_sample_halfvec(
                flow_specular_copy, fcfg, pts, aabb, view_angles01,
                roughness, normals, view_dirs,
                cfg.nis_specular_sample_num, is_train,
                noise.get('flow_specular'))
    else:
        stable = direction_table(cfg.specular_sample_num, dev)
        spec_dirs, _, spec_prob, spec_half = sample_specular_directions(
            stable, normals, view_dirs, roughness, az.get('az_specular'))
    spec_num = spec_dirs.shape[1]

    # estimator-chain dtype (MCShadingConfig.estimator_dtype): the wide
    # [pn,sn,3] BRDF/light elementwise math below runs in `cdt`; every
    # samples-axis reduction accumulates in float32 and the NIS/flow log
    # math stays float32
    cdt = torch.bfloat16 if cfg.estimator_dtype == 'bf16' else pts.dtype
    nc = normals.to(cdt)
    vc = view_dirs.to(cdt)
    dd_c = diffuse_dirs.to(cdt)
    sd_c = spec_dirs.to(cdt)
    met_c = metallic.to(cdt)
    alb_c = albedo.to(cdt)
    rough_c = roughness.to(cdt)
    kd = 1.0 - met_c[:, None, :]

    # dense NoL>0 mask replaces compaction (ref: fields.py:1209-1214)
    spec_mask = torch.sum(spec_dirs * normals[:, None, :], -1) > 0
    spec_mask_f = spec_mask[..., None].to(cdt)

    f0 = 0.04 * (1.0 - met_c) + met_c * alb_c
    # the half vector + hov stay float32: hov feeds the NIS log densities
    h_spec = safe_normalize(view_dirs[:, None, :] + spec_dirs)
    hov_spec = saturate_dot(h_spec, view_dirs[:, None, :])
    fresnel = fresnel_schlick(f0[:, None, :], hov_spec.to(cdt))
    nov = saturate_dot(nc, vc)[:, None, :]
    nol = saturate_dot(nc[:, None, :], sd_c)
    geom = brdf_geometry(nov, nol, rough_c[:, None, :], cfg.geometry_type)
    # the GGX NDF stays float32: its denominator noh^2*(a2-1)+1 cancels
    # catastrophically in bf16 at low roughness
    noh = saturate_dot(normals[:, None, :], h_spec)
    dist = distribution_ggx(noh, roughness[:, None, :]).to(cdt)

    # ONE batched secondary-ray pass for diffuse + specular
    dn = diffuse_dirs.shape[1]
    all_dirs = torch.cat([diffuse_dirs, spec_dirs], 1)
    trace_stats: Dict[str, Any] = {}
    all_lights, all_hit = get_lights(
        params, cfg, grid, unit_size,
        pts[:, None, :].expand(all_dirs.shape), all_dirs, human_poses,
        normals=normals, stats=trace_stats, mesh=mesh)
    diffuse_lights = all_lights[:, :dn]
    spec_lights = all_lights[:, dn:]
    light_hit = all_hit[:, dn:]

    dl_c = diffuse_lights.to(cdt)
    sl_c = spec_lights.to(cdt)
    dp_c = torch.clamp(diffuse_prob, min=EPS).to(cdt)
    sp_c = torch.clamp(spec_prob, min=EPS).to(cdt)

    diffuse_weights = (alb_c[:, None, :] * kd
                       * (saturate_dot(dd_c, nc[:, None, :]) / math.pi))
    diffuse_colors = torch.mean(diffuse_weights * dl_c / dp_c, 1, dtype=f32)

    spec_weights = dist * fresnel * geom / torch.clamp(4.0 * nov, min=EPS)
    specular_colors = torch.sum(
        spec_mask_f * spec_weights * sl_c / sp_c, 1, dtype=f32) / spec_num

    colors = linear_to_srgb(diffuse_colors + specular_colors)

    light_hit_f = light_hit[..., None].to(cdt) * spec_mask_f
    visibility = 1.0 - torch.sum(light_hit_f, 1, dtype=f32) / spec_num
    indirect_light = torch.sum(sl_c * light_hit_f, 1, dtype=f32) / spec_num
    specular_light = torch.sum(sl_c * spec_mask_f, 1, dtype=f32) / spec_num

    outputs: Dict[str, Any] = {
        'albedo': albedo,
        'normal': (normals + 1.0) / 2.0,
        'roughness': roughness,
        'metallic': metallic,
        'diffuse_light': torch.clamp(
            linear_to_srgb(torch.mean(diffuse_lights, 1)), 0, 1),
        'specular_light': torch.clamp(linear_to_srgb(specular_light), 0, 1),
        'diffuse_color': torch.clamp(linear_to_srgb(diffuse_colors), 0, 1),
        'specular_color': torch.clamp(linear_to_srgb(specular_colors), 0, 1),
        'visibility': visibility,
        'indirect_light': indirect_light,
        **trace_stats,
    }
    # (ref: fields.py:1248: the reference adds the already-srgb'd specular
    # color inside the srgb transform; replicated as-is)
    outputs['approximate_light'] = torch.clamp(
        linear_to_srgb(torch.mean(kd * dl_c, 1, dtype=f32)
                       + outputs['specular_color']), 0, 1)

    # ---------------- NIS losses (ref: fields.py:1254-1333) ----------------
    fx_d = diffuse_weights * dl_c
    outputs['variance'] = sharding.global_var(
        mesh, torch.mean(fx_d, -1, keepdim=True, dtype=f32)
        / torch.clamp(diffuse_prob, min=EPS))

    zero = torch.zeros((), dtype=f32, device=dev)
    if phase.nis_loss_diffuse and cfg.use_nis_diffuse:
        sn = cfg.nis_diffuse_sample_num
        theta = diffuse_half[:, :sn, 1:2]
        with span('tf.flow'):
            _, logqx_ = flow_mod.flow_log_density(
                params['flow_diffuse'], fcfg, pts, aabb, view_angles01,
                roughness, _halfvec_x(diffuse_half[:, :sn]))
        logqx = logqx_ - torch.log(torch.clamp(
            4 * math.pi ** 2 * hov_diff[:, :sn] * torch.sin(theta),
            min=EPS))
        fx = fx_d[:, :sn].float()
        dp = torch.clamp(diffuse_prob[:, :sn], min=EPS)
        outputs['loss_nis_diffuse'] = -sharding.mean_share(
            mesh, fx * logqx / dp)
    else:
        outputs['loss_nis_diffuse'] = zero

    fx_s = spec_weights * sl_c
    outputs['variance_specular'] = sharding.global_var(
        mesh, torch.mean(fx_s, -1, keepdim=True, dtype=f32)
        / torch.clamp(spec_prob, min=EPS))

    if phase.nis_loss_specular and cfg.use_nis_specular:
        theta = spec_half[..., 1:2]
        with span('tf.flow'):
            _, logqx_ = flow_mod.flow_log_density(
                params['flow_specular'], fcfg, pts, aabb, view_angles01,
                roughness, _halfvec_x(spec_half))
        logqx = logqx_ - torch.log(torch.clamp(
            4 * math.pi ** 2 * hov_spec * torch.sin(theta), min=EPS))
        sp = torch.clamp(spec_prob, min=EPS)
        term = fx_s.float() * logqx / sp * spec_mask[..., None].float()
        denom = torch.clamp(sharding.global_sum(
            mesh, torch.sum(spec_mask.float())) * 3.0, min=1.0)
        outputs['loss_nis_specular'] = -torch.sum(term) / denom
    else:
        outputs['loss_nis_specular'] = zero

    outputs['loss_nis'] = (outputs['loss_nis_diffuse']
                           + outputs['loss_nis_specular'])
    return colors, outputs


def shade_mixed_all(params, cfg: MCShadingConfig, grid, unit_size, aabb,
                    pts, normals, view_dirs, metallic, roughness, albedo,
                    phase: ShadePhase, noise: Optional[Dict[str, Any]],
                    is_train: bool, flow_all_copy=None, human_poses=None,
                    mesh=None):
    """Single-flow combined estimator (ref: fields.py:1337-1451): ONE
    direction set drives both the diffuse and the specular lobe, with the
    combined flow copy's samples in front once it exists.  noise:
    draw_shade_noise's 'flow_all' / 'az_all'.  Its NIS loss is the mean
    over all samples (not masked as shade_mixed's specular one), and
    diffuse_light / specular_light are the same image.  mesh: see
    shade_mixed."""
    noise, az = _split_noise(noise, is_train)
    fcfg = cfg.flow
    f32 = torch.float32
    view_angles01 = _view_angles01(normals, view_dirs)

    dtable = direction_table(cfg.diffuse_sample_num, pts.device)
    dirs2, _, prob2, half2 = sample_diffuse_directions(
        dtable, normals, view_dirs, az.get('az_all'))
    if phase.nis_sample_diffuse and flow_all_copy is not None:
        with span('tf.flow'):
            dirs1, _, prob1, half1, _ = _flow_sample_halfvec(
                flow_all_copy, fcfg, pts, aabb, view_angles01, roughness,
                normals, view_dirs, cfg.nis_sample_num, is_train,
                noise.get('flow_all'))
        directions = torch.cat([dirs1, dirs2], 1)
        prob = torch.cat([prob1, prob2], 1)
        angles_half = torch.cat([half1, half2], 1)
    else:
        directions, prob, angles_half = dirs2, prob2, half2

    lights, light_hit = get_lights(
        params, cfg, grid, unit_size, pts[:, None, :].expand(
            directions.shape), directions, human_poses, normals=normals,
        mesh=mesh)

    # estimator-chain dtype: the policy of shade_mixed
    cdt = torch.bfloat16 if cfg.estimator_dtype == 'bf16' else pts.dtype
    nc = normals.to(cdt)
    vc = view_dirs.to(cdt)
    dirs_c = directions.to(cdt)
    met_c = metallic.to(cdt)
    alb_c = albedo.to(cdt)
    rough_c = roughness.to(cdt)
    lights_c = lights.to(cdt)
    prob_c = torch.clamp(prob, min=EPS).to(cdt)

    kd = 1.0 - met_c[:, None, :]
    diffuse_w = (alb_c[:, None, :] * kd
                 * (saturate_dot(dirs_c, nc[:, None, :]) / math.pi))
    diffuse_colors = torch.mean(diffuse_w * lights_c / prob_c, 1, dtype=f32)

    f0 = 0.04 * (1.0 - met_c) + met_c * alb_c
    h = safe_normalize(view_dirs[:, None, :] + directions)
    hov = saturate_dot(h, view_dirs[:, None, :])
    fresnel = fresnel_schlick(f0[:, None, :], hov.to(cdt))
    nov = saturate_dot(nc, vc)[:, None, :]
    nol = saturate_dot(nc[:, None, :], dirs_c)
    geom = brdf_geometry(nov, nol, rough_c[:, None, :], cfg.geometry_type)
    # the GGX NDF stays float32 (see shade_mixed)
    noh = saturate_dot(normals[:, None, :], h)
    dist = distribution_ggx(noh, roughness[:, None, :]).to(cdt)
    spec_w = dist * fresnel * geom / torch.clamp(4.0 * nov, min=EPS)
    specular_colors = torch.mean(spec_w * lights_c / prob_c, 1, dtype=f32)

    colors = linear_to_srgb(diffuse_colors + specular_colors)
    light_hit_f = light_hit[..., None].to(cdt)
    mean_light = torch.clamp(linear_to_srgb(torch.mean(lights, 1)), 0, 1)
    outputs: Dict[str, Any] = {
        'albedo': albedo,
        'normal': (normals + 1.0) / 2.0,
        'roughness': roughness,
        'metallic': metallic,
        'diffuse_light': mean_light,
        'specular_light': mean_light,
        'diffuse_color': torch.clamp(linear_to_srgb(diffuse_colors), 0, 1),
        'specular_color': torch.clamp(linear_to_srgb(specular_colors), 0, 1),
        'visibility': 1.0 - torch.mean(light_hit_f, 1, dtype=f32),
        'indirect_light': torch.mean(lights_c * light_hit_f, 1, dtype=f32),
    }
    outputs['approximate_light'] = torch.clamp(
        linear_to_srgb(torch.mean(kd * lights_c, 1, dtype=f32)
                       + outputs['specular_color']), 0, 1)

    fx = (diffuse_w + spec_w) * lights_c
    outputs['variance'] = sharding.global_var(
        mesh, torch.mean(fx, -1, keepdim=True, dtype=f32)
        / torch.clamp(prob, min=EPS))
    if (phase.nis_loss_diffuse or phase.nis_loss_specular) \
            and cfg.use_nis_all:
        theta = angles_half[..., 1:2]
        with span('tf.flow'):
            _, logqx_ = flow_mod.flow_log_density(
                params['flow_all'], fcfg, pts, aabb, view_angles01,
                roughness, _halfvec_x(angles_half))
        logqx = logqx_ - torch.log(torch.clamp(
            4 * math.pi ** 2 * hov * torch.sin(theta), min=EPS))
        outputs['loss_nis'] = -sharding.mean_share(
            mesh, fx.float() * logqx / torch.clamp(prob, min=EPS))
    else:
        outputs['loss_nis'] = torch.zeros((), dtype=f32, device=pts.device)
    return colors, outputs


def mc_forward(params, cfg: MCShadingConfig, grid, unit_size, aabb, pts,
               view_dirs, normals, phase: ShadePhase, noise, is_train: bool,
               flow_diffuse_copy=None, flow_specular_copy=None,
               human_poses=None, mesh=None):
    """Full shade: materials + the estimator that ``cfg.shade_fn`` names
    (ref: fields.py:1453-1473); shade_mixed_all takes its combined flow's
    copy from the diffuse-copy slot.  noise, mesh: see shade_mixed."""
    view_dirs = safe_normalize(view_dirs)
    normals = safe_normalize(normals)
    with span('tf.mat_field'):
        metallic, roughness, albedo = predict_materials(params, cfg, pts,
                                                        aabb)
    if cfg.shade_fn == 'shade_mixed_all':
        colors, outputs = shade_mixed_all(
            params, cfg, grid, unit_size, aabb, pts, normals, view_dirs,
            metallic, roughness, albedo, phase, noise, is_train,
            flow_all_copy=flow_diffuse_copy, human_poses=human_poses,
            mesh=mesh)
    else:
        colors, outputs = shade_mixed(
            params, cfg, grid, unit_size, aabb, pts, normals, view_dirs,
            metallic, roughness, albedo, phase, noise, is_train,
            flow_diffuse_copy, flow_specular_copy, human_poses, mesh)
    outputs['rgb_pr'] = colors
    return outputs


# ---------------------------------------------------------------------------
# regularization (ref: fields.py:1547-1578)
# ---------------------------------------------------------------------------

def material_regularization(params, cfg: MCShadingConfig, pts, normals,
                            metallic, roughness, albedo,
                            reg_minmax_on: float, mesh=None):
    """TV on the material field (+ early saturation clamps, gated by
    reg_minmax_on = 1.0 while step < 2000: a float, or a 0-d tensor under
    the trainer's CUDA graph).  On an active mesh this rank's share: the
    TV of the replicated field counts on rank 0 only, the clamps sum this
    rank's points."""
    own = 0.0 if sharding.active(mesh) and not mesh.is_main else 1.0
    reg = tfield.tv_loss_vm(params['mat_field']) * (0.1 * own)
    if cfg.reg_min_max:
        clamp = (torch.sum(torch.relu(roughness - 0.9 ** 2))
                 + torch.sum(torch.relu(0.1 ** 2 - roughness))
                 + torch.sum(torch.relu(metallic - 0.98))
                 + torch.sum(torch.relu(0.02 - metallic)))
        reg = reg + clamp * reg_minmax_on
    return reg


def env_light_image(params, cfg: MCShadingConfig, h: int, w: int,
                    gamma: bool = True):
    """Rendered latlong map of the outer light [h, w, 3]
    (ref: fields.py:1475-1510)."""
    leaf = params['outer_light']
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) \
            else leaf[0]
    dev = leaf.device
    azs = device_constant(('env_az', w), lambda: xla_linspace(1.0, 0.0, w),
                          dev) * (np.pi * 2) - np.pi / 2
    els = device_constant(('env_el', h), lambda: xla_linspace(1.0, -1.0, h),
                          dev) * (np.pi / 2)
    els, azs = torch.meshgrid(els, azs, indexing='ij')
    dirs = torch.stack([torch.cos(els) * torch.cos(azs),
                        torch.cos(els) * torch.sin(azs), torch.sin(els)],
                       -1).reshape(-1, 3)
    light = predict_outer_lights(params, cfg, dirs, dirs)
    if gamma:
        light = linear_to_srgb(light)
    return light.reshape(h, w, 3)
