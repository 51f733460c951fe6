"""Config system of the PyTorch port: one flat dict, reference-compatible
YAML keys (a copy of tensoflow_tpu/config.py; the port imports nothing
of the JAX package).

The reference scatters defaults across class ``default_cfg`` dicts and
merges YAML + OmegaConf dotlists (ref: run_training.py:12-23,
trainer_inv.py:27-68).  Here all defaults live in one place, the same YAML
files load unchanged, and ``key=value`` dotlist overrides are supported
without OmegaConf.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import yaml

TRAINER_DEFAULTS: Dict[str, Any] = {
    # trainer (ref: trainer_inv.py:27-68)
    'optimizer_type': 'adam',
    'lr_xyz_init': 1e-2,
    'lr_net_init': 1e-3,
    'lr_env_init': 1e-2,
    'lr_decay_target_ratio': 5e-2,
    'lr_decay_iters': -1,
    'total_step': 200000,
    'train_log_step': 20,
    'val_interval': 10000,
    'test': False,
    'test_interval': 10000,
    'save_interval': 500,
    'random_seed': 6033,
    'isMaterial': False,
    'N_voxel_init': 2097152,
    'N_voxel_final': 64000000,
    'aabb': [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]],
    'step_ratio': 0.5,
    'alphaMask_thres': 0.0001,
    'sdf_n_comp': 16,
    'app_n_comp': 36,
    'sdf_dim': 128,
    'app_dim': 128,
    'upsample_list': None,
    'update_AlphaMask_lst': None,
    'hessian_update_list': None,
    'sparse_update_list': None,
    'has_radiance_field': False,
    'radiance_field_step': 0,
    'scratch': True,
    'ckpt_path': None,

    # shape renderer (ref: shapeRenderer.py:101-187)
    'std_act': 'exp',
    'inv_s_init': 0.3,
    'freeze_inv_s_step': None,
    'n_samples': 64,
    'n_importance': 64,
    'up_sample_steps': 4,
    'perturb': 1.0,
    'anneal_end': 50000,
    'train_ray_num': 1024,
    'test_ray_num': 2048,
    'clip_sample_variance': True,
    'database_name': 'toy/sphere',
    'dataset_dir': 'data',
    'test_downsample_ratio': True,
    'downsample_ratio': 0.25,
    'val_geometry': True,
    'rgb_loss': 'charbonier',
    'apply_occ_loss': True,
    'apply_tv_loss': True,
    'apply_sparse_loss': True,
    'apply_hessian_loss': True,
    'apply_gaussian_loss': False,
    'occ_loss_step': 20000,
    'occ_loss_max_pn': 2048,
    'occ_sdf_thresh': 0.01,
    'gaussianLoss_step': 20000,
    'fixed_camera': False,
    'sdf_multires': 3,
    'max_levels': 1,
    'predict_BG': False,
    'isBGWhite': True,
    'nerfDataType': False,
    'split_manul': False,
    'apply_mask_loss': False,
    'mul_length': 10,
    'use_occ_grid': False,
    'occ_grid_reso': 128,
    'occ_max_samples': 192,
    # no-prune warmup window for the occupancy grid (the reference passes
    # warmup_steps=10000 to nerfacc, shapeRenderer.py:1287): pruning
    # against the untrained field locks sampling away from the object
    'occ_warmup_steps': 10000,
    'compact_samples_per_ray': 64,
    'gather_dtype': 'float32',
    'stencil_impl': 'auto',
    'stencil_tile': 256,
    'blend_ratio': 0,

    # losses (ref: loss.py defaults)
    'eikonal_weight': 0.1,
    'eikonal_weight_anneal_begin': 0,
    'eikonal_weight_anneal_end': 0,
    'TV_weight_sdf': 0.1,
    'sparse_weight': 0.02,
    'sparse_ratio': [1.0, 1.0],
    'hessian_weight': 5e-4,
    'hessian_ratio': [1.0, 1.0],
    'gaussian_weight': 5e-4,
    'mask_loss_weight': 0.01,
    'nis_loss_weight': 0.0001,
    'apply_std_loss': False,
    'std_loss_weight': 0.05,

    # material renderer (ref: materialRenderer.py:99-133)
    'mesh': '',
    'geo_model_path': '',
    'reg_mat': True,
    'reg_diffuse_light': True,
    'reg_diffuse_light_lambda': 0.1,
    'shader_cfg': {},

    'loss': [],
    'val_metric': [],
    'key_metric_name': 'psnr',
    'name': 'run',
    'data_dir': 'data',
}


def _parse_value(v: str) -> Any:
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def apply_dotlist(cfg: Dict[str, Any], dotlist: List[str]) -> Dict[str, Any]:
    """``a.b=3`` style overrides (OmegaConf-compatible subset)."""
    for item in dotlist:
        key, _, val = item.partition('=')
        parts = key.split('.')
        d = cfg
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = _parse_value(val)
    return cfg


def load_config(path: Optional[str] = None,
                overrides: Optional[List[str]] = None,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    cfg = copy.deepcopy(TRAINER_DEFAULTS)
    if path is not None:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        cfg.update(loaded)
    if extra:
        cfg.update(extra)
    if overrides:
        apply_dotlist(cfg, overrides)
    # derived defaults (ref: trainer_inv.py:158-159)
    if cfg.get('hessian_update_list') is None:
        cfg['hessian_update_list'] = cfg.get('upsample_list')
    if cfg.get('sparse_update_list') is None:
        cfg['sparse_update_list'] = cfg.get('upsample_list')
    if cfg.get('lr_decay_iters', -1) < 0:
        cfg['lr_decay_iters'] = cfg['total_step']
    return cfg


def n_to_reso(n_voxels: int, aabb) -> List[int]:
    """(ref: trainer_inv.py:350-354)"""
    import numpy as np
    a = np.asarray(aabb, np.float64)
    xyz_min, xyz_max = a[0], a[1]
    voxel_size = ((xyz_max - xyz_min).prod() / n_voxels) ** (1 / 3)
    return [int(x) for x in (xyz_max - xyz_min) / voxel_size]


def voxel_schedule(cfg: Dict[str, Any]) -> List[int]:
    """Log-spaced N_voxel schedule (ref: trainer_inv.py:118-121)."""
    import numpy as np
    n = len(cfg['upsample_list']) + 1 if cfg.get('upsample_list') else 1
    return list(np.round(np.exp(np.linspace(
        np.log(cfg['N_voxel_init']), np.log(cfg['N_voxel_final']),
        n))).astype(np.int64))
