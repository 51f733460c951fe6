"""Trainable environment light (counterpart of tensoflow_tpu/fields/light.py):
a [6, R, R, 3] log-radiance cubemap, pre-filtered per step into a
specular mip chain and a cosine-convolved diffuse map.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from ..ops import cubemap as cm


class EnvLightConfig(NamedTuple):
    max_res: int = 128
    min_res: int = 16
    min_roughness: float = 0.08
    max_roughness: float = 0.5
    exact_ggx_max_res: int = 32   # exact GGX conv at/below this res


def init_env_light(cfg: EnvLightConfig, device='cpu') -> Dict[str, Any]:
    """log(0.5)-filled trainable cubemap (ref: light.py:22-26)."""
    return {'base': torch.full((6, cfg.max_res, cfg.max_res, 3),
                               float(np.log(0.5)), device=device)}


def build_mips(params, cfg: EnvLightConfig):
    """Per-step pre-filtering (ref: light.py:52-64); differentiable."""
    chain = cm.build_cubemap_pyramid(params['base'], cfg.min_res)
    diffuse = cm.diffuse_cubemap(chain[-1])
    n = len(chain)
    specular: List[torch.Tensor] = []
    for idx in range(n):
        if idx < n - 1:
            rough = (idx / max(n - 2, 1)) * (
                cfg.max_roughness - cfg.min_roughness) + cfg.min_roughness
        else:
            rough = 1.0
        lvl = chain[idx]
        if lvl.shape[1] <= cfg.exact_ggx_max_res:
            lvl = cm.specular_cubemap(lvl, rough)
        specular.append(lvl)
    spec_packed, offs, ress = cm.pack_cubemap_pyramid_patches(specular)
    return {'specular': specular, 'diffuse': diffuse,
            'spec_packed': spec_packed, 'spec_offsets': offs,
            'spec_res': ress,
            'diff_packed': cm.pack_cubemap_patches(diffuse)}


def get_mip(roughness, n_levels: int, cfg: EnvLightConfig):
    """roughness -> fractional mip level (ref: light.py:72-80)."""
    lo, hi = cfg.min_roughness, cfg.max_roughness
    below = (torch.clamp(roughness, lo, hi) - lo) / (hi - lo) * (n_levels - 2)
    above = (torch.clamp(roughness, hi, 1.0) - hi) / (1.0 - hi) + n_levels - 2
    return torch.where(roughness < hi, below, above)


def shade(mips, dirs, roughness=None,
          cfg: EnvLightConfig = EnvLightConfig()):
    """Pre-filtered lookup: dirs [N,3]; roughness [N,1] or None (diffuse).
    Returns linear radiance [N,3]."""
    if roughness is None:
        light = cm.sample_cubemap_packed(
            mips['diff_packed'], mips['diffuse'].shape[1], dirs)
    else:
        level = get_mip(roughness[:, 0], len(mips['specular']), cfg)
        light = cm.sample_cubemap_mip_packed(
            mips['spec_packed'], mips['spec_offsets'], mips['spec_res'],
            dirs, level)
    return torch.exp(light)


def direct_light(params, dirs):
    """Unfiltered base-cubemap lookup for the MC shader (ref:
    light.py:125-162): packs the base into patch rows per call, a few MB
    of slicing beside the shader's millions of lookups."""
    pbuf = cm.pack_cubemap_patches(params['base'])
    return torch.exp(cm.sample_cubemap_packed(pbuf, params['base'].shape[1],
                                              dirs))
