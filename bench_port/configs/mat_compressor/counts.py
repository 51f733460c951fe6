"""Operations of a ``mat_compressor`` training step in its NIS-sampling
phase, from the configuration's widths (frozen here: nothing of the
program is read).

``step_terms_typed`` lists every dense product of the step with its
operations and the precision it runs in.  All run as float32 products
(TF32 off): the inner-light MLP's operands are rounded to bf16 and then
multiplied in float32, so it too is held to the float32 peak.  The
secondary trace, the flows' splines, the BRDF and the estimator are
elementwise or gathers and hold no product.
"""
from __future__ import annotations

PE_POS = 3 * (1 + 2 * 8)            # inner light: PE(8) of the hit point
IDE_DIM = 72                        # IDE degree 5
IDE_ROWS = 17                       # z powers 0..16 of the IDE
FLOW_FEAT_IN = 3 * 12 + 3 * 7       # flow field features + PE(3) of xyz
FLOW_HIDDEN = 64
FLOW_FEAT = 16
BLOCK_DIMS = [7 + 16 + 14 + 7, 64, 64, 64, 21]   # a coupling block's MLP
MAT_DIMS = [3 * 36, 128]           # a material predictor's hidden layer


def _mlp(rows, dims, input_grad, backward=True):
    """Operations of a ReLU MLP over ``rows``: 2 r d_in d_out a layer
    forward; backward as much again for the weight gradient, and for the
    input gradient of every layer but a first whose input needs none."""
    fwd = sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))
    if not backward:
        return fwd
    dx = sum(2 * rows * a * b for i, (a, b) in
             enumerate(zip(dims[:-1], dims[1:])) if i > 0 or input_grad)
    return fwd + fwd + dx


def _slots(n, budget):
    return max((int(n * budget) // 128) * 128, 128)


def secondary_rays(cfg, sh=None):
    """Secondary rays a step with both flow copies sampling: a hit ray
    each of the analytic and flow diffuse samples and of the specular
    flow samples (they replace the GGX ones)."""
    sh = sh or shader(cfg)
    return cfg['train_ray_num'] * (sh['diffuse_sample_num']
                                   + sh['nis_diffuse_sample_num']
                                   + sh['nis_specular_sample_num'])


def shader(cfg):
    """The shader widths: the release's defaults under the yaml's."""
    sh = {'diffuse_sample_num': 512, 'specular_sample_num': 256,
          'nis_diffuse_sample_num': 64, 'nis_specular_sample_num': 32,
          'inner_light_budget': 0.5, 'secondary_budget': 0.375}
    sh.update({k: v for k, v in (cfg.get('shader_cfg') or {}).items()
               if k in sh})
    return sh


def step_terms_typed(cfg):
    """[(term, operations, precision)]: every product runs in float32."""
    return [(t, ops, 'float32') for t, ops in step_terms(cfg)]


def step_terms(cfg):
    """[(term, operations)] of one training step with both flow copies
    sampling and the NIS loss on.  The inner-light MLP runs on every slot
    of its budget: min(inner_light_budget, secondary_budget) of the
    secondary rays, the budgets ``cfg`` holds (the system writes there
    those in force after its adaptation)."""
    sh = shader(cfg)
    pn = cfg['train_ray_num']
    nd, ns = sh['nis_diffuse_sample_num'], sh['nis_specular_sample_num']
    n = secondary_rays(cfg, sh)
    m2 = _slots(n, min(sh['inner_light_budget'], sh['secondary_budget']))
    cond = [FLOW_FEAT_IN, FLOW_HIDDEN, FLOW_FEAT]
    return [
        ('material predictors', 2 * _mlp(pn, MAT_DIMS + [1], True)
         + _mlp(pn, MAT_DIMS + [3], True)),
        ('flow conditioning, frozen copies (no grad)',
         2 * _mlp(pn, cond, False, backward=False)),
        ('flow conditioning, live flows', 2 * _mlp(pn, cond, True)),
        ('coupling blocks, sampling (no grad)',
         2 * _mlp(pn * (nd + ns), BLOCK_DIMS, False, backward=False)),
        ('coupling blocks, NIS densities', 2 * _mlp(pn * (nd + ns),
                                                    BLOCK_DIMS, True)),
        ('inner-light MLP', _mlp(m2, [PE_POS + IDE_DIM, 256, 256, 256, 3],
                                 False)),
        ('IDE z-power product', 2 * m2 * IDE_ROWS * (IDE_DIM // 2)),
    ]
