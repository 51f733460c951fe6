"""Operations and bytes of a ``shape_compressor`` training step, from the
configuration's widths and the step's row counts (frozen here: nothing
of the program is read).

``head_bytes_ops`` is the stencil head's least traffic and operations
for one forward and one backward call (the arithmetic chip_smoke.py
states for its kernel table, written out).  ``step_terms`` lists every
dense product of the step with its operations; all run in float32
(TF32 off), so each is held to the float32 peak.
"""
from __future__ import annotations

S = 7                      # stencil points
PE_FREQ_LIGHT = 8          # the shading's positional encoding of points
IDE_DIM = 72               # integrated directional encoding, degree 5
OCC_MARCH = 64 + 16        # SDF queries a ray of the occ-loss march
ENV_RES = (16, 32, 16)     # cubemaps convolved a step: diffuse 16^2,
#                            specular 32^2 and 16^2 (GGX at <= 32^2)


def widths(cfg):
    C, H, app = cfg['sdf_n_comp'], cfg['sdf_dim'], cfg['app_dim']
    E = 3 * (1 + 2 * cfg['sdf_multires'])
    return C, E, H, 1 + app


def head_bytes_ops(n, B, cfg, es=4):
    """((fwd bytes, fwd ops), (bwd bytes, bwd ops)) of the fused stencil
    head over ``n`` rows with ``B`` mip branches, float32 patches: 3 plane
    patches (4x4 texels) and 3 line patches (4 texels) a branch in, the
    saved tap variants out, the weights once."""
    C, E, H, O = widths(cfg)
    K = 3 * C + E
    v_bytes = n * (5 + 3) * 3 * C * es
    weights = (K * H + H * O) * es + H * 4
    fwd_in = 3 * B * n * 20 * C * es + n * 64 * 4 + n * E * es + weights
    fwd_out = n * O * 4 + (S - 1) * n * 4 + v_bytes
    fwd_ops = 2 * S * n * K * H + 2 * n * H * O + 2 * (S - 1) * n * H
    bwd_in = n * 64 * 4 + v_bytes + n * E * es + weights + n * O * 4 \
        + (S - 1) * n * 4
    bwd_out = 3 * B * n * 20 * C * es + n * E * 4 + (K * H + H * O + H) * 4
    bwd_ops = 3 * 2 * S * n * K * H + 2 * 2 * n * H * O \
        + 2 * 2 * (S - 1) * n * H
    return (fwd_in + fwd_out, fwd_ops), (bwd_in + bwd_out, bwd_ops)


def _mlp(rows, dims, input_grad):
    """fwd + bwd operations of a ReLU MLP over ``rows``: 2 r d_in d_out a
    layer forward, as much again for the weight gradient, and for the
    input gradient of every layer but a first whose input needs none."""
    fwd = sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))
    dx = sum(2 * rows * a * b for i, (a, b) in
             enumerate(zip(dims[:-1], dims[1:])) if i > 0 or input_grad)
    return fwd + fwd + dx


def head_rows(cfg):
    """Stencil rows a step: every [ray, sample] of the hierarchical
    sampler goes through the head."""
    return cfg['train_ray_num'] * (cfg['n_samples'] + cfg['n_importance'])


def step_terms_typed(cfg):
    """[(term, operations, precision)]: every product runs in float32."""
    return [(t, ops, 'float32') for t, ops in step_terms(cfg)]


def step_terms(cfg):
    """[(term, operations)] of one training step at the measured state
    (hierarchical sampler, radiance head and occ loss on)."""
    C, E, H, O = widths(cfg)
    K = 3 * C + E
    rays = cfg['train_ray_num']
    ups = cfg['up_sample_steps']
    n_dense = cfg['n_samples'] + cfg['n_importance']
    n = rays * n_dense
    (_, f_ops), (_, b_ops) = head_bytes_ops(n, 2, cfg)
    app = cfg['app_dim']
    pos = 3 * (1 + 2 * PE_FREQ_LIGHT)
    queries = rays * (cfg['n_samples']
                      + (ups - 1) * (cfg['n_importance'] // ups))
    occ_q = cfg['occ_loss_max_pn'] * OCC_MARCH
    terms = [
        ('stencil head fwd', f_ops),
        ('stencil head bwd', b_ops),
        ('sampler SDF queries (no grad)', queries * 2 * (K * H + H)),
        ('occ-loss march SDF queries (no grad)', occ_q * 2 * (K * H + H)),
        ('mat_mlp', _mlp(n, [app, 128, 128, 5], True)),
        ('rad_mlp', _mlp(n, [app + 3 + 27 + 3, 128, 128, 3], True)),
        ('inner_light', _mlp(n, [pos + IDE_DIM, 128, 128, 3], True)),
        ('inner_weight', _mlp(n, [pos + 39, 128, 128, 1], False)),
        ('IDE z-power product', 2 * 2 * n * 17 * 36),
    ]
    env = 0
    for r in ENV_RES:
        t = 6 * r * r
        # direction cosines, the weighted sum, its gradient to the map
        env += 2 * t * t * 3 + 2 * t * t * 3 + 2 * t * t * 3
    terms.append(('envlight convolutions', env))
    return terms
