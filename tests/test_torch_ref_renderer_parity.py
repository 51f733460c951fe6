"""The torch-oracle renderer cases of tests/test_ref_renderer_parity.py,
run against the port: the fixtures of scripts/gen_ref_renderer_fixtures.py
pin the reference MCShadingNetwork.forward (tensorial material field,
predictors, the mixed MC estimator with deterministic Fibonacci
directions, exact-occluder visibility, the 'direction' outer light and the
inner light MLPs), outputs and gradients, without and with live NIS
flows.  Same cases, same tolerances as the JAX file; the weights go into
the port's parameter tree through a port-side _predictor_from_torch.
"""
import os

import numpy as np
import pytest
import torch

from tensoflow_tpu_torch.fields import flow as flow_mod
from tensoflow_tpu_torch.fields import mc_shading
from tensoflow_tpu_torch.ops.math import safe_normalize
from tensoflow_tpu_torch.ops.samplers import direction_to_angle

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), 'fixtures',
                   'ref_renderer.npz')
NIS_FIX = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'ref_renderer_nis.npz')
AABB = torch.tensor([[-1.0] * 3, [1.0] * 3])


@pytest.fixture(scope='module')
def fx():
    return dict(np.load(FIX))


@pytest.fixture(scope='module')
def nfx():
    return dict(np.load(NIS_FIX))


def _t(x):
    return torch.tensor(np.array(x, np.float32))


def _linear_from_torch(z, prefix, idx):
    """torch weight_norm Linear -> the port's {'v','g','b'} (dim-0 weight
    norm: v [in,out], g [out])."""
    v = z[f'{prefix}__{idx}_parametrizations_weight_original1']  # [out,in]
    g = z[f'{prefix}__{idx}_parametrizations_weight_original0']  # [out,1]
    return {'v': _t(v.T), 'g': _t(g[:, 0]),
            'b': _t(z[f'{prefix}__{idx}_bias'])}


def _predictor_from_torch(z, prefix, n_layers):
    return {'layers': [_linear_from_torch(z, prefix, 2 * i)
                       for i in range(n_layers)]}


def _mat_field(z):
    # reference plane [1,C,g0,g1] -> [g_m0, g_m1, C]; line [1,C,g,1] -> [g,C]
    return {'planes': [_t(np.transpose(z[f'w_plane{i}'][0], (2, 1, 0)))
                       for i in range(3)],
            'lines': [_t(z[f'w_line{i}'][0, :, :, 0].T) for i in range(3)]}


def _plain_linear(z, key):
    return {'w': _t(z[f'{key}_weight'].T), 'b': _t(z[f'{key}_bias'])}


def flow_params_from_torch(z, pre):
    field = {
        'planes': [_t(np.transpose(z[f'{pre}__nis_plane_{i}'][0], (2, 1, 0)))
                   for i in range(3)],
        'lines': [_t(z[f'{pre}__nis_line_{i}'][0, :, :, 0].T)
                  for i in range(3)],
    }
    blocks = [{'layers': [_plain_linear(z, f'{pre}__flows_{b}_nn_{i}')
                          for i in (1, 3, 5, 7)]} for b in (0, 1)]
    return {'field': field,
            'nis_mat': [_plain_linear(z, f'{pre}__nis_mat_0'),
                        _plain_linear(z, f'{pre}__nis_mat_2')],
            'blocks': blocks}


def build_params_and_cfg(z, nis=False):
    cfg = mc_shading.MCShadingConfig(
        diffuse_sample_num=16, specular_sample_num=8,
        nis_diffuse_sample_num=8, nis_specular_sample_num=4,
        outer_light_version='direction', use_nis_all=False,
        use_nis_diffuse=nis, use_nis_specular=nis, random_azimuth=False,
        grid_size=(32, 32, 32), inner_light_budget=0.0,
        secondary_budget=0.0, estimator_dtype='f32')
    params = mc_shading.init_mc_shading(torch.Generator().manual_seed(0),
                                        cfg)
    params['mat_field'] = _mat_field(z)
    for name, prefix, n in (('metallic', 'w_metallic', 2),
                            ('roughness', 'w_roughness', 2),
                            ('albedo', 'w_albedo', 2),
                            ('outer_light', 'w_outer', 4),
                            ('inner_light', 'w_inner', 4)):
        params[name] = _predictor_from_torch(z, prefix, n)
    if nis:
        params['flow_diffuse'] = flow_params_from_torch(z, 'w_fd')
        params['flow_specular'] = flow_params_from_torch(z, 'w_fs')
    return params, cfg


def make_trace_fn(z):
    center = _t(z['occ_center'])
    radius = float(z['occ_radius'])

    def trace(o, d):
        oc = o - center
        b = torch.sum(oc * d, -1)
        c = torch.sum(oc * oc, -1) - radius ** 2
        disc = b * b - c
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 0)
        t = torch.where(hit, t, torch.full_like(t, 10.0))
        inters = o + d * t[:, None] * hit[:, None].to(o.dtype)
        n = inters - center
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-8)
        n = torch.where(torch.sum(n * d, -1, keepdim=True) >= 0, -n, n)
        return inters, n, t[:, None], hit
    return trace


def _requires_grad(tree):
    for t in _leaves(tree):
        t.requires_grad_(True)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _forward(params, cfg, trace, pts, view, nrm):
    return mc_shading.mc_forward(
        params, cfg, trace, 2.0 / 511.0, AABB, pts, view, nrm,
        mc_shading.ShadePhase(), None, False)


def _close(a, b, rtol, atol, msg=''):
    np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol, atol=atol,
                               err_msg=msg)


def test_material_feature_matches_reference(fx):
    params, cfg = build_params_and_cfg(fx)
    feats = mc_shading.tenso_feature(params, cfg, _t(fx['pts']), AABB)
    _close(feats, fx['mat_feats'], rtol=1e-4, atol=1e-5)


def test_full_shade_outputs_match_reference(fx):
    params, cfg = build_params_and_cfg(fx)
    with torch.no_grad():
        out = _forward(params, cfg, make_trace_fn(fx), _t(fx['pts']),
                       _t(fx['view']), _t(fx['nrm']))
    _close(out['rgb_pr'], fx['rgb_pr'], rtol=2e-4, atol=2e-5)
    for k in ('albedo', 'metallic', 'roughness', 'diffuse_color',
              'specular_color', 'diffuse_light', 'specular_light',
              'visibility', 'indirect_light', 'approximate_light'):
        _close(out[k], fx[f'out_{k}'], rtol=2e-4, atol=2e-5, msg=k)


def test_full_shade_gradients_match_reference(fx):
    """Pixel gradients (d loss / d pts) and parameter gradients of the
    full shade match torch autograd through the reference."""
    params, cfg = build_params_and_cfg(fx)
    _requires_grad(params)
    pts = _t(fx['pts']).requires_grad_(True)
    out = _forward(params, cfg, make_trace_fn(fx), pts, _t(fx['view']),
                   _t(fx['nrm']))
    (torch.sum(out['rgb_pr']) + torch.sum(out['diffuse_color'])).backward()
    # without NIS nothing of the shade differentiates the points (their
    # field coordinates are detached, as in the reference): the oracle's
    # gradient is exactly 0 and the port's None
    g_pts = torch.zeros_like(pts) if pts.grad is None else pts.grad
    _close(g_pts, fx['g_pts'], rtol=2e-3, atol=2e-5)
    _close(params['mat_field']['planes'][0].grad,
           np.transpose(fx['g_mat_plane0'][0], (2, 1, 0)),
           rtol=2e-3, atol=1e-6)
    for idx in (0, 2):
        layer = params['albedo']['layers'][idx // 2]
        _close(layer['v'].grad,
               fx[f'g_albedo__{idx}_parametrizations_weight_original1'].T,
               rtol=2e-3, atol=1e-6, msg=f'albedo v{idx}')
        _close(layer['b'].grad, fx[f'g_albedo__{idx}_bias'], rtol=2e-3,
               atol=1e-6, msg=f'albedo b{idx}')


def test_full_shade_bf16_default_path(fx):
    """The shipped estimator_dtype='bf16' against the same oracle, at the
    JAX file's widened tolerance (bf16 rounding through the pdf division
    gives ~11% worst-case element error on this fixture)."""
    params, cfg = build_params_and_cfg(fx)
    cfg = cfg._replace(estimator_dtype='bf16')
    with torch.no_grad():
        out = _forward(params, cfg, make_trace_fn(fx), _t(fx['pts']),
                       _t(fx['view']), _t(fx['nrm']))
    _close(out['rgb_pr'], fx['rgb_pr'], rtol=0.15, atol=0.01)
    for k in ('diffuse_color', 'specular_color', 'visibility'):
        _close(out[k], fx[f'out_{k}'], rtol=0.15, atol=0.01, msg=k)


# ---------------------------------------------------------------------------
# NIS path: both flows live (ref: fields.py:1082-1143, 1160-1205, 1260-1333)
# ---------------------------------------------------------------------------

def _nis_forward(params, cfg, trace, pts, view, nrm):
    # the frozen sampling copies: detached clones of the live flows
    copies = {k: _detached(params[k])
              for k in ('flow_diffuse', 'flow_specular')}
    phase = mc_shading.ShadePhase(
        nis_sample_diffuse=True, nis_sample_specular=True,
        nis_loss_diffuse=True, nis_loss_specular=True)
    return mc_shading.mc_forward(
        params, cfg, trace, 2.0 / 511.0, AABB, pts, view, nrm, phase, None,
        False, flow_diffuse_copy=copies['flow_diffuse'],
        flow_specular_copy=copies['flow_specular'])


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach().clone()


def test_nis_flow_copy_samples_match_reference(nfx):
    """The frozen-copy flow samples (Fibonacci prior -> pwquad coupling
    blocks) and their log-densities match torch."""
    params, cfg = build_params_and_cfg(nfx, nis=True)
    pts, view, nrm = _t(nfx['pts']), _t(nfx['view']), _t(nfx['nrm'])
    with torch.no_grad():
        _, roughness, _ = mc_shading.predict_materials(params, cfg, pts,
                                                       AABB)
        va = direction_to_angle(safe_normalize(nrm),
                                safe_normalize(view)[:, None, :])[:, 0]
        va01 = va / torch.tensor([2 * np.pi, 0.5 * np.pi])
        for nm, pre, sn in (('diffuse', 'flow_diffuse', 8),
                            ('specular', 'flow_specular', 4)):
            x, logq = flow_mod.flow_sample(params[pre], cfg.flow, None, pts,
                                           AABB, va01, roughness, sn,
                                           train=False)
            _close(x, nfx[f'{nm}_angles01'], rtol=1e-4, atol=2e-5, msg=nm)
            _close(logq, nfx[f'{nm}_logq'], rtol=1e-3, atol=2e-4, msg=nm)


def test_nis_full_shade_matches_reference(nfx):
    """shade_mixed with both flows live: mixed-estimator outputs and the
    NIS losses match torch."""
    params, cfg = build_params_and_cfg(nfx, nis=True)
    with torch.no_grad():
        out = _nis_forward(params, cfg, make_trace_fn(nfx), _t(nfx['pts']),
                           _t(nfx['view']), _t(nfx['nrm']))
    _close(out['rgb_pr'], nfx['rgb_pr'], rtol=5e-4, atol=5e-5)
    for k in ('diffuse_color', 'specular_color', 'visibility', 'albedo',
              'metallic', 'roughness'):
        _close(out[k], nfx[f'out_{k}'], rtol=5e-4, atol=5e-5, msg=k)
    for k in ('loss_nis_diffuse', 'loss_nis_specular'):
        np.testing.assert_allclose(float(out[k]), float(nfx[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_nis_gradients_match_reference(nfx):
    """Gradients of (sum rgb + NIS losses) through the shading points and
    the live flow parameters (the NIS losses are the only path into the
    flows) match torch autograd."""
    params, cfg = build_params_and_cfg(nfx, nis=True)
    _requires_grad(params)
    pts = _t(nfx['pts']).requires_grad_(True)
    out = _nis_forward(params, cfg, make_trace_fn(nfx), pts, _t(nfx['view']),
                       _t(nfx['nrm']))
    (torch.sum(out['rgb_pr']) + out['loss_nis_diffuse']
     + out['loss_nis_specular']).backward()
    _close(pts.grad, nfx['g_pts'], rtol=3e-3, atol=3e-5)
    for nm, pre in (('fd', 'flow_diffuse'), ('fs', 'flow_specular')):
        _close(params[pre]['field']['planes'][0].grad,
               np.transpose(nfx[f'g_{nm}_plane0'][0], (2, 1, 0)),
               rtol=3e-3, atol=1e-7, msg=f'{nm} plane0')
        _close(params[pre]['blocks'][0]['layers'][0]['w'].grad,
               nfx[f'g_{nm}_block0_w1'].T, rtol=3e-3, atol=1e-7,
               msg=f'{nm} block0 w1')
        _close(params[pre]['nis_mat'][0]['w'].grad,
               nfx[f'g_{nm}_nismat_w0'].T, rtol=3e-3, atol=1e-7,
               msg=f'{nm} nis_mat w0')
