"""ops/renderutils_compat.py of the port against the JAX package's (every
function, forward, and the BSDFs' input gradients), and the torch-oracle
cases of tests/test_ref_parity.py run against the port on
tests/fixtures/ref_oracles.npz at that file's tolerances: the BSDF set,
prepare_shading_normal, the pwquad and pwlinear flow transforms,
sample_pdf and get_weights (secondary.march_weights).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.ops import renderutils_compat as jru
from tensoflow_tpu_torch.fields import flow as flow_mod
from tensoflow_tpu_torch.models import secondary
from tensoflow_tpu_torch.ops import math as math_mod
from tensoflow_tpu_torch.ops import renderutils_compat as pru

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'ref_oracles.npz')
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope='module')
def fx():
    return dict(np.load(FIX))


def _t(x, grad=False):
    return torch.tensor(np.array(x, np.float32), requires_grad=grad)


def _dirs(n, seed, up=False):
    d = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if up:
        d[:, 2] = np.abs(d[:, 2])
    return d


def _close(p, j, rtol=RTOL, atol=ATOL, msg=''):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# every function against the JAX package
# ---------------------------------------------------------------------------

def test_lobes_and_microfacet_terms_match_jax():
    rng = np.random.RandomState(0)
    nrm, wi, wo = _dirs(200, 1, up=True), _dirs(200, 2), _dirs(200, 3)
    rough = rng.rand(200, 1).astype(np.float32)
    ct = rng.uniform(-0.2, 1.2, (200, 1)).astype(np.float32)
    a2 = (rng.rand(200, 1) * 0.9 + 0.01).astype(np.float32)
    f0 = rng.rand(200, 3).astype(np.float32)
    f90 = rng.rand(200, 1).astype(np.float32)
    _close(pru.lambert(_t(nrm), _t(wi)), jru.lambert(nrm, wi))
    _close(pru.fresnel_schlick90(_t(f0), _t(f90), _t(ct)),
           jru.fresnel_schlick90(f0, f90, ct))
    _close(pru.frostbite_diffuse(_t(nrm), _t(wi), _t(wo), _t(rough)),
           jru.frostbite_diffuse(nrm, wi, wo, rough))
    _close(pru.ndf_ggx(_t(a2), _t(ct)), jru.ndf_ggx(a2, ct))
    _close(pru.lambda_ggx(_t(a2), _t(ct)), jru.lambda_ggx(a2, ct))
    _close(pru.masking_smith_ggx_correlated(_t(a2), _t(ct), _t(ct[::-1])),
           jru.masking_smith_ggx_correlated(a2, ct, ct[::-1]))
    _close(pru.pbr_specular(_t(f0), _t(nrm), _t(wo), _t(wi), _t(rough)),
           jru.pbr_specular(f0, nrm, wo, wi, rough))


@pytest.mark.parametrize('bsdf', [0, 1])
def test_pbr_bsdf_and_its_gradients_match_jax(bsdf):
    rng = np.random.RandomState(bsdf)
    n = 64
    pos = (rng.randn(n, 3) * 0.1).astype(np.float32)
    nrm = _dirs(n, 4)
    view, light = _dirs(n, 5) * 2, _dirs(n, 6) * 2
    kd = rng.rand(n, 3).astype(np.float32)
    arm = np.stack([rng.rand(n) * 0.3, rng.rand(n) * 0.9 + 0.1,
                    rng.rand(n)], -1).astype(np.float32)

    def jf(kd, arm, nrm):
        return jnp.sum(jru.pbr_bsdf(kd, arm, pos, nrm, view, light, 0.08,
                                    bsdf))
    tk, ta, tn = _t(kd, True), _t(arm, True), _t(nrm, True)
    out = pru.pbr_bsdf(tk, ta, _t(pos), tn, _t(view), _t(light), 0.08, bsdf)
    _close(out, jru.pbr_bsdf(kd, arm, pos, nrm, view, light, 0.08, bsdf))
    out.sum().backward()
    for g, want in zip((tk.grad, ta.grad, tn.grad),
                       jax.grad(jf, argnums=(0, 1, 2))(kd, arm, nrm)):
        _close(g, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('opengl,two_sided', [(True, True), (False, True),
                                              (True, False)])
def test_prepare_shading_normal_matches_jax(opengl, two_sided):
    rng = np.random.RandomState(7)
    args = [(rng.randn(32, 3) * s).astype(np.float32)
            for s in (0.1, 2.0, 1.0, 1.0, 1.0, 1.0)]
    got = pru.prepare_shading_normal(*map(_t, args),
                                     two_sided_shading=two_sided,
                                     opengl=opengl)
    _close(got, jru.prepare_shading_normal(*args,
                                           two_sided_shading=two_sided,
                                           opengl=opengl))


@pytest.mark.parametrize('loss', ['l1', 'mse', 'smape', 'relmse'])
@pytest.mark.parametrize('tonemapper', ['none', 'log_srgb'])
def test_image_loss_matches_jax(loss, tonemapper):
    rng = np.random.RandomState(8)
    a = (rng.rand(8, 8, 3) * 3).astype(np.float32)
    b = (rng.rand(8, 8, 3) * 3).astype(np.float32)
    _close(pru.image_loss(_t(a), _t(b), loss, tonemapper),
           jru.image_loss(a, b, loss, tonemapper))


def test_unknown_loss_and_tonemapper_raise():
    x = torch.ones(2, 2, 3)
    with pytest.raises(NotImplementedError):
        pru.image_loss(x, x, 'huber')
    with pytest.raises(NotImplementedError):
        pru.image_loss(x, x, 'l1', 'aces')


def test_transforms_match_jax():
    rng = np.random.RandomState(9)
    pts = rng.randn(2, 10, 3).astype(np.float32)
    mtx = rng.randn(2, 4, 4).astype(np.float32)
    _close(pru.xfm_points(_t(pts), _t(mtx)), jru.xfm_points(pts, mtx))
    _close(pru.xfm_vectors(_t(pts), _t(mtx)), jru.xfm_vectors(pts, mtx))


# ---------------------------------------------------------------------------
# tests/test_ref_parity.py's torch-oracle cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bsdf_id,name', [(0, 'lambert'), (1, 'frostbite')])
def test_pbr_bsdf_matches_reference(fx, bsdf_id, name):
    kd, arm, nrm = (_t(fx['pbr_kd'], True), _t(fx['pbr_arm'], True),
                    _t(fx['pbr_nrm'], True))
    out = pru.pbr_bsdf(kd, arm, _t(fx['pbr_pos']), nrm,
                       _t(fx['pbr_view_pos']), _t(fx['pbr_light_pos']), 0.08,
                       bsdf_id)
    _close(out, fx[f'pbr_{name}_out'], rtol=1e-5, atol=1e-5)
    out.sum().backward()
    _close(kd.grad, fx[f'pbr_{name}_g_kd'], rtol=1e-4, atol=1e-4)
    _close(arm.grad, fx[f'pbr_{name}_g_arm'], rtol=1e-4, atol=1e-4)
    _close(nrm.grad, fx[f'pbr_{name}_g_nrm'], rtol=1e-4, atol=2e-4)


def test_prepare_shading_normal_matches_reference(fx):
    out = pru.prepare_shading_normal(
        _t(fx['pbr_pos']), _t(fx['pbr_view_pos']), _t(fx['psn_perturbed']),
        _t(fx['psn_smooth_nrm']), _t(fx['psn_smooth_tng']),
        _t(fx['psn_geom_nrm']), two_sided_shading=True, opengl=False)
    _close(out, fx['psn_out'], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('direction', ['inv', 'fwd'])
def test_pwquad_flow_matches_reference(fx, direction):
    x, wv = _t(fx['pwq_x'], True), _t(fx['pwq_wv'], True)
    fn = flow_mod.pwquad_flow_inv if direction == 'inv' else \
        flow_mod.pwquad_flow
    y, logj = fn(x, wv)
    out_key = 'pwq_inv_y' if direction == 'inv' else 'pwq_fwd_x'
    g_key = 'pwq_inv_gx' if direction == 'inv' else 'pwq_fwd_gy'
    _close(y, fx[out_key], rtol=1e-5, atol=1e-5)
    _close(logj, fx[f'pwq_{direction}_logj'], rtol=1e-4, atol=1e-4)
    (torch.sum(y) + torch.sum(logj)).backward()
    _close(x.grad, fx[g_key], rtol=1e-3, atol=2e-3)
    _close(wv.grad, fx[f'pwq_{direction}_gwv'], rtol=1e-3, atol=2e-3)


def test_pwquad_roundtrip(fx):
    x, wv = _t(fx['pwq_x']), _t(fx['pwq_wv'])
    y, logj = flow_mod.pwquad_flow_inv(x, wv)
    x2, logj2 = flow_mod.pwquad_flow(y, wv)
    _close(x2, fx['pwq_x'], rtol=1e-4, atol=1e-5)
    _close(logj + logj2, np.zeros_like(fx['pwq_inv_logj']), rtol=0,
           atol=1e-4)


def test_pwlinear_matches_reference(fx):
    """tests/test_ref_parity.py's pwlinear case on the port, at its
    tolerances."""
    x, q = _t(fx['pwq_x'], True), _t(fx['pwl_q'], True)
    y, logj = flow_mod.pwlinear_flow_inv(x, q)
    _close(y, fx['pwl_inv_y'], rtol=1e-5, atol=1e-5)
    _close(logj, fx['pwl_inv_logj'], rtol=1e-4, atol=1e-4)
    (torch.sum(y) + torch.sum(logj)).backward()
    _close(x.grad, fx['pwl_inv_gx'], rtol=1e-3, atol=2e-3)
    _close(q.grad, fx['pwl_inv_gq'], rtol=1e-3, atol=2e-3)
    x2, logj2 = flow_mod.pwlinear_flow(_t(fx['pwq_x']), _t(fx['pwl_q']))
    _close(x2, fx['pwl_fwd_x'], rtol=1e-5, atol=1e-5)
    _close(logj2, fx['pwl_fwd_logj'], rtol=1e-4, atol=1e-4)


def test_sample_pdf_matches_reference(fx):
    n_samples = fx['spdf_samples'].shape[-1]
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples)
    u = u.expand(fx['spdf_bins'].shape[:-1] + (n_samples,))
    out = math_mod.sample_pdf(_t(fx['spdf_bins']), _t(fx['spdf_weights']),
                              n_samples, u=u)
    _close(out, fx['spdf_samples'], rtol=1e-5, atol=1e-5)


def test_get_weights_matches_reference(fx):
    def sdf_fun(p):
        return torch.linalg.norm(p, dim=-1, keepdim=True) - 0.5

    w, mid_sdf = secondary.march_weights(
        sdf_fun, torch.tensor(64.0), _t(fx['gw_z_vals']),
        _t(fx['gw_origins']), _t(fx['gw_dirs']))
    _close(w, fx['gw_weights'], rtol=1e-4, atol=1e-5)
    _close(mid_sdf, fx['gw_mid_sdf'], rtol=1e-5, atol=1e-5)
