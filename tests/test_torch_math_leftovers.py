"""The port's math and sampler leftovers against the JAX package:
reflect, safe_sqrt / safe_acos / safe_log, srgb_to_linear,
normalize_coord, to_sphere_angles / from_sphere_angles,
spherical_harmonics (every level), az_el_to_points, halton_sequence and
stratified_samples_1d / 2d (host numpy tables, drawn from an explicit
np.random.Generator).

float32 elementwise math: values to rtol 1e-6 / atol 1e-6 (one ulp of
the transcendental functions apart), gradients to 1e-5 relative; the
host tables are the same numpy code, equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.ops import math as jm
from tensoflow_tpu.ops import samplers as jsamp
from tensoflow_tpu_torch.ops import math as pm
from tensoflow_tpu_torch.ops import samplers as psamp

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

AABB = np.array([[-1.0, -0.5, -2.0], [1.0, 1.5, 2.0]], np.float32)


def _unit(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.2, 1.2, (257,)).astype(np.float32)
    x[:5] = [-1.0, 0.0, 1.0, 1e-13, 2e-6]
    return dict(v=_unit(rng, 64), n=_unit(rng, 64), x=x,
                srgb=rng.uniform(-0.1, 1.2, (257,)).astype(np.float32),
                xyz=rng.uniform(-2, 2, (64, 3)).astype(np.float32),
                ang=np.stack([rng.uniform(0, 2 * np.pi, 64),
                              rng.uniform(0, np.pi, 64)], -1)
                .astype(np.float32), aabb=AABB)


CASES = {
    'reflect': (lambda m, d: m.reflect(d['v'], d['n']), ('v', 'n')),
    'safe_sqrt': (lambda m, d: m.safe_sqrt(d['x']), ('x',)),
    'safe_acos': (lambda m, d: m.safe_acos(d['x']), ('x',)),
    'safe_log': (lambda m, d: m.safe_log(d['x']), ('x',)),
    'srgb_to_linear': (lambda m, d: m.srgb_to_linear(d['srgb']), ('srgb',)),
    'normalize_coord': (lambda m, d: m.normalize_coord(d['xyz'], d['aabb']),
                        ('xyz',)),
    'to_sphere_angles': (lambda m, d: m.to_sphere_angles(d['v']), ('v',)),
    'from_sphere_angles': (lambda m, d: m.from_sphere_angles(d['ang']),
                           ('ang',)),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_elementwise_math_and_grads_match_jax(name):
    fn, args = CASES[name]
    d = _data()
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    pd = {k: torch.tensor(v, requires_grad=k in args) for k, v in d.items()}
    jout = fn(jm, jd)
    pout = fn(pm, pd)
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    proj = np.random.RandomState(1).randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda dd: jnp.sum(fn(jm, dict(jd, **dd)) * proj))(
        {k: jd[k] for k in args})
    torch.sum(pout * torch.tensor(proj)).backward()
    for k in args:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(pd[k].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * (np.abs(g).max() + 1e-12),
                                   err_msg=k)


@pytest.mark.parametrize('levels', [1, 2, 3, 4, 5])
def test_spherical_harmonics_match_jax(levels):
    d = _unit(np.random.RandomState(2), 50)
    out = pm.spherical_harmonics(levels, torch.tensor(d))
    want = np.asarray(jm.spherical_harmonics(levels, jnp.asarray(d)))
    assert tuple(out.shape) == want.shape == (50, levels ** 2)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)


def test_host_sampler_tables_match_jax():
    rng = np.random.RandomState(3)
    az = rng.uniform(0, 2 * np.pi, 40)
    el = rng.uniform(-np.pi / 2, np.pi / 2, 40)
    np.testing.assert_array_equal(psamp.az_el_to_points(az, el),
                                  jsamp.az_el_to_points(az, el))
    for dim, n in ((1, 7), (3, 100), (16, 33)):
        np.testing.assert_array_equal(psamp.halton_sequence(dim, n),
                                      jsamp.halton_sequence(dim, n))
    for n in (1, 2, 64):
        np.testing.assert_array_equal(
            psamp.stratified_samples_1d(n, np.random.default_rng(4)),
            jsamp.stratified_samples_1d(n, np.random.default_rng(4)))
        np.testing.assert_array_equal(
            psamp.stratified_samples_2d(n, np.random.default_rng(5)),
            jsamp.stratified_samples_2d(n, np.random.default_rng(5)))
    s = psamp.stratified_samples_1d(64, np.random.default_rng(6))
    assert s.dtype == np.float32 and np.all(np.diff(s) >= 0)
