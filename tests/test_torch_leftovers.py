"""The port's last leftovers against the JAX package: run_colmap (with a
fake ``colmap`` on PATH), models/secondary.trace_sdf on an analytic sphere
and fields/shading.compute_fg_lut / compute_fg_lut_packed.

Tolerances: trace_sdf rtol 1e-5 / atol 1e-5 (the same float32 march;
its inverse-CDF resampling moves a depth by up to ~2e-6 between JAX's jit
and torch);
the LUTs equal to 1e-7 (the same numpy float64 integration, stored as
float32).
"""
import importlib.util
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import shading as jshading
from tensoflow_tpu.models import secondary as jsecondary
from tensoflow_tpu_torch import run_colmap
from tensoflow_tpu_torch.fields import shading as pshading
from tensoflow_tpu_torch.models import secondary as psecondary

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_colmap(tmp_path, log):
    """A ``colmap`` that appends its arguments to ``log``, one call a
    line."""
    bindir = tmp_path / 'bin'
    bindir.mkdir()
    exe = bindir / 'colmap'
    exe.write_text('#!/bin/sh\nprintf "%s\\n" "$*" >> "' + str(log)
                   + '"\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(bindir)


def _jax_run_colmap():
    spec = importlib.util.spec_from_file_location(
        'ref_run_colmap', os.path.join(ROOT, 'run_colmap.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('same_camera', [True, False])
def test_run_colmap_calls_colmap_as_the_reference(tmp_path, monkeypatch,
                                                  same_camera):
    """The three colmap calls with the reference CLI's argv."""
    monkeypatch.chdir(tmp_path)
    logs = {}
    for name, mod in (('port', run_colmap), ('jax', _jax_run_colmap())):
        d = tmp_path / name
        d.mkdir()
        logs[name] = d / 'calls.txt'
        monkeypatch.setenv('PATH', _fake_colmap(d, logs[name]))
        mod.run_sfm('IMAGES', 'PROJECT', same_camera=same_camera)
        assert os.path.isdir('PROJECT/sparse')
    calls = logs['port'].read_text().splitlines()
    assert calls == logs['jax'].read_text().splitlines()
    single = '1' if same_camera else '0'
    assert calls == [
        'feature_extractor --database_path PROJECT/database.db '
        f'--image_path IMAGES --ImageReader.single_camera {single} '
        '--ImageReader.camera_model SIMPLE_RADIAL',
        'exhaustive_matcher --database_path PROJECT/database.db',
        'mapper --database_path PROJECT/database.db --image_path IMAGES '
        '--output_path PROJECT/sparse']


def test_run_colmap_cli_and_missing_binary(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log = tmp_path / 'calls.txt'
    monkeypatch.setenv('PATH', _fake_colmap(tmp_path, log))
    run_colmap.main(['--project', 'cap'])
    first = log.read_text().splitlines()[0]
    assert '--image_path cap/images' in first
    assert '--database_path cap/colmap/database.db' in first
    assert (tmp_path / 'cap' / 'colmap' / 'sparse').is_dir()
    monkeypatch.setenv('PATH', str(tmp_path / 'nowhere'))
    with pytest.raises(RuntimeError, match='colmap binary not found'):
        run_colmap.run_sfm('IMAGES', 'PROJECT')


def test_trace_sdf_matches_jax_on_a_sphere():
    """Rays at a sphere of radius 0.5 (most hit it, some pass beside it):
    depth, hit point, facing normal and the hit mask as JAX's."""
    rng = np.random.RandomState(0)
    n = 64
    o = rng.randn(n, 3).astype(np.float32)
    o = 0.9 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = 0.6 * rng.randn(n, 3).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

    def jsdf(x):
        return jnp.linalg.norm(x, axis=-1, keepdims=True) - 0.5

    def psdf(x):
        return torch.linalg.norm(x, dim=-1, keepdim=True) - 0.5

    jout = jax.jit(lambda oo, dd: jsecondary.trace_sdf(
        jsdf, lambda x: x, 64.0, oo, dd))(jnp.asarray(o), jnp.asarray(d))
    pout = psecondary.trace_sdf(psdf, lambda x: x, 64.0,
                                torch.from_numpy(o), torch.from_numpy(d))
    names = ('inters', 'normals', 'depth', 'hit')
    for name, p, j in zip(names, pout, jout):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    hit = pout[3].numpy()
    assert 0 < hit.sum() < n
    # hits lie on the sphere, their normals face the ray
    r = np.linalg.norm(pout[0].numpy()[hit], axis=-1)
    assert np.abs(r - 0.5).max() < 0.02
    assert (np.sum(pout[1].numpy() * d, -1)[hit] < 0).all()


def test_compute_fg_lut_matches_jax(tmp_path, monkeypatch):
    """compute_fg_lut(64, 256) as tests/test_fields.py builds it: the
    port integrates afresh (its cache directory empty) what the JAX
    package computes, then reads its own cache."""
    monkeypatch.setattr(pshading, 'ASSETS', str(tmp_path))
    pshading.compute_fg_lut.cache_clear()
    pshading.compute_fg_lut_packed.cache_clear()
    try:
        got = pshading.compute_fg_lut(64, 256)
        want = jshading.compute_fg_lut(64, 256)
        assert got.shape == (64, 64, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert (tmp_path / 'fg_lut_64_256.npy').exists()
        pshading.compute_fg_lut.cache_clear()
        np.testing.assert_array_equal(pshading.compute_fg_lut(64, 256), got)
        packed, hw = pshading.compute_fg_lut_packed(64, 256)
        jpacked, jhw = jshading.compute_fg_lut_packed(64, 256)
        assert hw == jhw == (64, 64)
        np.testing.assert_allclose(packed, jpacked, rtol=0, atol=1e-7)
    finally:
        pshading.compute_fg_lut.cache_clear()
        pshading.compute_fg_lut_packed.cache_clear()


def test_fg_lut_packed_is_the_shipped_table():
    """The shading step's packed LUT is the shipped 256 x 256, 1,024-sample
    table, as the JAX package packs it."""
    packed, hw = pshading.fg_lut_packed('cpu')
    jpacked, jhw = jshading.compute_fg_lut_packed(256, 1024)
    assert hw == jhw == (256, 256)
    assert packed.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
