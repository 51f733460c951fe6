"""Module parity: the port's plain PyTorch modules vs the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
its port; outputs and, where the module carries gradients, the gradients
of a random projection of the outputs are compared.  float32 throughout;
tolerances are stated per test (rtol 1e-5 / atol 1e-6 where the two sides
do the same arithmetic, looser where a reduction runs in another order).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import light as jlight
from tensoflow_tpu.fields import shading as jshading
from tensoflow_tpu.models import secondary as jsec
from tensoflow_tpu.ops import composite as jcomp
from tensoflow_tpu.ops import cubemap as jcube
from tensoflow_tpu.ops import grid as jgrid
from tensoflow_tpu.ops import math as jmath
from tensoflow_tpu.ops import tensor_field as jtf
from tensoflow_tpu.train import losses as jlosses
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import occ_state_from_jax, params_from_jax
from tensoflow_tpu_torch.fields import light as plight
from tensoflow_tpu_torch.fields import mlp as pmlp
from tensoflow_tpu_torch.fields import shading as pshading
from tensoflow_tpu_torch.models import secondary as psec
from tensoflow_tpu_torch.ops import composite as pcomp
from tensoflow_tpu_torch.ops import cubemap as pcube
from tensoflow_tpu_torch.ops import grid as pgrid
from tensoflow_tpu_torch.ops import math as pmath
from tensoflow_tpu_torch.ops import tensor_field as ptf
from tensoflow_tpu_torch.train import losses as plosses

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(x, grad=False):
    t = torch.tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _close(a, b, rtol=RTOL, atol=ATOL, msg=''):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _unit(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# ops/math.py
# ---------------------------------------------------------------------------

def _math_case(name, rng):
    """(jax fn, port fn, differentiable inputs) for one math function."""
    x = rng.uniform(-1.2, 1.2, (37, 3)).astype(np.float32)
    aabb = np.array([[-1.0, -0.8, -1.2], [1.0, 0.9, 1.1]], np.float32)
    if name == 'contraction':
        return (lambda a: jmath.contraction(a, jnp.asarray(aabb)),
                lambda a: pmath.contraction(a, _t(aabb)), [x])
    if name in ('positional_encoding_3', 'positional_encoding_6'):
        k = int(name[-1])
        assert jmath.pe_dim(3, k) == pmath.pe_dim(3, k)
        return (lambda a: jmath.positional_encoding(a, k),
                lambda a: pmath.positional_encoding(a, k), [x])
    if name == 'integrated_dir_encoding':
        assert jmath.ide_dim(5) == pmath.ide_dim(5)
        r = rng.uniform(0.05, 1.0, (37, 1)).astype(np.float32)
        return (lambda a, b: jmath.integrated_dir_encoding(a, b, 5),
                lambda a, b: pmath.integrated_dir_encoding(a, b, 5),
                [_unit(rng, 37), r])
    if name == 'safe_normalize':
        return jmath.safe_normalize, pmath.safe_normalize, [x]
    if name == 'charbonnier':
        y = rng.rand(37, 3).astype(np.float32)
        return (lambda a: jmath.charbonnier(a, jnp.asarray(y)),
                lambda a: pmath.charbonnier(a, _t(y)), [x])
    if name == 'linear_to_srgb':
        return (jmath.linear_to_srgb, pmath.linear_to_srgb,
                [np.abs(x) * 0.8])
    if name == 'get_sphere_intersection':
        p = (x * 0.5).astype(np.float32)
        d = _unit(rng, 37)
        return (jmath.get_sphere_intersection, pmath.get_sphere_intersection,
                [p, d])
    if name in ('sample_pdf_det', 'sample_pdf_u'):
        bins = np.sort(rng.rand(9, 17), -1).astype(np.float32)
        w = rng.rand(9, 16).astype(np.float32)
        u = np.sort(rng.rand(9, 12), -1).astype(np.float32)
        if name == 'sample_pdf_det':
            return (lambda b, ww: jmath.sample_pdf(b, ww, 12),
                    lambda b, ww: pmath.sample_pdf(b, ww, 12), [bins, w])
        return (lambda b, ww: jmath.sample_pdf(b, ww, 12, jnp.asarray(u)),
                lambda b, ww: pmath.sample_pdf(b, ww, 12, _t(u)), [bins, w])
    raise KeyError(name)


@pytest.mark.parametrize('name', [
    'contraction', 'positional_encoding_3', 'positional_encoding_6',
    'integrated_dir_encoding', 'safe_normalize', 'charbonnier',
    'linear_to_srgb', 'get_sphere_intersection', 'sample_pdf_det',
    'sample_pdf_u'])
def test_math_matches_jax(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    jf, pf, ins = _math_case(name, rng)
    jout = jf(*[jnp.asarray(a) for a in ins])
    targs = [_t(a, grad=True) for a in ins]
    pout = pf(*targs)
    _close(pout, jout, rtol=2e-5, atol=2e-6)
    proj = rng.randn(*np.shape(jout)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) * proj),
                          argnums=tuple(range(len(ins)))))(
        *[jnp.asarray(a) for a in ins])
    g = torch.autograd.grad(torch.sum(pout * _t(proj)), targs)
    for k, (a, b) in enumerate(zip(g, jg)):
        _close(a, b, rtol=1e-4, atol=1e-5, msg=f'grad {k}')


# ---------------------------------------------------------------------------
# ops/tensor_field.py
# ---------------------------------------------------------------------------

def _field(rng, grid=(12, 10, 8), C=4):
    f = jtf.init_vm_circle(grid, C)
    return {'planes': [np.asarray(p) + 0.1 * rng.randn(*p.shape).astype(
                np.float32) for p in f['planes']],
            'lines': [np.asarray(l) + 0.1 * rng.randn(*l.shape).astype(
                np.float32) for l in f['lines']]}


def _field_t(f):
    return {k: [_t(x, grad=True) for x in v] for k, v in f.items()}


def _field_j(f):
    return {k: [jnp.asarray(x) for x in v] for k, v in f.items()}


def _field_grads_close(pf, jgrads, rtol=1e-4, atol=1e-5):
    for k in ('planes', 'lines'):
        for i in range(3):
            _close(pf[k][i].grad, jgrads[k][i], rtol=rtol, atol=atol,
                   msg=f'{k}[{i}]')


def test_init_vm_circle_and_tv_loss_match_jax():
    jf = jtf.init_vm_circle((12, 10, 8), 5, 0.3)
    pf = ptf.init_vm_circle((12, 10, 8), 5, 0.3)
    for k in ('planes', 'lines'):
        for a, b in zip(pf[k], jf[k]):
            _close(a, b, rtol=0, atol=0)
    rng = np.random.RandomState(0)
    f = _field(rng)
    pt = _field_t(f)
    loss = ptf.tv_loss_vm(pt)
    loss.backward()
    jl, jg = jax.value_and_grad(jtf.tv_loss_vm)(_field_j(f))
    _close(loss, jl)
    _field_grads_close(pt, jg)


@pytest.mark.parametrize('n_levels', [1, 2])
def test_vm_features_split_matches_jax(n_levels):
    rng = np.random.RandomState(n_levels)
    f = _field(rng, grid=(16, 12, 8))
    xyz = rng.uniform(-0.05, 1.05, (53, 3)).astype(np.float32)
    level = rng.uniform(0, 1.5, (53,)).astype(np.float32) \
        if n_levels > 1 else None
    projs = [rng.randn(53, 4).astype(np.float32) for _ in range(3)]

    def jloss(fj):
        packed = jtf.pack_vm_field(fj, n_levels)
        out = jtf.vm_features_split(
            packed, jnp.asarray(xyz),
            None if level is None else jnp.asarray(level))
        return sum(jnp.sum(o * p) for o, p in zip(out, projs)), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _field_j(f))
    pf = _field_t(f)
    packed = ptf.pack_vm_field(pf, n_levels)
    pout = ptf.vm_features_split(packed, _t(xyz),
                                 None if level is None else _t(level))
    for a, b in zip(pout, jout):
        _close(a, b)
    sum(torch.sum(o * _t(p)) for o, p in zip(pout, projs)).backward()
    _field_grads_close(pf, jg)


@pytest.mark.parametrize('n_levels', [1, 2])
def test_vm_patch_gather_matches_jax(n_levels):
    """Patch rows, the exact fr lane layout, static sigmas and the
    gradient of the gathered rows back into the field (row-gather VJP +
    atlas pack VJP)."""
    rng = np.random.RandomState(10 + n_levels)
    f = _field(rng, grid=(16, 12, 8))
    xyz = rng.uniform(-0.05, 1.05, (41, 3)).astype(np.float32)
    level = rng.uniform(0, 1.5, (41,)).astype(np.float32) \
        if n_levels > 1 else None
    d01 = [1.0 / 16, 1.0 / 12, 1.0 / 8]

    def jgather(fj):
        atlas = jtf.pack_vm_patches(fj, n_levels)
        return jtf.vm_patch_gather(
            atlas, jnp.asarray(xyz), d01,
            None if level is None else jnp.asarray(level))

    jpp, jlp, jfr, jsig = jgather(_field_j(f))
    pf = _field_t(f)
    atlas = ptf.pack_vm_patches(pf, n_levels)
    ppp, plp, pfr, psig = ptf.vm_patch_gather(
        atlas, _t(xyz), d01, None if level is None else _t(level))
    assert psig == jsig
    # level 0 rows are copies; coarser mips are means (one-ulp rounding)
    _close(pfr, jfr)
    for b in range(len(jpp)):
        for i in range(3):
            _close(ppp[b][i], jpp[b][i])
            _close(plp[b][i], jlp[b][i])
    proj_p = rng.randn(*np.shape(jpp[0][0])).astype(np.float32)
    proj_l = rng.randn(*np.shape(jlp[0][0])).astype(np.float32)

    def jloss(fj):
        pp, lp, _, _ = jgather(fj)
        return sum(jnp.sum(p * proj_p) for row in pp for p in row) + sum(
            jnp.sum(l * proj_l) for row in lp for l in row)

    jg = jax.jit(jax.grad(jloss))(_field_j(f))
    (sum(torch.sum(p * _t(proj_p)) for row in ppp for p in row)
     + sum(torch.sum(l * _t(proj_l)) for row in plp for l in row)).backward()
    # the line gather's VJP rounds its cotangent to bf16 on both sides
    _field_grads_close(pf, jg, rtol=1e-4, atol=1e-4)


def test_sample_bilinear_packed_matches_jax():
    rng = np.random.RandomState(3)
    tex = rng.randn(9, 7, 2).astype(np.float32)
    t0 = rng.uniform(-1, 9, (31,)).astype(np.float32)
    t1 = rng.uniform(-1, 7, (31,)).astype(np.float32)
    jb = jtf.patch_pack_2d(jnp.asarray(tex))
    pb = ptf.patch_pack_2d(_t(tex))
    _close(pb, jb, rtol=0, atol=0)
    _close(ptf.sample_bilinear_packed(pb, 9, 7, _t(t0), _t(t1)),
           jtf.sample_bilinear_packed(jb, 9, 7, jnp.asarray(t0),
                                      jnp.asarray(t1)))


# ---------------------------------------------------------------------------
# ops/grid.py
# ---------------------------------------------------------------------------

def _occ_states(rng, r=16, prune=True):
    cfg_j = jgrid.OccGridConfig(resolution=r)
    cfg_p = pgrid.OccGridConfig(resolution=r)
    alphas = (rng.rand(r ** 3) ** 4).astype(np.float32)
    sdf = rng.randn(r ** 3).astype(np.float32) * 0.3
    js = jgrid.update_occ_grid(jgrid.init_occ_grid(cfg_j), cfg_j,
                               jnp.asarray(alphas), 0, sdf=jnp.asarray(sdf),
                               prune=prune)
    ps = pgrid.update_occ_grid(pgrid.init_occ_grid(cfg_p), cfg_p,
                               _t(alphas), sdf=_t(sdf), prune=prune)
    return cfg_j, cfg_p, js, ps


def test_occ_grid_update_and_blocks_match_jax():
    rng = np.random.RandomState(4)
    _, _, js, ps = _occ_states(rng)
    conv = occ_state_from_jax(jax.tree.map(np.asarray, js))
    for k in ('occs', 'binary', 'blocks'):
        assert torch.equal(ps[k], conv[k]), k
    assert torch.equal(ps['sdf_rows'], conv['sdf_rows'])
    assert 0 < int(ps['binary'].sum()) < ps['binary'].numel()
    cj = jgrid.occ_grid_cell_centers(jgrid.OccGridConfig(resolution=16))
    cp = pgrid.occ_grid_cell_centers(pgrid.OccGridConfig(resolution=16))
    _close(cp, cj, rtol=0, atol=1e-7)


def test_query_and_sample_occ_sdf_match_jax():
    rng = np.random.RandomState(5)
    cfg_j, cfg_p, js, ps = _occ_states(rng)
    pts = rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32)
    assert np.array_equal(
        pgrid.query_binary(ps, cfg_p, _t(pts)).numpy(),
        np.asarray(jgrid.query_binary(js, cfg_j, jnp.asarray(pts))))
    _close(pgrid.sample_occ_sdf(ps, cfg_p, _t(pts)),
           jgrid.sample_occ_sdf(js, cfg_j, jnp.asarray(pts)))


@pytest.mark.parametrize('stride', [1, 3])
def test_occ_grid_sampling_matches_jax(stride):
    """Same occupied steps kept, in order, for a pruned random grid (the
    block-row march at G=4 / G=2 and the per-row stable selection)."""
    rng = np.random.RandomState(6 + stride)
    cfg_j, cfg_p, js, ps = _occ_states(rng)
    rn = 48
    o = (_unit(rng, rn) * 2.5).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = d + 0.2 * rng.randn(rn, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((rn, 1), 1.0, np.float32)
    far = np.full((rn, 1), 4.0, np.float32)
    ss = 2.0 / 15 * 0.5 * stride
    n_cand = -(-int(np.ceil(2 * 1.7321 / (2.0 / 15 * 0.5))) // stride)
    key = jax.random.PRNGKey(stride)
    jres = jgrid.occ_grid_sampling(js, cfg_j, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(near), jnp.asarray(far), ss,
                                   n_cand, 24, key)
    jitter = np.asarray(jax.random.uniform(key, (rn, 1)))
    pres = pgrid.occ_grid_sampling(ps, cfg_p, _t(o), _t(d), _t(near),
                                   _t(far), ss, n_cand, 24, _t(jitter))
    assert np.array_equal(pres[2].numpy(), np.asarray(jres[2]))
    assert 0 < int(pres[2].sum()) < pres[2].numel()
    _close(pres[0], jres[0])
    _close(pres[1], jres[1])


@pytest.mark.parametrize('budget', [40, 400])
def test_compact_indices_matches_jax(budget):
    rng = np.random.RandomState(budget)
    valid = rng.rand(300) < 0.3
    js, jm, jd = jgrid.compact_indices(jnp.asarray(valid), budget)
    ps, pm, pd = pgrid.compact_indices(_t(valid), budget)
    assert np.array_equal(pm.numpy(), np.asarray(jm))
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    m = pm.numpy()
    assert np.array_equal(ps.numpy()[m], np.asarray(js)[m])


# ---------------------------------------------------------------------------
# ops/composite.py
# ---------------------------------------------------------------------------

def _compact_case(rng, rn=13, sn=9, m=80):
    valid = rng.rand(rn * sn) < 0.6
    js, jm, _ = jgrid.compact_indices(jnp.asarray(valid), m)
    src, slot = np.asarray(js), np.asarray(jm)
    ray_id = np.where(slot, src // sn, rn).astype(np.int32)
    alpha = rng.rand(m).astype(np.float32)
    return slot, ray_id, alpha


def test_compact_weights_and_segment_sums_match_jax():
    rng = np.random.RandomState(8)
    rn = 13
    slot, ray_id, alpha = _compact_case(rng, rn)
    cols = rng.randn(alpha.shape[0], 4).astype(np.float32)
    proj = rng.randn(rn, 4).astype(np.float32)

    def jf(a, c):
        w = jcomp.compact_weights(a, jnp.asarray(slot), jnp.asarray(ray_id),
                                  rn)
        s = jcomp.segment_sums_sorted(c * w[:, None], jnp.asarray(ray_id), rn)
        return jnp.sum(s * proj), (w, s)

    (jl, (jw, js)), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1),
                                                    has_aux=True))(
        jnp.asarray(alpha), jnp.asarray(cols))
    a, c = _t(alpha, True), _t(cols, True)
    pw = pcomp.compact_weights(a, _t(slot), _t(ray_id).long(), rn)
    ps = pcomp.segment_sums_sorted(c * pw[:, None], _t(ray_id).long(), rn)
    _close(pw, jw)
    _close(ps, js, atol=2e-6)
    pg = torch.autograd.grad(torch.sum(ps * _t(proj)), [a, c])
    _close(pg[0], jg[0], rtol=1e-4, atol=1e-5)
    _close(pg[1], jg[1], rtol=1e-4, atol=1e-5)


def test_alpha_and_weights_match_jax():
    rng = np.random.RandomState(9)
    sdf = rng.randn(5, 7).astype(np.float32) * 0.1
    cos = rng.uniform(-1, 1, (5, 7)).astype(np.float32)
    dists = rng.uniform(0.01, 0.05, (5, 7)).astype(np.float32)
    mask = rng.rand(5, 7) < 0.8
    for r in (0.0, 0.3, 1.0):
        _close(pcomp.anneal_cos(_t(cos), r), jcomp.anneal_cos(cos, r))
    ja = jcomp.neus_alpha(sdf, 20.0, jcomp.anneal_cos(cos, 0.3), dists)
    pa = pcomp.neus_alpha(_t(sdf), torch.tensor(20.0),
                          pcomp.anneal_cos(_t(cos), 0.3), _t(dists))
    _close(pa, ja)
    _close(pcomp.neus_alpha_isotropic(_t(sdf), torch.tensor(20.0), 0.01),
           jcomp.neus_alpha_isotropic(sdf, 20.0, 0.01))
    jw, jt = jcomp.weights_from_alpha(ja, jnp.asarray(mask))
    pw, pt = pcomp.weights_from_alpha(pa, _t(mask))
    _close(pw, jw)
    _close(pt, jt)


# ---------------------------------------------------------------------------
# ops/cubemap.py + fields/light.py
# ---------------------------------------------------------------------------

def test_envlight_mips_and_shade_match_jax():
    """build_mips (box chain, exact GGX at <= 32, cosine-convolved
    diffuse, packed tables) and shade, with grads into the cubemap."""
    rng = np.random.RandomState(11)
    ecfg_j = jlight.EnvLightConfig(max_res=32)
    ecfg_p = plight.EnvLightConfig(max_res=32)
    base = (np.log(0.5) + 0.3 * rng.randn(6, 32, 32, 3)).astype(np.float32)
    dirs = _unit(rng, 64)
    rough = rng.uniform(0.05, 1.0, (64, 1)).astype(np.float32)
    proj = rng.randn(64, 3).astype(np.float32)

    def jf(b):
        mips = jlight.build_mips({'base': b}, ecfg_j)
        d = jlight.shade(mips, jnp.asarray(dirs), None, ecfg_j)
        s = jlight.shade(mips, jnp.asarray(dirs), jnp.asarray(rough), ecfg_j)
        return jnp.sum((d + s) * proj), (d, s, mips)

    (_, (jd, js, jm)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(base))
    b = _t(base, True)
    pm = plight.build_mips({'base': b}, ecfg_p)
    pd = plight.shade(pm, _t(dirs), None, ecfg_p)
    ps = plight.shade(pm, _t(dirs), _t(rough), ecfg_p)
    for a, c in zip(pm['specular'], jm['specular']):
        _close(a, c, rtol=1e-5, atol=2e-6)
    _close(pm['diffuse'], jm['diffuse'], rtol=1e-5, atol=2e-6)
    _close(pd, jd, rtol=1e-5, atol=2e-6)
    _close(ps, js, rtol=1e-5, atol=2e-6)
    torch.sum((pd + ps) * _t(proj)).backward()
    _close(b.grad, jg, rtol=1e-4, atol=1e-6)


def test_cubemap_uv_and_packed_lookup_match_jax():
    rng = np.random.RandomState(12)
    dirs = _unit(rng, 100)
    jface, ju, jv = jcube.dir_to_cube_uv(jnp.asarray(dirs))
    pface, pu, pv = pcube.dir_to_cube_uv(_t(dirs))
    assert np.array_equal(pface.numpy(), np.asarray(jface))
    _close(pu, ju)
    _close(pv, jv)
    cm = rng.randn(6, 8, 8, 3).astype(np.float32)
    jp = jcube.pack_cubemap_patches(jnp.asarray(cm))
    pp = pcube.pack_cubemap_patches(_t(cm))
    _close(pp, jp, rtol=0, atol=0)
    _close(pcube.sample_cubemap_packed(pp, 8, _t(dirs)),
           jcube.sample_cubemap_packed(jp, 8, jnp.asarray(dirs)))


# ---------------------------------------------------------------------------
# fields/shading.py, fields/mlp.py
# ---------------------------------------------------------------------------

def test_apply_shading_matches_jax():
    """Shading with the radiance head on, grads into every shading
    parameter, the normals and the appearance features."""
    rng = np.random.RandomState(13)
    app = 16
    ecfg_j = jlight.EnvLightConfig(max_res=32)
    scfg_j = jshading.ShadingConfig(app_feats_dim=app,
                                    has_radiance_field=True,
                                    env=ecfg_j)
    scfg_p = pshading.ShadingConfig(app_feats_dim=app,
                                    has_radiance_field=True,
                                    env=plight.EnvLightConfig(max_res=32))
    jparams = jshading.init_shading(jax.random.PRNGKey(3), scfg_j)
    jparams['envlight']['base'] = jparams['envlight']['base'] + 0.2 * \
        jax.random.normal(jax.random.PRNGKey(4),
                          jparams['envlight']['base'].shape)
    n = 50
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    nrm = _unit(rng, n)
    view = _unit(rng, n)
    feats = rng.randn(n, app).astype(np.float32)
    proj = rng.randn(n, 3).astype(np.float32)
    step = 5

    def jf(p, nn, ff):
        mips = jlight.build_mips(p['envlight'], ecfg_j)
        color, rad, occ = jshading.apply_shading(
            p, scfg_j, mips, jnp.asarray(pts), nn, jnp.asarray(view), ff,
            step=step)
        tot = jnp.sum(color * proj) + jnp.sum(occ['occ_prob'])
        if rad is not None:
            tot = tot + jnp.sum(rad * proj)
        return tot, (color, rad, occ)

    (_, (jc, jr, jo)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        jparams, jnp.asarray(nrm), jnp.asarray(feats))
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    leaves = []

    def req(tree):
        if isinstance(tree, dict):
            return {k: req(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [req(v) for v in tree]
        leaves.append(tree.requires_grad_(True))
        return tree
    req(pparams)
    nn, ff = _t(nrm, True), _t(feats, True)
    mips = plight.build_mips(pparams['envlight'], scfg_p.env)
    pc, pr, po = pshading.apply_shading(pparams, scfg_p, mips, _t(pts), nn,
                                        _t(view), ff, step=step)
    _close(pc, jc, rtol=1e-5, atol=2e-6)
    for k in ('reflective', 'occ_prob', 'roughness'):
        _close(po[k], jo[k], rtol=1e-5, atol=2e-6, msg=k)
    assert (pr is None) == (jr is None)
    tot = torch.sum(pc * _t(proj)) + torch.sum(po['occ_prob'])
    if pr is not None:
        _close(pr, jr, rtol=1e-5, atol=2e-6)
        tot = tot + torch.sum(pr * _t(proj))
    tot.backward()
    _close(nn.grad, jg[1], rtol=1e-4, atol=1e-5, msg='normals')
    _close(ff.grad, jg[2], rtol=1e-4, atol=1e-5, msg='feats')
    jl = jax.tree_util.tree_leaves_with_path(jg[0])
    assert len(jl) == len(leaves)
    for (path, a), b in zip(jl, _sorted_leaves(pparams)):
        g = b.grad if b.grad is not None else torch.zeros_like(b)
        scale = float(np.abs(np.asarray(a)).max()) + 1e-12
        _close(g / scale, np.asarray(a) / scale, rtol=0, atol=1e-4,
               msg=jax.tree_util.keystr(path))


def _sorted_leaves(tree):
    """Leaves in jax.tree_util order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def test_softplus100_and_variance_match_jax():
    from tensoflow_tpu.fields import mlp as jmlp
    x = np.linspace(-1.0, 1.0, 401).astype(np.float32)
    _close(pmlp.softplus100(_t(x)), jmlp.softplus100(jnp.asarray(x)),
           rtol=1e-6, atol=1e-7)
    for act in ('exp', 'linear', 'square'):
        _close(pmlp.apply_variance({'variance': torch.tensor(0.3)}, act),
               jmlp.apply_variance({'variance': jnp.asarray(0.3)}, act))


def test_softplus100_slope_matches_jax():
    """The slope is sigmoid(100 x), also at x == 0 exactly, where a
    float32 pre-activation does land (rtol 1e-6 / atol 1e-7)."""
    from tensoflow_tpu.fields import mlp as jmlp
    x = np.array([0.0, -0.0, 1e-9, -1e-9, 0.003, -0.003, 0.5, -0.5],
                 np.float32)
    t = _t(x, grad=True)
    g = torch.autograd.grad(pmlp.softplus100(t).sum(), t)[0]
    want = jax.grad(lambda a: jnp.sum(jmlp.softplus100(a)))(jnp.asarray(x))
    _close(g, want, rtol=1e-6, atol=1e-7)
    assert float(g[0]) == 0.5


# ---------------------------------------------------------------------------
# models/secondary.py, train/losses.py, config
# ---------------------------------------------------------------------------

def test_secondary_intersection_matches_jax():
    rng = np.random.RandomState(14)
    pts = (_unit(rng, 40) * 0.3).astype(np.float32)
    dirs = _unit(rng, 40)

    def jsdf(x):
        return jnp.linalg.norm(x - 0.4, axis=-1, keepdims=True) - 0.35

    def psdf(x):
        return torch.linalg.norm(x - 0.4, dim=-1, keepdim=True) - 0.35

    jz, jw, js = jsec.secondary_intersection(jsdf, 50.0, jnp.asarray(pts),
                                             jnp.asarray(dirs), 64, 16)
    pz, pw, ps = psec.secondary_intersection(psdf, torch.tensor(50.0),
                                             _t(pts), _t(dirs), 64, 16)
    # resampled depths come through an inverse CDF of float32 cumsums
    _close(pz, jz, rtol=1e-4, atol=2e-5)
    _close(pw, jw, rtol=1e-4, atol=2e-6)
    _close(ps, js, rtol=1e-5, atol=2e-6)
    assert float(pw.sum()) > 0.5


@pytest.mark.parametrize('step', [0, 700, 25000, 45000])
def test_schedule_weights_and_init_reg_match_jax(step):
    from tensoflow_tpu import config as jconfig
    path = 'configs/shape/syn/compressor_occ.yaml'
    jc = jconfig.load_config(path)
    pc = pconfig.load_config(path)
    assert jc == pc
    assert plosses.schedule_weights(pc, step) == \
        jlosses.schedule_weights(jc, step)
    rng = np.random.RandomState(step)
    sdf = rng.randn(200).astype(np.float32) * 0.3
    nrm = rng.uniform(0, 1.3, (200,)).astype(np.float32)
    mask = (rng.rand(200) < 0.7).astype(np.float32)
    for a, b in zip(plosses.init_sdf_reg_loss(_t(sdf), _t(nrm), _t(mask)),
                    jlosses.init_sdf_reg_loss(jnp.asarray(sdf),
                                              jnp.asarray(nrm),
                                              jnp.asarray(mask))):
        _close(a, b)
