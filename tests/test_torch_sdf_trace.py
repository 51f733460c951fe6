"""The port's baked-SDF tracer (ops/sdf_trace.py) against the JAX package,
on the two-lobe analytic grid (a union of two spheres: self-occluding,
with a concave crease) at 32^3.

Packing and the visibility cache are compared bit for bit; verdicts (hit,
candidate, a1, compaction maps) exactly; taps, depths and normals to the
float32 tolerances stated per test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.ops import grid as jgrid
from tensoflow_tpu.ops import sdf_trace as jst
from tensoflow_tpu_torch.convert import (packed_sdf_grid_from_jax,
                                         sdf_grid_from_jax)
from tensoflow_tpu_torch.ops import grid as pgrid
from tensoflow_tpu_torch.ops import sdf_trace as pst

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

LOBE_CENTERS = np.asarray([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]], np.float32)
LOBE_RADIUS = 0.45
RES = 32
AABB = np.asarray([[-1.0] * 3, [1.0] * 3], np.float32)
APEX_PAD = 2.0 * (2.0 / 31.0)


def two_lobe_sdf(pts):
    d = np.linalg.norm(pts[..., None, :] - LOBE_CENTERS, axis=-1)
    return (d - LOBE_RADIUS).min(-1)


def _t(x):
    return torch.tensor(np.array(x))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, rtol=1e-5, atol=1e-6, msg=''):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    np.testing.assert_allclose(a, _f32(b), rtol=rtol, atol=atol, err_msg=msg)


def _bits(x):
    """uint32 words (JAX) or int64 words (port) as python-int-safe int64."""
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _port_pg(jpg):
    return packed_sdf_grid_from_jax(
        np.asarray(jpg.mid_rows), np.asarray(jpg.blocks),
        np.asarray(jpg.coarse_rows), np.asarray(jpg.aabb), jpg.reso,
        None if jpg.vis_rows is None else np.asarray(jpg.vis_rows),
        jpg.vis_pad)


@pytest.fixture(scope='module')
def grids():
    xs = np.linspace(-1, 1, RES, dtype=np.float32)
    vals = two_lobe_sdf(np.stack(np.meshgrid(xs, xs, xs, indexing='ij'),
                                 -1)).astype(np.float32)
    jdense = jst.SDFGrid(values=jnp.asarray(vals), aabb=jnp.asarray(AABB))
    jpg = jst.bake_vis_cache(jst.pack_sdf_grid(jdense), apex_pad=APEX_PAD)
    pdense = sdf_grid_from_jax(vals, AABB)
    ppg = pst.bake_vis_cache(pst.pack_sdf_grid(pdense), apex_pad=APEX_PAD)
    return dict(vals=vals, jdense=jdense, jpg=jpg, pdense=pdense, ppg=ppg)


@pytest.fixture(scope='module')
def rays():
    """Secondary rays as get_lights launches them: surface points on both
    lobes, hemisphere directions, origins lifted along ray and normal."""
    rng = np.random.RandomState(0)
    pn, sn = 64, 24
    n = rng.randn(pn, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lobe = LOBE_CENTERS[rng.randint(0, 2, pn)]
    pts = lobe + n * LOBE_RADIUS
    keep = two_lobe_sdf(pts) > -1e-3
    pts, n = pts[keep], n[keep]
    pn = len(pts)
    d = rng.randn(pn, sn, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # most rays leave the surface, some point into it (h0 <= 0)
    flip = (np.sum(d * n[:, None], -1) < 0) & (rng.rand(pn, sn) < 0.8)
    d = np.where(flip[..., None], -d, d).astype(np.float32)
    nrm = np.broadcast_to(n[:, None], d.shape).reshape(-1, 3)
    d = d.reshape(-1, 3)
    m_cell = 2.0 / (RES // 2 - 1)
    unit = 2.0 / 31.0
    o = (np.repeat(pts, sn, 0) + 2.0 * unit * d
         + 1.5 * m_cell * nrm).astype(np.float32)
    h0 = np.sum(d * nrm, -1).astype(np.float32)
    return dict(o=o, d=d, h0=h0, pn=pn, sn=sn, pts=pts, n=n)


def test_pack_sdf_grid_is_bit_identical(grids):
    jpg, ppg = grids['jpg'], grids['ppg']
    for name in ('mid_rows', 'blocks', 'coarse_rows'):
        a = getattr(ppg, name)
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      _f32(getattr(jpg, name)), err_msg=name)
    assert ppg.reso == jpg.reso == RES
    sc_j, sc_p = jst._trace_scales(jpg), pst._trace_scales(ppg)
    assert sc_j == pytest.approx(sc_p)


def test_bake_vis_cache_bits_are_identical(grids):
    jbits, pbits = _bits(grids['jpg'].vis_rows), _bits(grids['ppg'].vis_rows)
    assert pbits.shape == jbits.shape == (RES // 4,) * 3 + (8,)
    assert grids['ppg'].vis_rows.dtype == torch.int64
    np.testing.assert_array_equal(pbits, jbits)
    # the cache is neither empty nor full, and its top bit (bin 31 of a
    # word) is in use
    assert 0 < (pbits != 0).mean() and (pbits != 0xFFFFFFFF).any()
    assert ((pbits >> 31) & 1).any()
    assert grids['ppg'].vis_pad == pytest.approx(APEX_PAD)


def test_octa_bin_matches_and_covers_all_bins():
    rng = np.random.RandomState(1)
    d = rng.randn(20000, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jb = np.asarray(jst.octa_bin(jnp.asarray(d)))
    pb = pst.octa_bin(_t(d)).numpy()
    np.testing.assert_array_equal(pb, jb)
    assert pb.min() == 0 and pb.max() == 255
    cj, hj = jst._octa_bin_table()
    cp, hp = pst._octa_bin_table()
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(hp, hj)


def test_block_tap_and_packed_tap_value_and_gradient(grids):
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1.05, 1.05, (500, 3)).astype(np.float32)
    jv, jg = jst.block_tap(grids['jpg'], jnp.asarray(pts), want_grad=True)
    pv, pg = pst.block_tap(grids['ppg'], _t(pts), want_grad=True)
    # same taps and weights, sums in another order: 1e-5 (gradients are
    # differences of taps scaled by (R-1)/extent: 1e-4)
    _close(pv, jv, rtol=1e-5, atol=1e-5)
    _close(pg, jg, rtol=1e-4, atol=1e-4)
    assert pst.block_tap(grids['ppg'], _t(pts))[1] is None
    for rows in ('mid_rows', 'coarse_rows'):
        jv, jg = jgrid.packed_trilinear_tap(
            getattr(grids['jpg'], rows), jnp.asarray(AABB), jnp.asarray(pts),
            want_grad=True)
        pv, pg = pgrid.packed_trilinear_tap(
            getattr(grids['ppg'], rows), _t(AABB), _t(pts), want_grad=True)
        _close(pv, jv, rtol=1e-5, atol=1e-5, msg=rows)
        _close(pg, jg, rtol=1e-4, atol=1e-4, msg=rows)


def _assert_trace_matches(pout, jout, what):
    p_in, p_n, p_t, p_hit = pout
    j_in, j_n, j_t, j_hit = jout
    hit = np.array(j_hit)
    np.testing.assert_array_equal(p_hit.numpy(), hit,
                                  err_msg=f'{what} hit')
    assert 0.05 < hit.mean() < 0.95
    # depths: float32 marching sums; normals are unit vectors
    _close(p_t, j_t, rtol=1e-4, atol=1e-4, msg=f'{what} depth')
    _close(p_in, j_in, rtol=1e-4, atol=1e-4, msg=f'{what} inters')
    _close(p_n[hit], np.asarray(j_n)[hit], rtol=1e-3, atol=1e-3,
           msg=f'{what} normals')


def _primary_rays(n=600, seed=3):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 1.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def test_sphere_trace_dense_and_packed(grids):
    o, d = _primary_rays()
    jout = jst.sphere_trace(grids['jdense'], jnp.asarray(o), jnp.asarray(d),
                            n_steps=64)
    pout = pst.sphere_trace(grids['pdense'], _t(o), _t(d), n_steps=64)
    _assert_trace_matches(pout, jout, 'dense')
    jout = jst.sphere_trace(grids['jpg'], jnp.asarray(o), jnp.asarray(d))
    pout = pst.sphere_trace(grids['ppg'], _t(o), _t(d))
    _assert_trace_matches(pout, jout, 'packed')
    # the packed trace agrees with the dense reference path on most
    # verdicts; at 32^3 the mid grid is 16^3, so grazing rays differ
    dense_hit = pst.sphere_trace(grids['pdense'], _t(o), _t(d),
                                 n_steps=64)[3]
    assert (dense_hit == pout[3]).float().mean() > 0.85


def _budget_both(grids, rays, a1_budget, vis_mode, m=None):
    n = len(rays['o'])
    m = m or pst.budget_slots(n, 0.375)
    jvis = pvis = None
    if vis_mode == 'per_point':
        rv = RES // 4
        base = rays['pts'] + 1.5 * (2.0 / (RES // 2 - 1)) * rays['n']
        ci = np.clip(np.round(np.clip((base + 1) / 2, 0, 1) * (rv - 1)
                              ).astype(np.int64), 0, rv - 1)
        flat = (ci[:, 0] * rv + ci[:, 1]) * rv + ci[:, 2]
        jrows = np.asarray(grids['jpg'].vis_rows).reshape(-1, 8)[flat]
        jvis = jnp.asarray(np.repeat(jrows, rays['sn'], 0))
        pvis = grids['ppg'].vis_rows.reshape(-1, 8)[_t(flat)]   # [pn, 8]
    jres = jst.sphere_trace_budget(
        grids['jpg'], jnp.asarray(rays['o']), jnp.asarray(rays['d']), m,
        h0=jnp.asarray(rays['h0']), a1_budget=a1_budget, vis_rows_flat=jvis)
    pres = pst.sphere_trace_budget(
        grids['ppg'], _t(rays['o']), _t(rays['d']), m, h0=_t(rays['h0']),
        a1_budget=a1_budget, vis_rows_flat=pvis)
    return jres, pres


@pytest.mark.parametrize('a1_budget,vis_mode', [
    (0.625, 'per_ray'), (0.625, 'per_point'), (0.0, 'per_ray'),
    (0.125, 'per_ray')])
def test_sphere_trace_budget_matches_jax(grids, rays, a1_budget, vis_mode):
    """Verdicts and compaction maps exact; depths 1e-4, hit points 1e-4,
    normals of hit slots 1e-3 (the budgeted a1 march at 0.125 overflows,
    which exercises the overflow branch)."""
    jres, pres = _budget_both(grids, rays, a1_budget, vis_mode)
    for name in ('cand', 'a1_need', 'slot_mask', 'hit_m', 'src', 'dest'):
        np.testing.assert_array_equal(getattr(pres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    live = np.array(jres.hit_m & jres.slot_mask)
    assert live.sum() > 20 and 0.02 < np.asarray(jres.cand).mean() < 0.9
    _close(pres.depth_m, jres.depth_m, rtol=1e-4, atol=1e-4, msg='depth')
    _close(pres.inters[live], np.asarray(jres.inters)[live], rtol=1e-4,
           atol=1e-4, msg='inters')
    _close(pres.normals[live], np.asarray(jres.normals)[live], rtol=1e-3,
           atol=1e-3, msg='normals')
    _close(pres.view_out, jres.view_out)


def test_budget_trace_agrees_with_the_unbudgeted_trace(grids, rays):
    """The budgeted trace's hit verdicts against sphere_trace_packed on
    the rays that leave the surface (the budgeted trace calls rays into
    the surface misses by construction)."""
    _, pres = _budget_both(grids, rays, 0.625, 'per_ray',
                           m=len(rays['o']))
    full = pst.sphere_trace_packed(grids['ppg'], _t(rays['o']),
                                   _t(rays['d']))[3]
    hit = torch.zeros_like(full)
    live = pres.hit_m & pres.slot_mask
    hit[pres.src[live]] = True
    out = _t(rays['h0']) > 0
    assert (hit[out] == full[out]).float().mean() > 0.97


@pytest.mark.parametrize('word,bit', [(0, 31), (7, 31), (3, 0)])
def test_visibility_words_bit_31_and_bin_255(grids, rays, word, bit):
    """A cache with ONE bin set (bin = word*32 + bit; (0,31) is bin 31,
    (7,31) is bin 255) certifies exactly the rays of that bin, in the
    int64 words of the port as in the uint32 words of the JAX package."""
    n = len(rays['o'])
    bins = np.asarray(jst.octa_bin(jnp.asarray(rays['d'])))
    target = word * 32 + bit
    # aim a tenth of the outward rays into the target bin's centre
    centers, _ = pst._octa_bin_table()
    d = rays['d'].copy()
    pick = np.where(rays['h0'] > 0.3)[0][::10]
    d[pick] = centers[target]
    nrm = np.repeat(rays['n'], rays['sn'], 0)
    h0 = np.sum(d * nrm, -1).astype(np.float32)
    rows = np.zeros((n, 8), np.uint32)
    rows[:, word] = np.uint32(1 << bit)
    jres = jst.sphere_trace_budget(
        grids['jpg'], jnp.asarray(rays['o']), jnp.asarray(d), 256,
        h0=jnp.asarray(h0), a1_budget=0.625,
        vis_rows_flat=jnp.asarray(rows))
    pres = pst.sphere_trace_budget(
        grids['ppg'], _t(rays['o']), _t(d), 256, h0=_t(h0), a1_budget=0.625,
        vis_rows_flat=_t(rows.astype(np.int64)))
    np.testing.assert_array_equal(pres.a1_need.numpy(),
                                  np.asarray(jres.a1_need))
    np.testing.assert_array_equal(pres.cand.numpy(), np.asarray(jres.cand))
    bins = pst.octa_bin(_t(d)).numpy()
    # a certified ray needs no coarse march: only rays of the target bin
    # can have left a1_need relative to a cache of zeros
    zres = pst.sphere_trace_budget(
        grids['ppg'], _t(rays['o']), _t(d), 256, h0=_t(h0), a1_budget=0.625,
        vis_rows_flat=torch.zeros((n, 8), dtype=torch.int64))
    changed = (zres.a1_need & ~pres.a1_need).numpy()
    assert changed.sum() > 0 and (bins[changed] == target).all()


def test_bake_sdf_grid_and_grid_normal(grids):
    def sdf_np(p):
        return two_lobe_sdf(np.asarray(p))[:, None].astype(np.float32)
    jd = jst.bake_sdf_grid(lambda p: jnp.asarray(sdf_np(p)), AABB, 12,
                           chunk=500)
    pd = pst.bake_sdf_grid(lambda p: _t(sdf_np(p.numpy())), AABB, 12,
                           chunk=500)
    np.testing.assert_array_equal(pd.values.numpy(), np.asarray(jd.values))
    pts = np.random.RandomState(5).uniform(-0.9, 0.9, (50, 3)).astype(
        np.float32)
    _close(pst.sdf_grid_normal(grids['pdense'], _t(pts)),
           jst.sdf_grid_normal(grids['jdense'], jnp.asarray(pts)),
           rtol=1e-4, atol=1e-4)
