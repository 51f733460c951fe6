"""The port's Monte-Carlo shader (fields/mc_shading.py) against the JAX
package: get_lights in each of its branches, and mc_forward outputs and
parameter gradients in each of the three training phases (no NIS, NIS
loss, NIS sampling from frozen flow copies), for shade_mixed_all with its
combined flow (no copy, the copy sampled, the copy and the loss), and for
shade_mixed with realnvp flows sampled.

Geometry is the two-lobe analytic grid at 32^3 (self-occluding).  The
random draws of the JAX shader (four keys split from one) are evaluated
with jax.random here and handed to the port as numbers.  float32 with
estimator_dtype='f32', as the JAX parity fixtures pin it; one test runs
'bf16' at a loose tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import mc_shading as jmc
from tensoflow_tpu.ops import sdf_trace as jst
from tensoflow_tpu_torch.convert import (packed_sdf_grid_from_jax,
                                         params_from_jax, sdf_grid_from_jax)
from tensoflow_tpu_torch.fields import mc_shading as pmc

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

LOBE_CENTERS = np.asarray([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]], np.float32)
LOBE_RADIUS = 0.45
RES = 32
AABB = np.asarray([[-1.0] * 3, [1.0] * 3], np.float32)
UNIT = 2.0 / 31.0
SMALL = dict(diffuse_sample_num=16, specular_sample_num=8,
             nis_diffuse_sample_num=4, nis_specular_sample_num=4,
             grid_size=(16, 16, 16), light_reso=8, mat_n_comp=4,
             estimator_dtype='f32')
JCFG = jmc.MCShadingConfig(**SMALL)
PCFG = pmc.MCShadingConfig(**SMALL)
PHASES = {
    'no_nis': dict(),
    'nis_loss': dict(nis_loss_diffuse=True, nis_loss_specular=True),
    'nis_sampling': dict(nis_sample_diffuse=True, nis_sample_specular=True,
                         nis_loss_diffuse=True, nis_loss_specular=True),
    'all_no_copy': dict(),
    'all_copy': dict(nis_sample_diffuse=True),
    'all_loss': dict(nis_sample_diffuse=True, nis_loss_diffuse=True),
    'realnvp_sampling': dict(nis_sample_diffuse=True,
                             nis_sample_specular=True,
                             nis_loss_diffuse=True, nis_loss_specular=True),
}
ALL = dict(shade_fn='shade_mixed_all', use_nis_all=True, nis_sample_num=4)
# the shader options each case runs with
PHASE_CFG = {'all_no_copy': ALL, 'all_copy': ALL, 'all_loss': ALL,
             'realnvp_sampling': dict(flow_type='realnvp')}


def two_lobe_sdf(pts):
    d = np.linalg.norm(pts[..., None, :] - LOBE_CENTERS, axis=-1)
    return (d - LOBE_RADIUS).min(-1)


def _t(x):
    return torch.tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol, atol, msg=''):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _prior_draw(key, cfg, pn, sn):
    """A flow prior's draw from its key (flow.py:89, 425): realnvp's
    normals, else the lattice's azimuth roll."""
    if cfg.flow_type == 'realnvp':
        return jax.random.normal(key, (pn, sn, 2))
    return jax.random.uniform(key, (pn, sn, 1))


def jax_shade_noise(key, cfg, pn, phase):
    """The shader's draws, from the keys it splits, as numpy: shade_mixed
    four ways (mc_shading.py:487; samplers.py:146,188; flow.py:89),
    shade_mixed_all two ways (k_f, k_a; mc_shading.py:683)."""
    if cfg.shade_fn == 'shade_mixed_all':
        k_f, k_a = jax.random.split(key)
        noise = {'az_all': jax.random.uniform(k_a, (pn, 1, 1))}
        if phase.nis_sample_diffuse:
            noise['flow_all'] = _prior_draw(k_f, cfg, pn, cfg.nis_sample_num)
        return {k: _t(v) for k, v in noise.items()}
    k_d, k_s, k_da, k_sa = jax.random.split(key, 4)
    noise = {'az_diffuse': jax.random.uniform(k_da, (pn, 1, 1)),
             'az_specular': jax.random.uniform(k_sa, (pn, 1, 1))}
    if phase.nis_sample_diffuse:
        noise['flow_diffuse'] = _prior_draw(k_d, cfg, pn,
                                            cfg.nis_diffuse_sample_num)
    if phase.nis_sample_specular:
        noise['flow_specular'] = _prior_draw(k_s, cfg, pn,
                                             cfg.nis_specular_sample_num)
    return {k: _t(v) for k, v in noise.items()}


def _rates_close(pstats, jstats, n_rays):
    """The trace's candidate / hit / a1 rates, to two rays: a ray whose
    probe value sits within float32 rounding of a certification threshold
    is classified either way (XLA's fused multiply-adds round differently
    from separate operations).  Such a ray is only refined more or less
    carefully; its hit verdict and light do not change."""
    for k in ('secondary_cand_rate', 'secondary_hit_rate',
              'secondary_a1_rate'):
        if k in jstats or k in pstats:
            assert abs(float(pstats[k]) - float(jstats[k])) \
                <= 2.5 / n_rays, k


def _port_pg(jpg):
    return packed_sdf_grid_from_jax(
        np.asarray(jpg.mid_rows), np.asarray(jpg.blocks),
        np.asarray(jpg.coarse_rows), np.asarray(jpg.aabb), jpg.reso,
        None if jpg.vis_rows is None else np.asarray(jpg.vis_rows),
        jpg.vis_pad)


@pytest.fixture(scope='module')
def scene():
    xs = np.linspace(-1, 1, RES, dtype=np.float32)
    vals = two_lobe_sdf(np.stack(np.meshgrid(xs, xs, xs, indexing='ij'),
                                 -1)).astype(np.float32)
    jdense = jst.SDFGrid(values=jnp.asarray(vals), aabb=jnp.asarray(AABB))
    jpg = jst.bake_vis_cache(jst.pack_sdf_grid(jdense), apex_pad=2.0 * UNIT)
    rng = np.random.RandomState(0)
    pn = 24
    # surface points that mostly face the other lobe, so that a good
    # share of their secondary rays is occluded
    which = rng.randint(0, 2, 4 * pn)
    n = rng.randn(4 * pn, 3).astype(np.float32)
    n[:, 0] += 1.5 * (1 - 2 * which)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lobe = LOBE_CENTERS[which]
    pts = lobe + n * LOBE_RADIUS
    keep = np.where(two_lobe_sdf(pts) > -1e-3)[0][:pn]
    pts, n = pts[keep], n[keep]
    # views on the normal's side, well off the normal itself (arccos pole)
    v = rng.randn(pn, 3).astype(np.float32)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) + 1.2 * n
    v /= np.linalg.norm(v, axis=-1, keepdims=True)

    def grow(p, key):
        # the fields start 1e-4 small and the predictors near constants:
        # scale the fields up so that materials and flows vary by point
        for name in ('mat_field', 'flow_diffuse', 'flow_specular',
                     'flow_all'):
            if name not in p:
                continue
            f = p[name]['field'] if name.startswith('flow') else p[name]
            f['planes'] = [x * 3e3 for x in f['planes']]
        base = p['outer_light']['base']
        p['outer_light']['base'] = base + 0.5 * jax.random.normal(
            key, base.shape)
        return p

    def params(over, k0, k1):
        return grow(jmc.init_mc_shading(jax.random.PRNGKey(k0),
                                        JCFG._replace(**over)),
                    jax.random.PRNGKey(k1))

    jp = params({}, 1, 2)
    jcopies = params({}, 3, 4)
    # shade_mixed_all: flow_all drawn from another key than flow_diffuse
    jp_all = dict(jp, flow_all=params({}, 5, 6)['flow_diffuse'])
    jp_nvp = params(PHASE_CFG['realnvp_sampling'], 1, 2)
    jc_nvp = params(PHASE_CFG['realnvp_sampling'], 3, 4)
    return dict(jdense=jdense, jpg=jpg, pdense=sdf_grid_from_jax(vals, AABB),
                ppg=_port_pg(jpg), pts=pts, n=n, v=v, pn=pn, jp=jp,
                jcd=jcopies['flow_diffuse'], jcs=jcopies['flow_specular'],
                jp_all=jp_all, jp_nvp=jp_nvp,
                jcd_nvp=jc_nvp['flow_diffuse'],
                jcs_nvp=jc_nvp['flow_specular'])


def _pparams(jp):
    pp = params_from_jax(_np(jp))
    for t in jax.tree.leaves(pp):
        t.requires_grad_(True)
    return pp


def _dirs(scene, sn, seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(scene['pn'], sn, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    flip = (np.sum(d * scene['n'][:, None], -1) < 0) \
        & (rng.rand(scene['pn'], sn) < 0.8)
    return np.where(flip[..., None], -d, d).astype(np.float32)


GET_LIGHTS_CASES = {
    'budgeted': ('pg', dict()),
    'budgeted_dense_inner': ('pg', dict(inner_light_budget=0.0)),
    'budgeted_no_cache': ('pg', dict(a1_budget=0.0)),
    'packed_dense': ('pg', dict(secondary_budget=0.0)),
    'dense_grid': ('dense', dict()),
    'dense_grid_dense_inner': ('dense', dict(inner_light_budget=0.0)),
}


@pytest.mark.parametrize('case', sorted(GET_LIGHTS_CASES))
def test_get_lights_branches(scene, case):
    """Lights to rtol 1e-4 (exp of a float32 MLP), hit masks exact, and the
    gradient of a projection of the lights w.r.t. the light parameters to
    5e-3 of its largest magnitude (the last layer's three gain gradients
    are sums of cancelling terms: recomputed in float64 they lie between
    the two float32 results, 1e-3 from either)."""
    which, over = GET_LIGHTS_CASES[case]
    jcfg, pcfg = JCFG._replace(**over), PCFG._replace(**over)
    sn = 12
    d = _dirs(scene, sn, 5)
    pts = np.broadcast_to(scene['pts'][:, None], d.shape)
    proj = np.random.RandomState(6).randn(scene['pn'], sn, 3).astype(
        np.float32)
    jgrid = scene['jpg'] if which == 'pg' else scene['jdense']
    pgrid = scene['ppg'] if which == 'pg' else scene['pdense']

    def jloss(p):
        stats = {}
        lights, hit = jmc.get_lights(
            p, jcfg, jgrid, UNIT, jnp.asarray(pts), jnp.asarray(d),
            normals=jnp.asarray(scene['n']), stats=stats)
        return jnp.sum(lights * proj), (lights, hit, stats)

    # jitted, as the JAX trainer runs it
    (_, (jl, jh, jstats)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(scene['jp'])
    pp = _pparams(scene['jp'])
    pstats = {}
    pl, ph = pmc.get_lights(pp, pcfg, pgrid, UNIT, _t(pts), _t(d),
                            normals=_t(scene['n']), stats=pstats)
    torch.sum(pl * _t(proj)).backward()
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert 0.02 < np.asarray(jh).mean() < 0.9
    _close(pl, jl, rtol=1e-4, atol=1e-5, msg='lights')
    assert sorted(pstats) == sorted(jstats)
    _rates_close(pstats, jstats, scene['pn'] * sn)
    for name in ('inner_light', 'outer_light'):
        for jleaf, pleaf in zip(jax.tree.leaves(jg[name]),
                                jax.tree.leaves(pp[name])):
            jleaf = np.asarray(jleaf)
            scale = float(np.abs(jleaf).max()) + 1e-12
            np.testing.assert_allclose(pleaf.grad.numpy() / scale,
                                       jleaf / scale, atol=5e-3,
                                       err_msg=f'{case} grad {name}')


def test_get_lights_callable_tracer_hook(scene):
    """An exact tracer handed in as a callable owns all origin offsets."""
    sn = 6
    d = _dirs(scene, sn, 7)
    pts = np.broadcast_to(scene['pts'][:, None], d.shape)

    def analytic(o, dd, xp):
        # ray / lobe-0 sphere intersection
        oc = o - LOBE_CENTERS[0]
        b = xp.sum(oc * dd, -1)
        c = xp.sum(oc * oc, -1) - LOBE_RADIUS ** 2
        disc = b * b - c
        t = -b - xp.sqrt(xp.clip(disc, 0.0, None))
        hit = (disc > 0) & (t > 1e-3)
        inters = o + dd * t[:, None]
        nrm = (inters - LOBE_CENTERS[0]) / LOBE_RADIUS
        depth = xp.where(hit, t, 10.0)[:, None]
        return inters, nrm, depth, hit

    jl, jh = jmc.get_lights(
        scene['jp'], JCFG, lambda o, dd: analytic(o, dd, jnp), UNIT,
        jnp.asarray(pts), jnp.asarray(d))

    def ptracer(o, dd):
        return analytic(o, dd, _TorchNP)
    pl, ph = pmc.get_lights(params_from_jax(_np(scene['jp'])), PCFG, ptracer,
                            UNIT, _t(pts), _t(d))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    _close(pl, jl, rtol=1e-4, atol=1e-5)


class _TorchNP:
    """The three numpy-style functions the analytic tracer uses."""
    sum = staticmethod(lambda a, dim: torch.sum(a, dim))
    sqrt = staticmethod(torch.sqrt)
    clip = staticmethod(lambda a, lo, hi: torch.clamp(a, min=lo, max=hi))
    where = staticmethod(lambda c, a, b: torch.where(
        c, a, torch.full_like(a, b)))


def _scene_params(scene, name):
    """(params, diffuse copy, specular copy) of a case (JAX trees)."""
    if name.startswith('realnvp'):
        return scene['jp_nvp'], scene['jcd_nvp'], scene['jcs_nvp']
    if name.startswith('all'):
        copies = name != 'all_no_copy'
        return scene['jp_all'], scene['jcd'] if copies else None, None
    if name == 'nis_sampling':
        return scene['jp'], scene['jcd'], scene['jcs']
    return scene['jp'], None, None


def _run_phase(scene, name, jcfg, pcfg, with_grads=True):
    jcfg = jcfg._replace(**PHASE_CFG.get(name, {}))
    pcfg = pcfg._replace(**PHASE_CFG.get(name, {}))
    jphase = jmc.ShadePhase(**PHASES[name])
    pphase = pmc.ShadePhase(**PHASES[name])
    key = jax.random.PRNGKey(21)
    rng = np.random.RandomState(8)
    proj = rng.randn(scene['pn'], 3).astype(np.float32)
    jp, jcd, jcs = _scene_params(scene, name)

    def jloss(p):
        out = jmc.mc_forward(
            p, jcfg, scene['jpg'], UNIT, jnp.asarray(AABB),
            jnp.asarray(scene['pts']), jnp.asarray(scene['v']),
            jnp.asarray(scene['n']), jphase, key, True, jcd, jcs)
        loss = (jnp.sum(out['rgb_pr'] * proj) + 10.0 * out['loss_nis']
                + jnp.sum(out['diffuse_light']))
        return loss, out

    if with_grads:
        (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    else:
        jout, jg = jax.jit(lambda p: jloss(p)[1])(jp), None
    pp = _pparams(jp)
    noise = jax_shade_noise(key, jcfg, scene['pn'], jphase)
    pout = pmc.mc_forward(
        pp, pcfg, scene['ppg'], UNIT, _t(AABB), _t(scene['pts']),
        _t(scene['v']), _t(scene['n']), pphase, noise, True,
        None if jcd is None else params_from_jax(_np(jcd)),
        None if jcs is None else params_from_jax(_np(jcs)))
    if with_grads:
        (torch.sum(pout['rgb_pr'] * _t(proj)) + 10.0 * pout['loss_nis']
         + torch.sum(pout['diffuse_light'])).backward()
    return jout, jg, pout, pp


@pytest.mark.parametrize('phase', sorted(PHASES))
def test_mc_forward_outputs_and_param_grads(scene, phase):
    """Every output to rtol 2e-4 / atol 2e-5 (sums over samples of float32
    BRDF weights up to ~1e3); every parameter gradient to 2e-3 of its
    largest magnitude (absolute 1e-9 for leaves whose gradient is 0)."""
    jout, jg, pout, pp = _run_phase(scene, phase, JCFG, PCFG)
    assert sorted(pout) == sorted(jout)
    flags = PHASES[phase]
    if phase.startswith('all'):
        n_rays = JCFG.diffuse_sample_num + (
            ALL['nis_sample_num'] if flags else 0)
    else:
        n_rays = JCFG.diffuse_sample_num + (
            JCFG.nis_diffuse_sample_num if flags.get('nis_sample_diffuse')
            else 0) + (JCFG.nis_specular_sample_num
                       if flags.get('nis_sample_specular')
                       else JCFG.specular_sample_num)
    _rates_close(pout, jout, scene['pn'] * n_rays)
    for k, v in jout.items():
        if not k.startswith('secondary_'):
            _close(pout[k], v, rtol=2e-4, atol=2e-5, msg=f'{phase} {k}')
    if flags.get('nis_loss_diffuse'):
        assert abs(float(jout['loss_nis'])) > 1e-6
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    for (path, jleaf), pleaf in zip(jleaves, jax.tree.leaves(pp)):
        jleaf = np.asarray(jleaf)
        scale = float(np.abs(jleaf).max())
        got = np.zeros_like(jleaf) if pleaf.grad is None \
            else pleaf.grad.numpy()
        np.testing.assert_allclose(
            got / (scale + 1e-9), jleaf / (scale + 1e-9), atol=2e-3,
            err_msg=f'{phase} grad {jax.tree_util.keystr(path)}')


def test_mc_forward_bf16_estimator_is_close_to_jax(scene):
    """estimator_dtype='bf16': both sides round the wide estimator chains
    to bfloat16 (8 bits of mantissa) but at different points, and with 16
    + 8 samples a point one rounded weight moves a colour visibly: colours
    agree to 8e-2 absolute and 2e-2 on average, the NIS loss to 10
    percent."""
    jout, _, pout, _ = _run_phase(
        scene, 'nis_loss', JCFG._replace(estimator_dtype='bf16'),
        PCFG._replace(estimator_dtype='bf16'), with_grads=False)
    for k in ('rgb_pr', 'diffuse_color', 'specular_color', 'visibility',
              'diffuse_light'):
        _close(pout[k], jout[k], rtol=0, atol=8e-2, msg=k)
        assert float(np.abs(pout[k].detach().numpy()
                            - np.asarray(jout[k])).mean()) \
            < 2e-2, k
        assert pout[k].dtype == torch.float32
    _close(pout['loss_nis'], jout['loss_nis'], rtol=0.1, atol=1e-3)


def test_eval_shade_uses_no_noise_and_unported_options_raise(scene):
    """An evaluation takes no azimuth roll; the options that once raised
    (shade_mixed_all, use_nis_all, the realnvp and pwlinear flows)
    initialise with the JAX trees' shapes."""
    pp = params_from_jax(_np(scene['jp']))
    args = (pp, PCFG, scene['ppg'], UNIT, _t(AABB), _t(scene['pts']),
            _t(scene['v']), _t(scene['n']), pmc.ShadePhase())
    with torch.no_grad():
        a = pmc.mc_forward(*args, {'az_diffuse': torch.rand(24, 1, 1)},
                           False)
        b = pmc.mc_forward(*args, None, False)
    assert torch.equal(a['rgb_pr'], b['rgb_pr'])
    for over in (dict(shade_fn='shade_mixed_all'), dict(use_nis_all=True),
                 dict(flow_type='realnvp'), dict(flow_type='pwlinear')):
        pi = pmc.init_mc_shading(torch.Generator().manual_seed(0),
                                 PCFG._replace(**over))
        ji = jmc.init_mc_shading(jax.random.PRNGKey(0),
                                 JCFG._replace(**over))
        assert {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                jax.tree_util.tree_leaves_with_path(pi)} == \
            {jax.tree_util.keystr(p): v.shape for p, v in
             jax.tree_util.tree_leaves_with_path(ji)}, over


def test_init_mc_shading_tree_matches_jax(scene):
    pp = pmc.init_mc_shading(torch.Generator().manual_seed(0), PCFG)
    jshapes = {jax.tree_util.keystr(p): v.shape for p, v in
               jax.tree_util.tree_leaves_with_path(scene['jp'])}
    pshapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_leaves_with_path(pp)}
    assert pshapes == jshapes
    noise = pmc.draw_shade_noise(torch.Generator().manual_seed(0), PCFG, 5,
                                 pmc.ShadePhase(nis_sample_diffuse=True),
                                 'cpu')
    assert {k: tuple(v.shape) for k, v in noise.items()} == {
        'flow_diffuse': (5, 4, 1), 'az_diffuse': (5, 1, 1),
        'az_specular': (5, 1, 1)}


def test_draw_noise_variants_and_eval_noise():
    """draw_shade_noise's keys and shapes for shade_mixed_all and realnvp;
    draw_eval_noise draws only for realnvp's Gaussian prior."""
    gen = torch.Generator().manual_seed(0)
    ph = pmc.ShadePhase(nis_sample_diffuse=True, nis_sample_specular=True)
    shapes = lambda d: {k: tuple(v.shape) for k, v in d.items()}  # noqa
    cfg_all = PCFG._replace(**ALL)
    assert shapes(pmc.draw_shade_noise(gen, cfg_all, 5, ph, 'cpu')) == {
        'flow_all': (5, 4, 1), 'az_all': (5, 1, 1)}
    cfg_nvp = PCFG._replace(flow_type='realnvp')
    assert shapes(pmc.draw_shade_noise(gen, cfg_nvp, 5, ph, 'cpu')) == {
        'flow_diffuse': (5, 4, 2), 'flow_specular': (5, 4, 2),
        'az_diffuse': (5, 1, 1)}
    assert pmc.draw_eval_noise(gen, PCFG, 5, 'cpu') == {}
    assert shapes(pmc.draw_eval_noise(gen, cfg_nvp, 5, 'cpu')) == {
        'flow_diffuse': (5, 4, 2), 'flow_specular': (5, 4, 2)}
    assert shapes(pmc.draw_eval_noise(
        gen, cfg_all._replace(flow_type='realnvp'), 5, 'cpu')) == {
        'flow_all': (5, 4, 2)}


def test_eval_nis_pass_with_realnvp_takes_jax_draws(scene):
    """The _nis pass of an evaluation with realnvp flows: the Gaussian
    prior draws from the key the JAX shader is given (is_train False);
    handed in, the outputs agree as in the training phases."""
    jcfg = JCFG._replace(flow_type='realnvp')
    pcfg = PCFG._replace(flow_type='realnvp')
    ph = dict(nis_sample_diffuse=True, nis_sample_specular=True)
    key = jax.random.PRNGKey(9)
    jout = jax.jit(lambda p: jmc.mc_forward(
        p, jcfg, scene['jpg'], UNIT, jnp.asarray(AABB),
        jnp.asarray(scene['pts']), jnp.asarray(scene['v']),
        jnp.asarray(scene['n']), jmc.ShadePhase(**ph), key, False,
        scene['jcd_nvp'], scene['jcs_nvp']))(scene['jp_nvp'])
    noise = {k: v for k, v in jax_shade_noise(
        key, jcfg, scene['pn'], jmc.ShadePhase(**ph)).items()
        if k.startswith('flow')}
    with torch.no_grad():
        pout = pmc.mc_forward(
            params_from_jax(_np(scene['jp_nvp'])), pcfg, scene['ppg'], UNIT,
            _t(AABB), _t(scene['pts']), _t(scene['v']), _t(scene['n']),
            pmc.ShadePhase(**ph), noise, False,
            params_from_jax(_np(scene['jcd_nvp'])),
            params_from_jax(_np(scene['jcs_nvp'])))
    for k in ('rgb_pr', 'diffuse_color', 'specular_color', 'visibility'):
        _close(pout[k], jout[k], rtol=2e-4, atol=2e-5, msg=k)
