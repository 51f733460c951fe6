"""The stage-2 trainer's options beyond the published configs, in the port:
the frozen-copy schedule of use_nis_all against the JAX MaterialTrainer's
(both settings of use_nis_diffuse), the phase flags that gate the
combined flow's NIS loss, and a short CPU run of each variant (pwlinear,
realnvp, shade_mixed_all with use_nis_all, disable_tensorial +
disable_reflected) through the three NIS phases, validation, and a
checkpoint round trip that resets every flow (flow_all included).

The schedule is compared as the trees each slot holds: equal arrays,
exactly.
"""
import types

import jax
import numpy as np
import pytest
import torch

from tensoflow_tpu.fields import mc_shading as jmc
from tensoflow_tpu.train.trainer_mat import MaterialTrainer as JaxMatTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import params_from_jax
from tensoflow_tpu_torch.fields import mc_shading as pmc
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

from test_torch_port_rules import SMALL_MAT, _small_geo_checkpoint

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

SCHED = dict(nis_start_iter=2, nis_update_interval=3, nis_loss_iter=1,
             grid_size=(8, 8, 8), mat_n_comp=2, diffuse_sample_num=8,
             specular_sample_num=4, light_reso=8)


def _stub(mod_cfg, params):
    return types.SimpleNamespace(
        rcfg=types.SimpleNamespace(shader=mod_cfg), params=params,
        flow_copies={})


@pytest.mark.parametrize('use_nis_diffuse', [False, True])
def test_flow_copy_slots_match_jax(use_nis_diffuse):
    """use_nis_all puts flow_all's copy in the 'diffuse' slot before
    flow_diffuse's (which then replaces it); phase() gates the NIS loss
    on use_nis_diffuse / use_nis_specular only.  Both quirks of the
    reference, the same in both packages."""
    over = dict(SCHED, shade_fn='shade_mixed_all', use_nis_all=True,
                use_nis_diffuse=use_nis_diffuse, use_nis_specular=False)
    jcfg = jmc.MCShadingConfig(**over)
    pcfg = pmc.MCShadingConfig(**over)
    jp = jmc.init_mc_shading(jax.random.PRNGKey(0), jcfg)
    # tell the two flows apart (JAX draws both from one key)
    jp['flow_all'] = jax.tree.map(lambda x: x + 1.0, jp['flow_all'])
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    js, ps = _stub(jcfg, jp), _stub(pcfg, pp)
    for step in range(9):
        JaxMatTrainer.update_flow_copies(js, step)
        MaterialTrainer.update_flow_copies(ps, step)
        assert sorted(ps.flow_copies) == sorted(js.flow_copies), step
        for slot, jtree in js.flow_copies.items():
            for a, b in zip(jax.tree.leaves(jtree),
                            jax.tree.leaves(ps.flow_copies[slot])):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        if 'diffuse' in js.flow_copies:
            src = 'flow_diffuse' if use_nis_diffuse else 'flow_all'
            np.testing.assert_array_equal(
                jax.tree.leaves(ps.flow_copies['diffuse'])[0].numpy(),
                np.asarray(jax.tree.leaves(jp[src])[0]))
        assert tuple(MaterialTrainer.phase(ps, step)) == \
            tuple(JaxMatTrainer.phase(js, step)), step
    # the copy is taken at nis_start_iter - 1 and refreshed every interval
    assert 'diffuse' in ps.flow_copies


VARIANTS = {
    'pwlinear': dict(flow_type='pwlinear'),
    'realnvp': dict(flow_type='realnvp'),
    'all': dict(shade_fn='shade_mixed_all', use_nis_all=True,
                use_nis_diffuse=True, nis_sample_num=4),
    'disable': dict(disable_tensorial=True, disable_reflected=True),
}


@pytest.fixture(scope='module')
def geo_path(tmp_path_factory):
    return _small_geo_checkpoint(tmp_path_factory.mktemp('geo'))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_material_variant_trains_validates_and_resumes(variant, geo_path,
                                                       tmp_path):
    cfg = dict(SMALL_MAT, shader_cfg=dict(SMALL_MAT['shader_cfg'],
                                          **VARIANTS[variant]))
    t = MaterialTrainer(pconfig.load_config(extra=cfg), geo_path,
                        device='cpu')
    flows = sorted(k for k in t.params if k.startswith('flow'))
    assert ('flow_all' in flows) == (variant == 'all')
    before = {k: t.params[k]['blocks'][0]['layers'][0]['w'].detach().clone()
              for k in flows}
    logs = t.train(n_steps=4, log_every=1)
    assert t.phase(3).nis_sample_diffuse and 'diffuse' in t.flow_copies
    for row in logs:
        assert all(np.isfinite(v) for v in row.values()), row
    assert any(abs(r['loss_nis']) > 0 for r in logs), logs
    moved = [k for k in flows if not torch.equal(
        before[k], t.params[k]['blocks'][0]['layers'][0]['w'])]
    assert moved, variant
    psnr = t.validate(max_views=1, downsample=0.25)
    assert np.isfinite(psnr)
    path = str(tmp_path / 'mat.pt')
    t.save(path)
    t2 = MaterialTrainer(pconfig.load_config(extra=cfg), geo_path,
                         device='cpu')
    t2.load(path)
    assert t2.flow_copies == {} and t2.start_step == 4
    assert sorted(k for k in t2.params if k.startswith('flow')) == flows
