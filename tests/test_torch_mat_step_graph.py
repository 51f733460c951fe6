"""The stage-2 step as a CUDA graph (MaterialTrainer.train_step through
trainer.graphed_step and StepGraph).

On the CPU, at tests/test_torch_mat_reference.py's tiny widths: the
graph's body, which reads the material clamps' factor and the schedule
weights from one tensor, against the eager step, which takes them as
Python floats, in each NIS phase and past the clamps' end at step 2000;
and the step key, which must hold over steady NIS-sampling steps and
change wherever the step's control flow or the tensors it reads change.
On the card (marked ``cuda``): a trainer at the benchmark cell's widths,
each graphed step checked against the eager step from the same state.
"""
import os

import pytest
import torch

from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.fields import mc_shading
from tensoflow_tpu_torch.train import losses
from tensoflow_tpu_torch.train import trainer_mat
from tensoflow_tpu_torch.train.checkpoints import named_leaves
from tensoflow_tpu_torch.train.trainer import ShapeTrainer
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer
from test_torch_mat_reference import (GEO, PHASES, ROOT, _clone,
                                      _surface_batch, _trainer)

torch.set_num_threads(1)

# PHASES, and the NIS-sampling phase after the clamps' factor turns off
STEPS = {**PHASES, 'clamps_off': (2000, (True, True, True, True))}


@pytest.fixture(scope='module')
def geo_path(tmp_path_factory):
    cfg = pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/syn/compressor_occ.yaml'),
        overrides=GEO)
    path = str(tmp_path_factory.mktemp('geo') / 'geo.pt')
    ShapeTrainer(cfg, device='cpu').save(path)
    return path


def _with_copies(t):
    t.flow_copies = {'diffuse': _clone(t.params['flow_diffuse']),
                     'specular': _clone(t.params['flow_specular'])}
    return t


def _rel(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / max(float(torch.linalg.norm(a.double())), 1e-30))


@pytest.mark.parametrize('name', sorted(STEPS))
def test_device_scalars_step_matches_float_scalars_step(geo_path, name):
    """The loss terms, every leaf's gradient and the leaves after Adam
    within 1e-6 relative (each tensor's norm) of the eager step's, from
    two trainers of one seed fed the same batch and draws."""
    step, flags = STEPS[name]
    phase = mc_shading.ShadePhase(*flags)
    eager, dev = _trainer(geo_path), _trainer(geo_path)
    if flags[0]:
        _with_copies(eager)
        _with_copies(dev)
    batch = _surface_batch(11)
    noise = eager.step_noise(step, phase)
    weights = losses.schedule_weights(eager.cfg, step)
    aux = eager.train_step(step, batch, weights, noise, phase)
    assert eager.graph_stats == {'replayed': 0, 'eager': 1, 'captures': 0}

    dev.opt.zero_grad()
    scalars = torch.tensor(trainer_mat.step_scalars(step, weights))
    assert float(scalars[0]) == (1.0 if step < 2000 else 0.0)
    keys, vals = dev._graph_body(step, batch, noise, scalars,
                                 tuple(weights), phase)
    dev.opt.step()
    got = dict(zip(keys, vals.unbind(0)))
    assert list(aux) == keys
    assert 'loss_mat_reg' in got and 'secondary_cand_rate' in got
    assert (float(got.get('loss_nis', 0.0)) != 0.0) == flags[2]
    for k, v in aux.items():
        assert v.dtype == torch.float32 and v.shape == (), k
        assert _rel(v, got[k]) <= 1e-6, (k, float(v), float(got[k]))
    for a, b in zip(eager.opt.params, dev.opt.params):
        assert _rel(a.grad, b.grad) <= 1e-6
        assert _rel(a.detach(), b.detach()) <= 1e-6


def test_step_key_holds_over_steady_sampling_steps(geo_path):
    """The same key over steady NIS-sampling steps, across the clamps'
    end at step 2000 (a scalar of the step: step_scalars), while the
    step's scalars follow the step.  On the CPU no graph engages."""
    t = _with_copies(_trainer(geo_path))
    assert not t.graph_engages()
    batch = _surface_batch(11)

    def key(step):
        phase = t.phase(step)
        return t.step_key(step, batch, losses.schedule_weights(t.cfg, step),
                          t.step_noise(step, phase), phase)
    k = key(1000)
    assert all(key(s) == k for s in (1001, 1500, 1998, 1999, 2000, 2500))
    w = losses.schedule_weights(t.cfg, 1999)
    assert trainer_mat.step_scalars(1999, w)[0] == 1.0
    assert trainer_mat.step_scalars(2000, w)[0] == 0.0


def test_step_key_changes_with_the_step(geo_path):
    """Another key at each phase change, at each flow-copy refresh (the
    copies are fresh clones), at an adaptation that picks a new bucket
    (and the same key at one that keeps the buckets), on new parameters
    and on other shapes of the batch."""
    t = _trainer(geo_path)
    batch = _surface_batch(11)
    scfg = t.rcfg.shader

    def key(step, b=batch):
        phase = t.phase(step)
        return t.step_key(step, b, losses.schedule_weights(t.cfg, step),
                          t.step_noise(step, phase), phase)
    k_none, k_loss = key(scfg.nis_loss_iter - 1), key(scfg.nis_loss_iter)
    assert k_none != k_loss
    t.update_flow_copies(scfg.nis_start_iter - 1)
    assert sorted(t.flow_copies) == ['diffuse', 'specular']
    k_sample = key(scfg.nis_start_iter)
    assert len({k_none, k_loss, k_sample}) == 3
    # no refresh between two due steps
    t.update_flow_copies(scfg.nis_start_iter)
    assert key(scfg.nis_start_iter + 1) == k_sample
    t.update_flow_copies(scfg.nis_start_iter - 1
                         + scfg.nis_update_interval)
    k_fresh = key(scfg.nis_start_iter + scfg.nis_update_interval)
    assert k_fresh != k_sample
    # the budgets: 0.5 / 0.0625 here; rates that keep them, then rates
    # that move the secondary budget to another bucket
    assert (scfg.secondary_budget, scfg.inner_light_budget) == (0.5, 0.0625)
    t._adapt_secondary_budget(0.3, 0.03)
    assert t.rcfg.shader == scfg and key(2001) == k_fresh
    t._adapt_secondary_budget(0.1, 0.03)
    assert t.rcfg.shader.secondary_budget == 0.1875
    k_adapted = key(2001)
    assert k_adapted != k_fresh
    t.set_params(_clone(t.params))
    k_params = key(2001)
    assert k_params != k_adapted
    half = {k: v[:len(v) // 2] for k, v in batch.items()}
    assert key(2001, half) != k_params
    t.train_step(2001, batch, losses.schedule_weights(t.cfg, 2001),
                 t.step_noise(2001, t.phase(2001)), t.phase(2001))
    assert t.graph_stats == {'replayed': 0, 'eager': 1, 'captures': 0}


# ---------------------------------------------------------------------------
# on the card, at the benchmark cell's widths
# ---------------------------------------------------------------------------

MAT_CFG = os.path.join(ROOT, 'bench_port/configs/mat_compressor/'
                       'compressor.yaml')
GEO_CFG = os.path.join(ROOT, 'bench_port/configs/mat_compressor/'
                       'compressor_occ.yaml')
SCENE = ['database_name=toy/blobs_128_12', 'split_manul=false']
# one step from one state, graphed against eager: relative to the loss,
# and to each leaf's norm after Adam (stage 1's one-step pair).  Read on
# an NVIDIA H100 80GB HBM3 at seed 2718281828 over the 24 steps: worst
# term 0, worst leaf 1.8e-8.
TOL = {'one_step_term': 1e-6, 'one_step_leaf': 1e-5}


def _snapshot(t):
    """The parameters (restored in place), Adam's state and its count."""
    st = t.opt.opt.state
    return ([p.detach().clone() for p in t.opt.params],
            [{k: v.clone() for k, v in st.get(p, {}).items()}
             for p in t.opt.params],
            t.opt.count)


@torch.no_grad()
def _restore(t, saved):
    params, states, count = saved
    for p, v, st in zip(t.opt.params, params, states):
        p.copy_(v)
        t.opt.opt.state.pop(p, None)
        if st:
            t.opt.opt.state[p] = {k: x.clone() for k, x in st.items()}
    t.opt.count = count


def _worst_term(a, b):
    """The largest difference of two steps' loss terms, over the loss."""
    return max(abs(float(v) - float(b[k])) for k, v in a.items()
               if k.startswith('loss')) / abs(float(a['loss']))


@pytest.mark.cuda
def test_graphed_run_checked_step_by_step_across_a_refresh_and_an_adaptation(
        tmp_path):
    """A trainer at the cell's widths (the geometry: 16 stage-1 steps at
    compressor_occ.yaml's widths on the toy blobs, as the benchmark's
    set-up trains it) over 24 steps in four stretches: 996-1003 (the NIS
    sampling starts at 999: the flow copies are made, then the budgets
    adapted), 1996-2003 (with the secondary budget set one bucket above
    the adapted one: at 1999 the copies are refreshed and the adaptation
    picks a new bucket; the clamps end at 2000), then 1600-1603 and
    2004-2007 on one key, so that the clamps' factor flips on a live
    graph.  Each step is checked against the eager step from the same
    state, batch and draws: the loss terms and the leaves after Adam
    within TOL.  The run goes on from the graphed step's state, so that a
    copy or a parameter the graph read by identity and that went stale
    would show.  graph_stats counts the captures and steps by path that
    the keys call for; a step under a profiler runs eagerly, and the next
    one replays."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geo = ShapeTrainer(pconfig.load_config(GEO_CFG, overrides=SCENE),
                       device='cuda')
    geo.init_dataset()
    geo.train(n_steps=16, log_every=16)
    path = str(tmp_path / 'geo.pt')
    geo.save(path)
    del geo
    cfg = pconfig.load_config(MAT_CFG, overrides=SCENE)
    cfg['random_seed'] = 2718281828
    t = MaterialTrainer(cfg, path, device='cuda')
    t.init_dataset()
    keys, terms, leaves, steps = [], [], [], []

    def checked_step(step, batch, weights, noise, phase):
        args = (step, batch, weights, noise, phase)
        keys.append(t.step_key(*args))
        steps.append(step)
        saved = _snapshot(t)
        aux_e = t._eager_step(*args)
        after_e = [p.detach().clone() for p in t.opt.params]
        _restore(t, saved)
        aux_g = MaterialTrainer.train_step(t, *args)
        assert list(aux_g) == list(aux_e)
        terms.append(_worst_term(aux_e, aux_g))
        leaves.append(max(_rel(x, p.detach())
                          for x, p in zip(after_e, t.opt.params)))
        return aux_g
    t.train_step = checked_step
    t.start_step = 996
    t.train(n_steps=8, log_every=100)
    adapted = t.rcfg.shader.secondary_budget
    buckets = trainer_mat.SEC_BUDGET_BUCKETS
    above = buckets[min(buckets.index(adapted) + 1, len(buckets) - 1)]
    assert above != adapted
    t.rcfg = t.rcfg._replace(shader=t.rcfg.shader._replace(
        secondary_budget=above))
    copies = [id(x) for _, x in named_leaves(t.flow_copies)]
    t.start_step = 1996
    t.train(n_steps=8, log_every=100)
    assert copies != [id(x) for _, x in named_leaves(t.flow_copies)]
    assert t.rcfg.shader.secondary_budget != above
    for start in (1600, 2004):
        t.start_step = start
        t.train(n_steps=4, log_every=100)
    del t.train_step
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t.train(n_steps=1, log_every=100)
    profiled = dict(t.graph_stats)
    t.train(n_steps=1, log_every=100)
    torch.cuda.synchronize()
    spans = [1]
    for a, b in zip(keys, keys[1:]):
        if a == b:
            spans[-1] += 1
        else:
            spans.append(1)
    print(f'steps {steps}; key spans {spans}; worst term / loss '
          f'{[f"{x:.1e}" for x in terms]}; worst leaf '
          f'{[f"{x:.1e}" for x in leaves]}; graph_stats {t.graph_stats}')
    # 996-998; 999 (copies made); the adapted budget, if it moved; 1996-
    # 1998 (another budget); 1999 (refresh); 2000 on (the new bucket)
    assert keys[steps.index(999)] != keys[steps.index(998)]
    assert keys[steps.index(1999)] != keys[steps.index(1998)]
    assert keys[steps.index(2000)] != keys[steps.index(1999)]
    assert spans[-1] == 12 and spans[0] == 3
    want = {'replayed': sum(max(n - 2, 0) for n in spans),
            'eager': sum(min(n, 2) for n in spans),
            'captures': sum(n > 2 for n in spans)}
    assert profiled == {**want, 'eager': want['eager'] + 1}, profiled
    assert t.graph_stats == {**want, 'eager': want['eager'] + 1,
                             'replayed': want['replayed'] + 1}
    assert max(terms) <= TOL['one_step_term']
    assert max(leaves) <= TOL['one_step_leaf']
