"""The stage-1 step as a CUDA graph (ShapeTrainer.train_step through
train/engine.py's StageTrainer and StepGraph).

On the CPU: the graph's body, which reads the anneal ratio and the
schedule weights as 0-d views by name of one tensor, against the eager step, which takes
them as Python floats, over the cut schedule of the benchmark's cell
(upsamples after steps 2 and 4, the alpha mask after step 2, the phases
at 3); and the step key, which must hold over steady steps and change
wherever the step's control flow or the tensors it reads change.  On the
card (marked ``cuda``): graphed and eager trainers from one seed.
"""
import os

import pytest
import torch

from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.ops import stencil
from tensoflow_tpu_torch.train import engine, losses
from tensoflow_tpu_torch.train.trainer import ShapeTrainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, 'configs/shape/syn/compressor.yaml')
# the benchmark cell's cut schedule (bench_port/configs/shape_compressor)
CUT = ['split_manul=false', 'upsample_list=[2,4]',
       'update_AlphaMask_lst=[2]', 'occ_loss_step=3',
       'radiance_field_step=3', 'gaussianLoss_step=3', 'freeze_inv_s_step=3']
TINY = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
        'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=32768',
        'train_ray_num=32', 'n_samples=8', 'n_importance=8',
        'occ_loss_max_pn=32', 'init_radius=0.5']


def _config(extra=(), seed=5):
    cfg = pconfig.load_config(CFG_PATH, overrides=CUT + list(extra))
    cfg['random_seed'] = seed
    return cfg


def _recorded(trainer, step_fn):
    """Have trainer.train call step_fn, and record each step's terms, and
    its gradients and parameters after Adam."""
    rec = []

    def train_step(step, batch, weights, noise, radiance_on, occ_on):
        aux = step_fn(step, batch, weights, noise, radiance_on, occ_on)
        rec.append({'aux': aux,
                    'grads': [t.grad.clone() for t in trainer.opt.params],
                    'params': [t.detach().clone()
                               for t in trainer.opt.params]})
        return aux
    trainer.train_step = train_step
    return rec


def _rel(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / max(float(torch.linalg.norm(a.double())), 1e-30))


def test_device_scalars_step_matches_float_scalars_step():
    """Losses, gradients and parameters after Adam within 1e-6 relative
    (each tensor's norm) over steps 0-7; the anneal ratio as a float32
    tensor may round 1 - ratio an ulp apart from Python's."""
    cfg = _config(TINY)
    eager = ShapeTrainer(cfg, device='cpu')
    ref = _recorded(eager, eager.train_step)
    dev = ShapeTrainer(cfg, device='cpu')

    def device_scalars_step(step, batch, weights, noise, radiance_on,
                            occ_on):
        dev.opt.zero_grad()
        _, scalars = engine.scalar_views({**dev.step_scalars(step),
                                          **weights})
        keys, vals = dev._graph_body(step, batch, noise, scalars,
                                     radiance_on, occ_on)
        dev.opt.step()
        return dict(zip(keys, vals.unbind(0)))
    got = _recorded(dev, device_scalars_step)
    eager.train(n_steps=8, log_every=100)
    dev.train(n_steps=8, log_every=100)
    assert len(ref) == len(got) == 8
    assert list(eager.rcfg.sdf.grid_size) == list(dev.rcfg.sdf.grid_size)
    assert eager.rcfg.sdf.n_levels == 3 and dev.alpha_mask is not None
    for step, (a, b) in enumerate(zip(ref, got)):
        assert list(a['aux']) == list(b['aux']), step
        for k, v in a['aux'].items():
            assert _rel(v.float(), b['aux'][k]) <= 1e-6, (step, k)
        for what in ('grads', 'params'):
            assert len(a[what]) == len(b[what])
            for i, (x, y) in enumerate(zip(a[what], b[what])):
                assert _rel(x, y) <= 1e-6, (step, what, i)


def test_step_key_holds_over_steady_steps_and_changes_with_the_step():
    """The same over steady steps whose weights' values differ; another
    at each phase gate that flips (here one gate a step), on an upsample,
    on an alpha-mask refresh and on the route.  On the CPU no graph
    engages."""
    cfg = _config(TINY + ['freeze_inv_s_step=2', 'gaussianLoss_step=3',
                          'radiance_field_step=5', 'occ_loss_step=8'])
    t = ShapeTrainer(cfg, device='cpu')
    t.init_dataset()
    assert not t.graph_engages()
    batch = engine.batch_to_device(t.batcher.next_batch(), t.device)
    noise = t.step_noise(0)

    def key(step):
        return t.step_key(step, batch, losses.schedule_weights(cfg, step),
                          noise, *t.phase_flags(step))

    keys = [key(s) for s in range(10)]
    assert losses.schedule_weights(cfg, 0) != \
        losses.schedule_weights(cfg, 1)
    # gates flip at 2 (freeze), 4 (Gaussian), 6 (radiance), 8 (occ loss)
    for s in range(1, 10):
        assert (keys[s] == keys[s - 1]) == (s % 2 == 1), s
    k = key(2)
    assert t.maybe_upsample(2)
    k_up = key(2)
    assert k_up != k
    t.maybe_update_alpha_mask(2)
    k_mask = key(2)
    assert t.alpha_mask is not None and k_mask != k_up
    assert key(2) == k_mask
    t.rcfg = t.rcfg._replace(use_occ_grid=True)
    assert key(2) != k_mask
    t.rcfg = t.rcfg._replace(use_occ_grid=False)
    t.train_step(2, batch, losses.schedule_weights(cfg, 2), noise,
                 *t.phase_flags(2))
    assert t.graph_stats == {'replayed': 0, 'eager': 1, 'captures': 0}


def _fake_cuda_graph(monkeypatch):
    """A stand-in for the CUDA graph on the CPU: the capture runs the body
    eagerly, a replay runs nothing."""
    import contextlib

    class FakeGraph:
        def replay(self):
            pass
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph',
                        lambda g: contextlib.nullcontext())


def test_capture_runs_without_garbage_collection(monkeypatch):
    """StepGraph.capture turns the cyclic garbage collector off around the
    capture (freeing another CUDA graph there would end it) and back on
    after it, also when the body raises; a stand-in for the CUDA graph
    records what the body saw, the step's scalars by name."""
    import gc

    _fake_cuda_graph(monkeypatch)
    seen = []

    def body(batch, noise, scalars):
        seen.append(gc.isenabled())
        return ['loss'], (batch['rays_o'] * scalars['anneal']).sum(
        ).reshape(1)

    leaf = torch.ones(3, requires_grad=True)
    g = engine.StepGraph(key=None, refs=())
    assert gc.isenabled()
    g.capture(body, {'rays_o': torch.ones(4)}, {'jitter': torch.zeros(2)},
              {'anneal': 2.0}, [leaf])
    assert seen == [False] and gc.isenabled()
    assert float(g.out[0]) == 8.0 and not g.grads[0].any()

    def failing(batch, noise, scalars):
        seen.append(gc.isenabled())
        raise RuntimeError('capture failed')
    with pytest.raises(RuntimeError):
        engine.StepGraph(None, ()).capture(
            failing, {'rays_o': torch.ones(4)}, {}, {'anneal': 1.0},
            [leaf])
    assert seen == [False, False] and gc.isenabled()


def test_replay_credits_registered_launch_counters(monkeypatch):
    """The kernels' launch counters are registered with utils/timing
    (ops/stencil.py's two, ops/tile_gather.py's), and StepGraph credits
    whatever is registered: a stand-in counter bumped in the capture is
    set back after it and credited with those launches once a replay;
    each replay copies the step's inputs and scalars in."""
    from tensoflow_tpu_torch.ops import tile_gather
    from tensoflow_tpu_torch.utils import timing

    registered = timing.LAUNCH_COUNTERS
    for counts in (stencil.LAUNCHES, stencil.GENERAL_LAUNCHES,
                   tile_gather.LAUNCHES):
        assert sum(c is counts for c in registered) == 1
    _fake_cuda_graph(monkeypatch)
    fake = timing.launch_counter({'fake_fwd': 5, 'fake_bwd': 1})
    try:
        def body(batch, noise, scalars):
            fake['fake_fwd'] += 2          # the launcher's count
            return ['loss'], (batch['rays_o'] * scalars['anneal']).sum(
            ).reshape(1)

        leaf = torch.ones(3, requires_grad=True)
        g = engine.StepGraph(key=None, refs=())
        g.capture(body, {'rays_o': torch.ones(4)}, {'jitter': torch.zeros(2)},
                  {'anneal': 2.0}, [leaf])
        assert fake == {'fake_fwd': 5, 'fake_bwd': 1}
        for n in range(1, 4):
            aux = g.replay({'rays_o': torch.full((4,), float(n))},
                           {'jitter': torch.ones(2)}, {'anneal': 0.5 * n},
                           [leaf])
            assert fake == {'fake_fwd': 5 + 2 * n, 'fake_bwd': 1}
            assert list(aux) == ['loss'] and float(aux['loss']) == 8.0
            assert torch.equal(g.inputs[0], torch.full((4,), float(n)))
            assert float(g.scalars[0]) == 0.5 * n
    finally:
        registered.remove(fake)


def _snapshot(t):
    """The parameters (restored in place), Adam's state (none before a
    leaf's first step) and its count."""
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
def test_graphed_step_matches_eager_on_the_card(monkeypatch):
    """The benchmark cell's configuration over a 12-step cut schedule
    (128^3 -> 256^3 -> 512^3), then a step under a profiler and one more.
    Graphed and eager trainers from one seed: the stencil head launches
    once forward and once backward a step on both; the profiled step runs
    eagerly; the graph is captured once a step key that lasts (two
    keys); every step's terms are tensors of their own; the loss terms
    and the parameters agree as two eager runs do (TOL).  Then one step
    at 512^3 from one state, replayed and eager: TOL's tighter pair."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config(['database_name=toy/sphere_128_12'], seed=3141592653)
    runs = {}
    for name in ('eager', 'graphed'):
        t = ShapeTrainer(cfg, device='cuda')
        if name == 'eager':
            monkeypatch.setattr(t, 'graph_engages', lambda: False)
        t.init_dataset()
        rec = _recorded(t, t.train_step)
        stencil.reset_launches()
        t.train(n_steps=12, log_every=100)
        launches = {**stencil.LAUNCHES, **stencil.GENERAL_LAUNCHES}
        stats = dict(t.graph_stats)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            t.train(n_steps=1, log_every=100)
        profiled = dict(t.graph_stats)
        t.train(n_steps=1, log_every=100)
        torch.cuda.synchronize()
        runs[name] = (t, rec, launches, stats, profiled)
    for name, (t, rec, launches, _, _) in runs.items():
        assert len(rec) == 14, name
        assert (launches['stencil_head_fwd']
                + launches['stencil_head_general_fwd']) == 12, launches
        assert (launches['stencil_head_bwd']
                + launches['stencil_head_general_bwd']) == 12, launches
    g, grec, _, stats, profiled = runs['graphed']
    # keys: steps 0-2, 3, 4, 5-11; two eager steps before each capture
    assert stats == {'replayed': 6, 'eager': 6, 'captures': 2}, stats
    assert profiled == {'replayed': 6, 'eager': 7, 'captures': 2}, profiled
    assert g.graph_stats == {'replayed': 7, 'eager': 7, 'captures': 2}
    assert runs['eager'][0].graph_stats == {
        'replayed': 0, 'eager': 14, 'captures': 0}
    storages = [{v.untyped_storage().data_ptr() for v in r['aux'].values()}
                for r in grec]
    assert sum(map(len, storages)) == len(set().union(*storages))
    erec = runs['eager'][1]
    terms = [_worst_term(a['aux'], b['aux']) for a, b in zip(erec, grec)]
    leaves = [_rel(x, y) for x, y in zip(erec[-1]['params'],
                                         grec[-1]['params'])]
    leaves.sort()
    median_leaf = leaves[len(leaves) // 2]

    # one 512^3 step from one state: replayed, then eager
    step = g.start_step
    batch = engine.batch_to_device(g.batcher.next_batch(), g.device)
    noise = g.step_noise(step)
    args = (step, batch, losses.schedule_weights(cfg, step), noise,
            *g.phase_flags(step))
    saved = _snapshot(g)
    aux_g = ShapeTrainer.train_step(g, *args)
    after_g = [p.detach().clone() for p in g.opt.params]
    assert g.graph_stats['replayed'] == 8
    _restore(g, saved)
    monkeypatch.setattr(g, 'graph_engages', lambda: False)
    aux_e = ShapeTrainer.train_step(g, *args)
    one_term = _worst_term(aux_e, aux_g)
    one_leaf = max(_rel(p.detach(), x) for p, x in zip(g.opt.params,
                                                        after_g))
    print(f'graphed vs eager, 14 steps: worst term / loss by step '
          f'{[f"{x:.1e}" for x in terms]}, median leaf {median_leaf:.2e}, '
          f'worst leaf {leaves[-1]:.2e}; one step from one state: worst '
          f'term / loss {one_term:.2e}, worst leaf {one_leaf:.2e}')
    assert max(terms[:3]) <= TOL['first_steps_term']
    assert max(terms) <= TOL['term']
    assert median_leaf <= TOL['median_leaf']
    assert leaves[-1] <= TOL['worst_leaf']
    assert one_term <= TOL['one_step_term']
    assert one_leaf <= TOL['one_step_leaf']


# every kind of step-key change, 4 steps apart (each key: two eager steps,
# a capture, a replay): the phase gates (freeze_inv_s_step at 4, the occ
# loss at 12, the radiance head after 19, the Gaussian loss after 27),
# upsamples after 7 and 23 (128^3 -> 256^3 -> 512^3), alpha-mask refreshes
# after 7 and 15, and a save and load after step 31
KEY_CHANGES = ['freeze_inv_s_step=4', 'upsample_list=[7,23]',
               'update_AlphaMask_lst=[7,15]', 'occ_loss_step=12',
               'radiance_field_step=19', 'gaussianLoss_step=27']


@pytest.mark.cuda
def test_graphed_run_checked_step_by_step_across_every_key_change(tmp_path):
    """A graphed run over 36 steps that cross nine step keys (KEY_CHANGES
    and a load), each step checked against the eager step from the same
    state, batch and draws: the graphed step's loss terms and its leaves
    after Adam within TOL's one-step pair of the eager step's.  The run
    goes on from the graphed step's state, so that a tensor the graph read
    by identity and that went stale would show.  graph_stats counts the
    captures and steps by path that the keys call for, and the stencil
    head launches once forward and once backward a step on each path."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config(['database_name=toy/sphere_128_12'] + KEY_CHANGES,
                  seed=2718281828)
    t = ShapeTrainer(cfg, device='cuda')
    t.init_dataset()
    keys, terms, leaves = [], [], []

    def checked_step(step, batch, weights, noise, radiance_on, occ_on):
        args = (step, batch, weights, noise, radiance_on, occ_on)
        keys.append(t.step_key(*args))
        saved = _snapshot(t)
        aux_e = t._eager_step(*args)
        after_e = [p.detach().clone() for p in t.opt.params]
        _restore(t, saved)
        aux_g = ShapeTrainer.train_step(t, *args)
        terms.append(_worst_term(aux_e, aux_g))
        leaves.append(max(_rel(x, p.detach())
                          for x, p in zip(after_e, t.opt.params)))
        return aux_g
    t.train_step = checked_step
    stencil.reset_launches()
    t.train(n_steps=32, log_every=100)
    assert list(t.rcfg.sdf.grid_size) == [512, 512, 512]
    path = str(tmp_path / 'step31.pt')
    t.save(path)
    t.load(path)
    assert t.start_step == 32
    t.train(n_steps=4, log_every=100)
    torch.cuda.synchronize()
    launches = {**stencil.LAUNCHES, **stencil.GENERAL_LAUNCHES}
    spans = [1]
    for a, b in zip(keys, keys[1:]):
        if a == b:
            spans[-1] += 1
        else:
            spans.append(1)
    print(f'step by step, graphed vs eager from one state: worst term / '
          f'loss {[f"{x:.1e}" for x in terms]}; worst leaf '
          f'{[f"{x:.1e}" for x in leaves]}; graph_stats {t.graph_stats}')
    assert spans == [4] * 9, spans
    assert t.graph_stats == {'replayed': 18, 'eager': 18, 'captures': 9}
    assert launches['stencil_head_fwd'] == launches['stencil_head_bwd'] \
        == 2 * 36, launches
    assert max(terms) <= TOL['one_step_term']
    assert max(leaves) <= TOL['one_step_leaf']


# Graphed vs eager on the card, relative; float32 atomics (index_add_)
# order sums differently from run to run, and the alpha mask and the occ
# loss's |sdf| selection carry such differences on.  Read on an NVIDIA H100
# 80GB HBM3 at seed 3141592653: two eager runs of the 14 steps, worst term
# / loss 6.3e-3 (5.8e-10 over steps 0-2), median leaf 2.3e-4, worst leaf
# 1.1e-2; graphed vs eager 4.4e-4 (1.8e-11), 4.6e-5, 9.9e-3; one step from
# one state, worst term 0, worst leaf 9.9e-9.
TOL = {'first_steps_term': 1e-6, 'term': 2e-2, 'median_leaf': 2e-3,
       'worst_leaf': 0.1, 'one_step_term': 1e-6, 'one_step_leaf': 1e-5}
