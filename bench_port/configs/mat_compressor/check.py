"""The numbers that decide ``correct`` for ``mat_compressor``, from what
the system kept in set-up, against the plain reference beside this file.

* ``init``: the largest gap between the program's initial parameters and
  the reference's, drawn from the same seed (exact: limit 0).
* ``bake``: the largest gap, over a seeded sample of 4,096 voxels of the
  dense 256^3 bake, between the program's bake and the reference's plain
  evaluation of the frozen stage-1 field at the same nodes.
* ``bake_pack``: the largest gap between those voxels' values in the
  packed full-resolution blocks the trace reads and the bake's values
  rounded to their bf16 storage (exact: limit 0).
* ``tables``: the entries of the program's other trace tables, the mid
  and coarse grids' cell rows and the visibility cache's words, that
  differ from those the reference builds from the packed blocks
  (reference.trace_grid), which it traces through (exact: limit 0).
* the compared steps, followed by the reference from the program's state
  before them, with the batches, draws, phases, budgets and frozen flow
  copies the program fed (harness/compare.py): ``loss``, the largest
  relative gap over the steps of the loss without its NIS term;
  ``loss_nis``, that of the weighted NIS term; ``grad_median``, the
  median leaf's gap of the first gradient's norm; ``change_median``, the
  median leaf's gap of the parameters' change over the steps (a step
  that leaves the state unchanged reads 1), over every leaf the
  reference gives a gradient (``feats_network``, never applied, takes
  none and stays as it was on both sides); ``grad_worst`` and
  ``change_worst``, the worst leaf's gaps of the two; ``cond_grad``, the
  worst gap of the flows' conditioning fields' gradient norms over their
  own norms (their gradient is some 1e-5 of the median leaf's, so the
  gaps above, scaled by the median, would not see it); ``sec_cand`` and
  ``sec_hit``, the largest gap of the step's secondary candidate and hit
  rates (shares of the step's 1.25 M secondary rays).

Printed and not compared: the whole loss's gap, each loss term's gap,
the conditioning fields' change gap (scaled as ``change_median``'s) and
their gradient's norm over the median leaf's, and the coarse-march (a1)
rate's gap.
"""
from __future__ import annotations

import json
import os
import statistics

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NIS_TERM = 'loss_nis'
RATES = ('secondary_cand_rate', 'secondary_hit_rate', 'secondary_a1_rate')


def _ref():
    from bench_port.harness.spec import load_module
    return load_module(os.path.join(HERE, 'reference.py'),
                       'bench_ref_mat_compressor')


def limits():
    with open(os.path.join(HERE, 'limits.json')) as f:
        return json.load(f)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree


def ref_grid(inputs, device):
    """The trace tables the reference builds from the program's packed
    blocks, once per device."""
    kept = inputs.setdefault('ref_grid', {})
    if str(device) not in kept:
        g = inputs['grid']
        kept[str(device)] = _ref().trace_grid(
            g['blocks'].to(device), g['reso'], g['aabb'].to(device),
            2.0 * inputs['unit_size'])
    return kept[str(device)]


def table_gaps(prog_grid, ref):
    """Entries of the program's mid rows, coarse rows and visibility words
    that differ from the reference's (a table of another shape, or none,
    differs in all its entries)."""
    bad = 0
    for k in ('mid_rows', 'coarse_rows', 'vis_rows'):
        p, r = prog_grid.get(k), ref[k].cpu()
        if p is None or p.shape != r.shape:
            bad += r.numel()
        else:
            bad += int((p.to(r.dtype) != r).sum())
    return bad


def _max_gap(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in b)


def stage_readings(inputs, device, mode='float32'):
    """init, bake, bake_pack and tables."""
    ref, stage = _ref(), inputs['stage']
    init = ref.init_params(inputs['shader'], inputs['cfg']['random_seed'])
    out = {'init': _max_gap(stage['init']['params'],
                            {str(p): t for p, t in ref.leaves(init)})}
    bk = stage['bake']
    aabb = torch.as_tensor(bk['aabb'], device=device)
    nodes = torch.as_tensor(ref.bake_nodes(bk['aabb'], bk['reso'],
                                           bk['idx']), device=device)
    with ref.precision(mode), torch.no_grad():
        vals = ref.sdf_only(_to(stage['geo']['params'], device),
                            stage['geo']['sdf'], aabb, nodes)[:, 0]
    out['bake'] = float((vals.cpu().double()
                         - bk['values'].double()).abs().max())
    packed = ref.block_values(inputs['grid']['blocks'], bk['reso'],
                              bk['idx'])
    out['bake_pack'] = float((packed.float() - bk['values'].to(
        torch.bfloat16).float()).abs().max())
    out['tables'] = table_gaps(inputs['grid'], ref_grid(inputs, device))
    return out


def follow(inputs, device, mode='float32', fault=None):
    """The reference's loss terms, trace rates, first moments after the
    first step and parameters after the last, from the program's state
    before the compared steps.  ``fault``: 'specular_copy' (the GGX
    samples kept where the specular flow copy samples) or 'half_batch'
    (the first half of each batch's points, the means over them), planted
    in the reference."""
    ref, b = _ref(), inputs['before']
    steps = []
    for c in inputs['captured']:
        batch = {k: v.to(device) for k, v in c['batch'].items()}
        noise = {k: v.to(device) for k, v in c['noise'].items()}
        if fault == 'half_batch':
            keep = batch['inters'].shape[0] // 2
            batch = {k: v[:keep] for k, v in batch.items()}
            noise = {k: v[:keep] for k, v in noise.items()}
        steps.append({'step': c['step'], 'batch': batch, 'noise': noise,
                      'phase': c['phase'], 'weights': c['weights'],
                      'shader': c['shader']})
    grid = ref_grid(inputs, device)
    state = {'params': _to(b['params'], device),
             'copies': _to(b['copies'], device), 'grid': grid,
             'aabb': grid['aabb'], 'unit_size': inputs['unit_size'],
             'opt': {'m': _to(b['m'], device), 'v': _to(b['v'], device),
                     't': dict(b['t']), 'count': b['count'],
                     'reset_step': b['reset_step']}}
    logs, m_first, after = ref.train_steps(
        inputs['cfg'], state, steps, mode,
        fault='specular_copy' if fault == 'specular_copy' else None)
    return {'losses': [l['loss'] for l in logs],
            'terms': [{k: v for k, v in l.items() if k != 'loss'}
                      for l in logs],
            'm_first': {k: v.cpu() for k, v in m_first.items()},
            'after': {k: v.cpu() for k, v in after.items()}}


def _rel(p, r):
    return abs(p - r) / max(abs(r), 1e-30)


def step_readings(inputs, prog, ref_run):
    """loss, loss_nis, grad, change and the trace rates of ``prog`` (the
    program's, or a run put in its place) against ``ref_run``
    (follow())."""
    from bench_port.harness import compare as cmp
    before = {str(p): t for p, t in _ref().leaves(inputs['before']['params'])}
    m0 = inputs['before']['m']
    g_prog = cmp.first_gradient(m0, prog['m_first'])
    g_ref = cmp.first_gradient(m0, ref_run['m_first'])
    g_norm = cmp.norms(g_ref)
    moved = [k for k, v in g_norm.items() if v > 0.0]
    d_prog = cmp.change(before, prog['after'])
    d_ref = cmp.change(before, ref_run['after'])
    g_all = cmp.leaf_gaps(g_prog, g_ref)
    c_all = cmp.leaf_gaps(d_prog, d_ref, keys=moved)
    grad_leaf = max(g_all, key=g_all.get)
    change_leaf = max(c_all, key=c_all.get)
    cond = [k for k in moved if k.startswith("('flow_") and "'field'" in k]
    g_prog_n = cmp.norms({k: g_prog[k] for k in cond})
    g_med = statistics.median(g_norm.values())
    terms, rates = {}, {k: 0.0 for k in RATES}
    for pt, rt in zip(prog['terms'], ref_run['terms']):
        for k, r in rt.items():
            if k in RATES:
                rates[k] = max(rates[k], abs(pt.get(k, float('nan')) - r))
            else:
                terms[k] = max(terms.get(k, 0.0),
                               _rel(pt.get(k, float('nan')), r))
    rest_p = [lp - t.get(NIS_TERM, 0.0)
              for lp, t in zip(prog['losses'], prog['terms'])]
    rest_r = [lr - t.get(NIS_TERM, 0.0)
              for lr, t in zip(ref_run['losses'], ref_run['terms'])]
    nis = max(_rel(p.get(NIS_TERM, float('nan')), r[NIS_TERM])
              for p, r in zip(prog['terms'], ref_run['terms']))
    return {'loss': cmp.loss_gap(rest_p, rest_r), 'loss_nis': nis,
            'loss_total': cmp.loss_gap(prog['losses'], ref_run['losses']),
            'grad_worst': g_all[grad_leaf],
            'change_worst': c_all[change_leaf],
            'loss_steps': [_rel(p, r) for p, r in
                           zip(prog['losses'], ref_run['losses'])],
            'term_gaps': terms,
            'grad_median': statistics.median(g_all.values()),
            'change_median': statistics.median(c_all.values()),
            'sec_cand': rates['secondary_cand_rate'],
            'sec_hit': rates['secondary_hit_rate'],
            'sec_a1': rates['secondary_a1_rate'],
            'grad_leaf': grad_leaf, 'change_leaf': change_leaf,
            'cond_change': max((c_all[k] for k in cond), default=0.0),
            'cond_grad': max((abs(g_prog_n[k] - g_norm[k]) / g_norm[k]
                              for k in cond), default=0.0),
            'cond_grad_share': max((g_norm[k] / g_med for k in cond),
                                   default=0.0),
            'left_out': sorted(set(g_ref) - set(moved))}


def program_run(inputs):
    return {'losses': [c['terms']['loss'] for c in inputs['captured']],
            'terms': [c['terms'] for c in inputs['captured']],
            'm_first': inputs['m_first'], 'after': inputs['after']}


COMPARED = ('init', 'bake', 'bake_pack', 'tables', 'loss', 'loss_nis',
            'grad_median', 'change_median', 'grad_worst', 'change_worst',
            'cond_grad', 'sec_cand', 'sec_hit')


def checks(inputs, device):
    """[(name, value, limit)] of every number compared, and the notes
    printed beside them."""
    lim = limits()
    vals = stage_readings(inputs, device)
    vals.update(step_readings(inputs, program_run(inputs),
                              follow(inputs, device)))
    notes = {k: vals[k] for k in ('loss_total', 'loss_steps', 'grad_leaf',
                                  'change_leaf', 'cond_change',
                                  'cond_grad_share', 'term_gaps', 'sec_a1',
                                  'left_out')}
    return [(k, vals[k], lim[k]) for k in COMPARED], notes
