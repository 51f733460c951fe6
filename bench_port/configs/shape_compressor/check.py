"""The numbers that decide ``correct`` for ``shape_compressor``, from what
the system kept in set-up, against the plain reference beside this file.

* ``init``: the largest gap between the program's initial parameters and
  the reference's, drawn from the same seed (exact: limit 0).
* ``upsample``: the largest gap between the program's last upsample and
  the reference's of the same field (exact: limit 0).
* ``mask_voxels``: voxels of the 128^3 alpha mask on which the program
  and the reference, built from the same parameters, disagree.
* the compared steps, followed by the reference from the program's state
  before them (harness/compare.py): ``loss``, the largest relative gap
  over the steps of the loss without its occ term; ``grad_median``, the
  median leaf's gap of the first gradient's norm; ``change_median``, the
  median leaf's gap of the parameters' change over the steps (a step
  that leaves the state unchanged reads 1).

Printed and not compared: the whole loss's gap (``loss_total``), the
occ term's, and the worst leaf's gaps of the gradient (``grad``) and of
the change (``change``).  The occ loss trains the occlusion-probability
network on a selection of surface samples made by a threshold on the SDF
(|sdf| < occ_sdf_thresh), so that a sample within rounding of the
threshold changes the selection, the term and that network's gradient
and change; sound runs read them as high as the control does (PERF.md
gives the readings).
"""
from __future__ import annotations

import json
import os
import statistics


HERE = os.path.dirname(os.path.abspath(__file__))
# the loss term trained on a thresholded selection of surface samples
OCC_TERM = 'loss_occ'


def _ref():
    from bench_port.harness.spec import load_module
    return load_module(os.path.join(HERE, 'reference.py'),
                       'bench_ref_shape_compressor')


def limits():
    with open(os.path.join(HERE, 'limits.json')) as f:
        return json.load(f)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def _max_gap(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in b)


def stage_readings(inputs, device, mode='float32'):
    """init, upsample and mask_voxels."""
    ref, cfg, stage = _ref(), inputs['cfg'], inputs['stage']
    out = {}
    init = ref.init_params(cfg, stage['init']['grid_size'])
    out['init'] = _max_gap(stage['init']['params'],
                           {str(p): t for p, t in ref.leaves(init)})
    up = stage['upsample']
    with ref.precision(mode):
        mine = ref.upsample_field(_to(up['before'], device),
                                  up['grid_size'])
        out['upsample'] = _max_gap(
            {str(p): t for p, t in ref.leaves(up['after'])},
            {str(p): t.cpu() for p, t in ref.leaves(mine)})
        am = stage['alpha_mask']
        vol = ref.alpha_mask(_to(am['params'], device), cfg, am['n_levels'])
    out['mask_voxels'] = int((vol.cpu() != am['volume']).sum())
    return out


def follow(inputs, device, mode='float32', batch_share=1.0):
    """The reference's loss terms, first moments after the first step and
    parameters after the last, from the program's state before the
    compared steps.  ``batch_share`` < 1 keeps that share of each batch's
    rays (the half-batch fault, planted in the reference)."""
    ref, b = _ref(), inputs['before']
    steps = []
    for c in inputs['captured']:
        batch = {k: v.to(device) for k, v in c['batch'].items()}
        noise = {k: v.to(device) for k, v in c['noise'].items()}
        if batch_share < 1.0:
            rn = batch['rays_o'].shape[0]
            keep = int(rn * batch_share)
            sn = noise['occ_score'].shape[0] // rn
            batch = {k: v[:keep] for k, v in batch.items()}
            noise = {'sample_jitter': noise['sample_jitter'][:keep],
                     'occ_score': noise['occ_score'][:keep * sn]}
        steps.append({'step': c['step'], 'batch': batch, 'noise': noise})
    state = {'params': _to(b['params'], device),
             'alpha_mask': None if b['alpha_mask'] is None
             else b['alpha_mask'].to(device),
             'grid_size': b['grid_size'], 'n_levels': b['n_levels'],
             'opt': {'m': _to(b['m'], device), 'v': _to(b['v'], device),
                     't': dict(b['t']), 'count': b['count'],
                     'reset_step': b['reset_step']}}
    logs, m_first, after = ref.train_steps(inputs['cfg'], state, steps, mode)
    return {'losses': [l['loss'] for l in logs],
            'terms': [{k: v for k, v in l.items() if k not in ('loss', 'diag')}
                      for l in logs],
            'diag': [l['diag'] for l in logs],
            'm_first': {k: v.cpu() for k, v in m_first.items()},
            'after': {k: v.cpu() for k, v in after.items()}}


def step_readings(inputs, prog, ref_run):
    """loss, grad and change of ``prog`` (the program's, or a run put in
    its place) against ``ref_run`` (follow())."""
    from bench_port.harness import compare as cmp
    before = {str(p): t for p, t in _ref().leaves(inputs['before']['params'])}
    m0 = inputs['before']['m']
    g_prog = cmp.first_gradient(m0, prog['m_first'])
    g_ref = cmp.first_gradient(m0, ref_run['m_first'])
    grad, grad_leaf = cmp.leaf_norm_gap(g_prog, g_ref)
    moved = cmp.moved_leaves(g_ref)
    d_prog = cmp.change(before, prog['after'])
    d_ref = cmp.change(before, ref_run['after'])
    change, change_leaf = cmp.leaf_norm_gap(d_prog, d_ref, keys=moved)
    g_all = cmp.leaf_gaps(g_prog, g_ref)
    c_all = cmp.leaf_gaps(d_prog, d_ref, keys=moved)
    terms = {}
    for pt, rt in zip(prog['terms'], ref_run['terms']):
        for k, r in rt.items():
            gap = abs(pt.get(k, float('nan')) - r) / max(abs(r), 1e-30)
            terms[k] = max(terms.get(k, 0.0), gap)
    rest_p = [lp - t.get(OCC_TERM, 0.0)
              for lp, t in zip(prog['losses'], prog['terms'])]
    rest_r = [lr - t.get(OCC_TERM, 0.0)
              for lr, t in zip(ref_run['losses'], ref_run['terms'])]
    return {'loss': cmp.loss_gap(rest_p, rest_r),
            'loss_total': cmp.loss_gap(prog['losses'], ref_run['losses']),
            'grad': grad, 'change': change,
            'loss_steps': [abs(p - r) / max(abs(r), 1e-30) for p, r in
                           zip(prog['losses'], ref_run['losses'])],
            'term_gaps': terms,
            'grad_median': statistics.median(g_all.values()),
            'change_median': statistics.median(c_all.values()),
            'diag': ref_run.get('diag'),
            'grad_leaf': grad_leaf, 'change_leaf': change_leaf,
            'left_out': sorted(set(g_ref) - set(moved))}


def program_run(inputs):
    return {'losses': [c['terms']['loss'] for c in inputs['captured']],
            'terms': [c['terms'] for c in inputs['captured']],
            'm_first': inputs['m_first'], 'after': inputs['after']}


COMPARED = ('init', 'upsample', 'mask_voxels', 'loss', 'grad_median',
            'change_median')


def checks(inputs, device):
    """[(name, value, limit)] of every number compared, and the notes
    printed beside them."""
    lim = limits()
    vals = stage_readings(inputs, device)
    vals.update(step_readings(inputs, program_run(inputs),
                              follow(inputs, device)))
    notes = {k: vals[k] for k in ('loss_total', 'grad', 'grad_leaf',
                                  'change', 'change_leaf',
                                  'loss_steps', 'term_gaps', 'diag',
                                  'left_out')}
    return [(k, vals[k], lim[k]) for k in COMPARED], notes
