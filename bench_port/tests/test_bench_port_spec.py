"""BENCHMARK.json against the contract's form, the files it names, the
modules a run may load, and the frozen operation counts."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, load

spec_mod = load(os.path.join(BENCH, 'harness', 'spec.py'), 'bench_spec')
SPEC = spec_mod.load_spec(ROOT)
CONFIG_FILES = ('system.py', 'check.py', 'counts.py', 'reference.py',
                'limits.json')


def test_top_level_keys():
    assert list(SPEC) == ['command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer']
    assert SPEC['command'] == ['python3', 'bench_port/run.py']
    assert SPEC['paths'] == ['bench_port']
    assert 1 <= SPEC['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_resolves_to_its_files(cell):
    w = spec_mod.workload(SPEC, cell)
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] in (1, 4)
    entry = spec_mod.config_entry(SPEC, w['config'])
    assert entry['file'].startswith('bench_port/')
    assert os.path.isfile(os.path.join(ROOT, entry['file']))
    cdir = spec_mod.config_dir(SPEC, w['config'])
    for fn in CONFIG_FILES:
        assert os.path.isfile(os.path.join(cdir, fn)), fn
    assert os.path.isfile(spec_mod.traffic_file(w['traffic']))
    spec_mod.load_traffic(w['traffic'])
    e2e = spec_mod.cell_metrics(SPEC, cell, 'end_to_end')
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2
    per = spec_mod.cell_metrics(SPEC, cell, 'per_layer')
    assert per
    for m in per:
        assert os.path.isfile(spec_mod.metric_file(m['name']))


# every key a traffic file may hold; each is read by run.py or a system
TRAFFIC_KEYS = {'setup_steps', 'warmup_steps', 'compare_steps',
                'min_window_steps', 'trace_profiled_steps', 'route',
                'expect'}


@pytest.mark.parametrize('traffic',
                         sorted({w['traffic'] for w in SPEC['workloads']}))
def test_traffic_holds_only_keys_that_are_read(traffic):
    assert set(spec_mod.load_traffic(traffic)) <= TRAFFIC_KEYS


def test_names_units_and_entries():
    names = [c['name'] for c in SPEC['configs']]
    names += [w['name'] for w in SPEC['workloads']]
    names += [w['traffic'] for w in SPEC['workloads']]
    names += [w['config'] for w in SPEC['workloads']]
    metrics = SPEC['end_to_end'] + SPEC['per_layer']
    names += [m['name'] for m in metrics]
    for c in SPEC['configs']:
        names += c['reduced']
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert len(c['reduced']) <= 16
    for n in names:
        assert spec_mod.NAME.match(n), n
    for kind in ('configs', 'workloads'):
        got = [x['name'] for x in SPEC[kind]]
        assert len(got) == len(set(got))
    assert len({m['name'] for m in metrics}) == len(metrics)
    texts = [x['why'] for x in SPEC['configs'] + SPEC['workloads']]
    texts += [m['layer'] for m in SPEC['per_layer']]
    texts += [c['source'] for c in SPEC['configs']] + SPEC['command']
    for t in texts:
        assert 1 <= len(t) <= 200 and '\n' not in t and '\t' not in t, t
    e2e_names = {m['name'] for m in SPEC['end_to_end']}
    for m in SPEC['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert m['moves'] in e2e_names
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    for m in metrics:
        assert spec_mod.UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for m in SPEC['per_layer']:
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


def test_forbidden_names_are_compared_whole():
    got = spec_mod.forbidden_modules(
        ['tensoflow_tpu_torch', 'tensoflow_tpu_torch.ops.stencil', 'jax',
         'jax.numpy', 'jaxlib', 'optax', 'tensoflow_tpu', 'flax.linen',
         'jaxtyping'])
    assert got == ['flax.linen', 'jax', 'jax.numpy', 'jaxlib', 'optax',
                   'tensoflow_tpu']


def _modules_after(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, 'PYTHONPATH': ''})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax():
    """Everything a run imports: the harness, each configuration's files,
    the port's trainer."""
    code = (
        'import json, sys, importlib.util, os\n'
        "sys.path.insert(0, 'bench_port/tests')\n"
        'from conftest import load\n'
        "run = load('bench_port/run.py', 'bench_run')\n"
        "run.cache_dirs(os.getcwd())\n"
        'spec = run.spec_mod.load_spec()\n'
        "for c in spec['configs']:\n"
        "    d = os.path.dirname(c['file'])\n"
        "    for f in ('system', 'check', 'counts', 'reference'):\n"
        "        load(os.path.join(d, f + '.py'), 'b_' + c['name'] + f)\n"
        "for m in spec['per_layer']:\n"
        "    load(run.spec_mod.metric_file(m['name']), 'm_' + m['name'])\n"
        'import tensoflow_tpu_torch.train.trainer\n'
        'import tensoflow_tpu_torch.train.trainer_mat\n'
        'print(json.dumps(run.spec_mod.forbidden_modules(sys.modules)))\n')
    assert _modules_after(code) == []


@pytest.mark.parametrize('cfg', [c['name'] for c in SPEC['configs']])
def test_reference_imports_nothing_of_the_program(cfg):
    d = spec_mod.config_dir(SPEC, cfg)
    code = (
        'import json, sys\n'
        "sys.path.insert(0, 'bench_port/tests')\n"
        'from conftest import load\n'
        f"load({os.path.join(d, 'reference.py')!r}, 'ref')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('tensoflow_tpu_torch', 'tensoflow_tpu', 'jax', 'jaxlib'))))\n")
    assert _modules_after(code) == []


def test_frozen_head_count():
    """69.7 / 199.9 GFLOP at N=131,072 (C=36, E=21, H=256, O=129, S=7),
    and 2.834 / 2.845 GB at two mip branches in float32."""
    counts = load(os.path.join(BENCH, 'configs', 'shape_compressor',
                               'counts.py'), 'counts')
    cfg = json.load(open(os.path.join(BENCH, 'configs', 'shape_compressor',
                                      'config.json')))['resolved']
    assert counts.widths(cfg) == (36, 21, 256, 129)
    n = counts.head_rows(cfg)
    assert n == 131072
    (fb, fo), (bb, bo) = counts.head_bytes_ops(n, 2, cfg)
    assert round(fo / 1e9, 1) == 69.7 and round(bo / 1e9, 1) == 199.9
    assert round(fb / 1e9, 3) == 2.834 and round(bb / 1e9, 3) == 2.845
