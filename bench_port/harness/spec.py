"""BENCHMARK.json and the files it names, found by name."""
from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, 'bench_port')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
# top-level module names no benchmark process may hold
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'tensoflow_tpu')


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config_entry(spec: dict, name: str) -> dict:
    for c in spec['configs']:
        if c['name'] == name:
            return c
    raise KeyError(f'no config {name!r} in BENCHMARK.json')


def config_dir(spec: dict, name: str, root: str = ROOT) -> str:
    return os.path.dirname(os.path.join(root, config_entry(spec, name)['file']))


def traffic_file(name: str, root: str = ROOT) -> str:
    return os.path.join(root, 'bench_port', 'traffic', f'{name}.json')


def load_traffic(name: str, root: str = ROOT) -> dict:
    with open(traffic_file(name, root)) as f:
        return json.load(f)


def metric_file(name: str, root: str = ROOT) -> str:
    return os.path.join(root, 'bench_port', 'metrics', f'{name}.py')


def load_module(path: str, name: str):
    """Import a file of the benchmark by path: the files found by name
    (a configuration's, a metric's), whose names need not be
    identifiers."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') this cell
    reports: those that list it, and those that list no cells but move
    an end-to-end metric the cell reports."""
    e2e = [m for m in spec['end_to_end']
           if cell in m.get('workloads', [cell])]
    if kind == 'end_to_end':
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in spec['per_layer']
            if (cell in m['workloads'] if 'workloads' in m
                else m['moves'] in names)]


def forbidden_modules(modules) -> list:
    """The names among ``modules`` whose top-level part (before the first
    dot) is one of FORBIDDEN, compared whole."""
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)
