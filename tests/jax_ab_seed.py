"""Runs the JAX repo's scripts/ab_material.py, unchanged, at another
``random_seed`` on the CPU and prints the A/B figures of
tensoflow_tpu_torch/scripts/summary.py for it: the reference's side of
the NIS A/B spread that the port's artifact records under ``seeds``.

    python tests/jax_ab_seed.py SEED OUT_DIR

The script's stage-1 checkpoint path (/tmp/ab_mat_geo.pkl) is redirected
to OUT_DIR, and its artifact is written to OUT_DIR/jax_ab_seed<SEED>.json.
Not a test: it takes ~10 min of CPU.
"""
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(seed: int, out_dir: str):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, ROOT)
    from tensoflow_tpu import config as config_mod
    from tensoflow_tpu.train import trainer as jtrainer
    from tensoflow_tpu.train import trainer_mat as jtrainer_mat
    from tensoflow_tpu_torch.scripts import summary

    os.makedirs(out_dir, exist_ok=True)
    geo = os.path.join(out_dir, f'ab_mat_geo_{seed}.pkl')
    out = os.path.join(out_dir, f'jax_ab_seed{seed}.json')
    load_config = config_mod.load_config
    config_mod.load_config = lambda path=None, overrides=None, extra=None: \
        load_config(path, overrides, {**(extra or {}), 'random_seed': seed})
    save = jtrainer.ShapeTrainer.save
    jtrainer.ShapeTrainer.save = lambda self, path: save(self, geo)
    init = jtrainer_mat.MaterialTrainer.__init__
    jtrainer_mat.MaterialTrainer.__init__ = \
        lambda self, cfg, path, *a, **k: init(self, cfg, geo, *a, **k)
    sys.argv = ['ab_material.py', '--out', out]
    spec = importlib.util.spec_from_file_location(
        'jax_ab_material', os.path.join(ROOT, 'scripts', 'ab_material.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    with open(out) as f:
        record = json.load(f)
    print('\n'.join(summary.ab_lines({**record, 'random_seed': seed})))


if __name__ == '__main__':
    main(int(sys.argv[1]), sys.argv[2])
