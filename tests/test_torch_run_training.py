"""The port's training CLI (tensoflow_tpu_torch.run_training) on the CPU.

A source snapshot that cannot be written (read-only or full disk) must
not stop training: the reference prints ``[recording] skipped: ...`` and
carries on (run_training.py), and so does the port.
"""
from __future__ import annotations

import os
import shutil

from tensoflow_tpu_torch import run_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(ROOT, 'configs/shape/toy/sphere.yaml')
TINY = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
        'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=512',
        'train_ray_num=16', 'n_samples=8', 'n_importance=8',
        'test_ray_num=64', 'upsample_list=null', 'init_radius=0.5',
        'sdf_multires=0', 'split_manul=false', 'save_interval=2',
        'val_interval=1000', 'train_log_step=1', 'name=cli_no_recording']


def test_training_goes_on_when_the_source_snapshot_fails(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    def refuse(*args, **kwargs):
        raise OSError(28, 'No space left on device')
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(shutil, 'copytree', refuse)
    run_training.main(['--cfg', CFG_PATH, '--steps', '2', '--device', 'cpu',
                       *TINY])
    printed = capsys.readouterr().out
    assert '[recording] skipped: [Errno 28] No space left on device' \
        in printed, printed
    assert 'training done at step 2' in printed, printed
    model_dir = tmp_path / 'data' / 'model' / 'cli_no_recording'
    assert (model_dir / 'model.pkl').exists()
    assert not (model_dir / 'recording' / 'tensoflow_tpu_torch').exists()
