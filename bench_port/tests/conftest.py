import os
import sys

import pytest
import torch

torch.set_num_threads(2)
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.harness.spec import load_module as load  # noqa: E402,F401

# a tiny stage-1 configuration for the CPU (widths cut, 16^3 -> 64^3)
TINY_SHAPE = ['database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
              'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=262144',
              'train_ray_num=64', 'n_samples=16', 'n_importance=16',
              'occ_loss_max_pn=64', 'init_radius=0.5']
TINY_TRAFFIC = {'warmup_steps': 1, 'min_window_steps': 2,
                'trace_profiled_steps': 1, 'expect': {}}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA CUDA card')
