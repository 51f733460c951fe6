"""The hermetic evidence runs of the port (counterparts of the JAX repo's
scripts/convergence_run.py, scripts/convergence_mat.py and
scripts/ab_material.py): each trains on a procedural toy scene through the
published phase machinery and writes a JSON artifact.

    python -m tensoflow_tpu_torch.scripts.convergence_run [--out PATH]
    python -m tensoflow_tpu_torch.scripts.convergence_mat [--steps N]
    python -m tensoflow_tpu_torch.scripts.ab_material [--seeds S ...]

They run on the card; ``--device cpu`` runs the plain PyTorch path.
"""
