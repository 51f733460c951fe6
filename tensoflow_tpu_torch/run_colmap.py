"""COLMAP structure-from-motion for custom captures (counterpart of
run_colmap.py).

    python -m tensoflow_tpu_torch.run_colmap --project <capture dir>

Runs feature extraction -> exhaustive matching -> mapping through the
``colmap`` binary on PATH, writing the sparse model that
data/colmap_db.CustomDatabase reads (<project>/colmap/sparse/0).  Host
only: no torch, no device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def run_sfm(image_dir: str, project_dir: str, same_camera: bool = True):
    colmap = shutil.which('colmap')
    if colmap is None:
        raise RuntimeError(
            'colmap binary not found; install COLMAP or provide a '
            'precomputed sparse model under <project>/colmap/sparse/0')
    db = os.path.join(project_dir, 'database.db')
    sparse = os.path.join(project_dir, 'sparse')
    os.makedirs(sparse, exist_ok=True)
    subprocess.check_call([
        colmap, 'feature_extractor', '--database_path', db,
        '--image_path', image_dir,
        '--ImageReader.single_camera', '1' if same_camera else '0',
        '--ImageReader.camera_model', 'SIMPLE_RADIAL'])
    subprocess.check_call([
        colmap, 'exhaustive_matcher', '--database_path', db])
    subprocess.check_call([
        colmap, 'mapper', '--database_path', db, '--image_path', image_dir,
        '--output_path', sparse])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--project', type=str, required=True,
                        help='capture dir containing images/')
    args = parser.parse_args(argv)
    run_sfm(os.path.join(args.project, 'images'),
            os.path.join(args.project, 'colmap'))


if __name__ == '__main__':
    main()
