"""The relight evaluation pieces of the port against the JAX package and
against the libraries the reference reads with: LPIPS (lpips_exact against
JAX with synthetic weights; None without the bundle), the images the ORB
relight CLI reads (cv2.imread semantics, cv2.erode with its edge rule),
the CLI's printed and recorded line against the JAX CLI's, the Radiance
.hdr reader against cv2, the relight_orb and eval_mat --relight CLIs on
the CPU, ValidationEvaluator and utils/timing against JAX.
"""
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from tensoflow_tpu.eval import metrics as jmetrics
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch import eval_mat, eval_orb_relight, relight_orb
from tensoflow_tpu_torch.data import image_io
from tensoflow_tpu_torch.eval import metrics as pmetrics
from tensoflow_tpu_torch.models import material_renderer as pmr
from tensoflow_tpu_torch.ops import mesh as pmesh
from tensoflow_tpu_torch.train.trainer import ShapeTrainer
from tensoflow_tpu_torch.train.trainer_mat import MaterialTrainer

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import eval_orb_relight as jeval_orb_relight  # noqa: E402



# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def _lpips_weights(seed):
    rng = np.random.RandomState(seed)
    weights, in_ch = {}, 3
    for item in jmetrics._VGG_PLAN:
        if item == 'pool':
            continue
        i, out_ch = item
        weights[f'features.{i}.weight'] = (
            rng.randn(out_ch, in_ch, 3, 3).astype(np.float32)
            * np.sqrt(2.0 / (9 * in_ch)))
        weights[f'features.{i}.bias'] = (
            rng.randn(out_ch).astype(np.float32) * 0.05)
        in_ch = out_ch
    for k, ch in enumerate([64, 128, 256, 512, 512]):
        weights[f'lin{k}.weight'] = np.abs(
            rng.randn(1, ch, 1, 1).astype(np.float32))
    return weights


def test_lpips_exact_matches_jax():
    """32x32 images through the five VGG groups (down to 2x2)."""
    rng = np.random.RandomState(1)
    w = _lpips_weights(0)
    a = rng.rand(32, 32, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(32, 32, 3), 0, 1).astype(np.float32)
    assert pmetrics.lpips_exact(a, a, weights=w) == 0.0
    got = pmetrics.lpips_exact(a, b, weights=w)
    want = jmetrics.lpips_exact(a, b, weights=w)
    assert got > 0 and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_is_none_without_the_bundle():
    assert not os.path.exists(pmetrics._lpips_weights_path())
    img = np.zeros((8, 8, 3), np.float32)
    assert pmetrics.lpips_exact(img, img) is None
    assert pmetrics.lpips(img, img) is None


# ---------------------------------------------------------------------------
# the images eval_orb_relight reads, as cv2 reads them
# ---------------------------------------------------------------------------

def test_erode_mask_equals_cv2_including_the_edge():
    assert eval_orb_relight.erode_mask(np.ones((5, 5), bool)).all()
    rng = np.random.RandomState(0)
    for it in (1, 2):
        m = rng.rand(23, 31) > 0.25
        want = cv2.erode(m.astype(np.uint8), np.ones((3, 3), np.uint8),
                         iterations=it).astype(bool)
        np.testing.assert_array_equal(eval_orb_relight.erode_mask(m, it),
                                      want)


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def _write_png(path, samples, bits, ctype, extra=b''):
    """Unfiltered PNG of [h, w*ch] samples, packed at ``bits``."""
    h = samples.shape[0]
    if bits == 16:
        rows = samples.astype('>u2').view(np.uint8).reshape(h, -1)
    elif bits == 8:
        rows = samples.astype(np.uint8)
    else:
        per = 8 // bits
        v = np.pad(samples, ((0, 0), (0, -samples.shape[1] % per)))
        v = v.reshape(h, -1, per)
        rows = sum(v[..., k] << (8 - bits * (k + 1))
                   for k in range(per)).astype(np.uint8)
    w = samples.shape[1] // {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    body = b''.join(b'\0' + r.tobytes() for r in rows)
    with open(path, 'wb') as f:
        f.write(image_io.PNG_SIGNATURE
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, bits, ctype,
                                              0, 0, 0))
                + extra + _chunk(b'IDAT', zlib.compress(body))
                + _chunk(b'IEND', b''))


CASES = [(0, 1, ''), (0, 4, ''), (0, 8, ''), (0, 16, ''), (2, 8, ''),
         (2, 16, ''), (2, 8, 'gAMA'), (2, 8, 'sRGB'), (3, 4, ''),
         (3, 8, 'gAMA'), (4, 8, ''), (4, 16, ''), (6, 8, ''), (6, 16, ''),
         (6, 8, 'gAMA')]


@pytest.mark.parametrize('ctype,bits,tag', CASES,
                         ids=[f'ct{c}-{b}bit{t}' for c, b, t in CASES])
def test_reads_equal_cv2_imread(tmp_path, ctype, bits, tag):
    """RGB, RGBA, grey, grey+alpha, 16-bit and palette PNGs, with and
    without a gamma chunk: colour as cv2.imread(p)[..., ::-1], grey as
    cv2.imread(p, 0)."""
    rng = np.random.RandomState(ctype * 100 + bits)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.randint(0, 1 << bits, (9, 13 * ch))
    extra = {'': b'', 'gAMA': _chunk(b'gAMA', struct.pack('>I', 45455)),
             'sRGB': _chunk(b'sRGB', b'\0')}[tag]
    if ctype == 3:
        extra += _chunk(b'PLTE', rng.randint(0, 256, 3 << bits).astype(
            np.uint8).tobytes())
    path = str(tmp_path / 'x.png')
    _write_png(path, samples, bits, ctype, extra)
    np.testing.assert_array_equal(image_io.imread_cv2(path),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(image_io.imread_cv2(path, grey=True),
                                  cv2.imread(path, 0))


def _relight_dirs(root, rng, n=3, size=(24, 20)):
    """pred / gt / mask directories: RGB, RGBA and 16-bit views, a grey
    and a colour mask, one view without ground truth."""
    for d in ('pred', 'gt', 'mask'):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    h, w = size
    for i in range(n + 1):
        name = f'relit_{i}.png'
        gt = rng.randint(0, 256, (h, w, 3 + (i == 1))).astype(np.uint8)
        pred = np.clip(gt[..., :3] * 0.8 + rng.randint(0, 40, (h, w, 3)),
                       0, 255).astype(np.uint8)
        if i == 2:
            gt = gt.astype(np.uint16) * 257 + rng.randint(0, 256, gt.shape
                                                          ).astype(np.uint16)
        image_io.imwrite_png(os.path.join(root, 'pred', name), pred)
        if i < n:
            image_io.imwrite_png(os.path.join(root, 'gt', name), gt)
        m = np.zeros((h, w), np.uint8)
        m[3:h - 2, 2:w - 4] = 255
        if i == 0:
            m = np.stack([m, m // 2 + 100, m], -1)
        if i != 1:
            image_io.imwrite_png(os.path.join(root, 'mask', name), m)


def test_eval_orb_relight_line_equals_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(2)
    _relight_dirs(str(tmp_path), rng)
    monkeypatch.chdir(tmp_path)
    os.makedirs('data', exist_ok=True)
    args = ['--pred_dir', 'pred', '--gt_dir', 'gt', '--mask_dir', 'mask']
    monkeypatch.setattr(sys, 'argv', ['eval_orb_relight.py', *args])
    jeval_orb_relight.main()
    jout = capsys.readouterr().out
    jrec = open('data/metrics_record.txt').read()
    os.remove('data/metrics_record.txt')
    msg = eval_orb_relight.main(args)
    pout = capsys.readouterr().out
    prec = open('data/metrics_record.txt').read()
    assert pout == jout and prec == jrec
    assert prec == msg + '\n' and msg.startswith('relight: SI-PSNR ')
    assert len(pout.splitlines()) == 4 and 'LPIPS' not in msg


# ---------------------------------------------------------------------------
# Radiance .hdr
# ---------------------------------------------------------------------------

def _write_flat_hdr(path, rgbe):
    h, w, _ = rgbe.shape
    with open(path, 'wb') as f:
        f.write(b'#?RGBE\nGAMMA=1.0\nFORMAT=32-bit_rle_rgbe\n\n'
                + f'-Y {h} +X {w}\n'.encode() + rgbe.tobytes())


def test_hdr_reader_equals_cv2(tmp_path):
    """A file cv2 writes (run-length encoded, runs and literals) and a
    flat file; env maps dispatch on their first bytes."""
    rng = np.random.RandomState(3)
    img = (rng.rand(21, 40, 3) ** 3 * 50).astype(np.float32)
    img[2:6, 3:30] = 1.5
    img[0, :4] = 0
    rle = str(tmp_path / 'rle.hdr')
    cv2.imwrite(rle, np.ascontiguousarray(img[..., ::-1]))
    want = cv2.imread(rle, cv2.IMREAD_UNCHANGED)[..., ::-1]
    got = image_io.read_hdr(rle)
    assert got.dtype == np.float32 and got.shape == (21, 40, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.read_env_map(rle), want)
    rgbe = rng.randint(0, 256, (7, 5, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.randint(120, 140, (7, 5))
    rgbe[0, 0] = 0
    flat = str(tmp_path / 'flat.hdr')
    _write_flat_hdr(flat, rgbe)
    want = cv2.imread(flat, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(image_io.read_hdr(flat), want)
    png = str(tmp_path / 'env.png')
    image_io.imwrite_png(png, (img.clip(0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(image_io.read_env_map(png),
                                  image_io.imread(png).astype(np.float32))
    with pytest.raises(ValueError, match='neither'):
        open(str(tmp_path / 'x.bin'), 'wb').write(b'\0' * 16)
        image_io.read_env_map(str(tmp_path / 'x.bin'))


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

CLI_CFG = os.path.join(ROOT, 'configs/mat/syn/compressor.yaml')
CLI_GEO = ['database_name=toy/sphere_16_2', 'sdf_n_comp=2', 'sdf_dim=16',
           'app_dim=8', 'N_voxel_init=512', 'N_voxel_final=512',
           'upsample_list=null', 'init_radius=0.5', 'sdf_multires=0']
SHADER = {'diffuse_sample_num': 16, 'specular_sample_num': 8,
          'nis_diffuse_sample_num': 4, 'nis_specular_sample_num': 4,
          'grid_size': [16, 16, 16], 'light_reso': 8, 'mat_n_comp': 4,
          'estimator_dtype': 'f32'}


@pytest.fixture(scope='module')
def cli_dir(tmp_path_factory):
    """A stage-1 checkpoint with a sphere-like surface, its mesh, a
    material checkpoint at data/model/<name>/model.pkl, two env maps."""
    d = tmp_path_factory.mktemp('relight_cli')
    geo = str(d / 'geo.pt')
    ShapeTrainer(pconfig.load_config(
        os.path.join(ROOT, 'configs/shape/toy/sphere.yaml'),
        overrides=CLI_GEO), device='cpu').save(geo)
    verts, tris = pmesh.extract_geometry(
        np.array([-1.0] * 3), np.array([1.0] * 3), 16, 0.0,
        lambda p: np.linalg.norm(p, axis=-1) - 0.5)
    ply = str(d / 'mesh.ply')
    pmesh.write_ply(ply, verts, tris)
    over = ['name=rl_cli', 'database_name=toy/sphere_16_4',
            'split_manul=false', f'geo_model_path={geo}', f'mesh={ply}',
            'train_ray_num=16', 'bake_resolution=16'] + [
        f'shader_cfg.{k}={v}' for k, v in SHADER.items()]
    cfg = pconfig.load_config(CLI_CFG, overrides=over)
    tr = MaterialTrainer(cfg, geo, device='cpu')
    os.makedirs(d / 'data' / 'model' / 'rl_cli')
    tr.save(str(d / 'data' / 'model' / 'rl_cli' / 'model.pkl'))
    env = (np.random.RandomState(4).rand(16, 32, 3) * 4).astype(np.float32)
    cv2.imwrite(str(d / 'env.hdr'), np.ascontiguousarray(env[..., ::-1]))
    image_io.imwrite_png(str(d / 'env.png'),
                         (env.clip(0, 1) * 255).astype(np.uint8))
    return dict(dir=d, over=over, cfg=cfg, trainer=tr)


def test_relight_orb_on_the_cpu(cli_dir, monkeypatch):
    """Four toy views relit at 16x16: 8-bit PNGs, white exactly where
    trace_surface misses, shaded where it hits."""
    monkeypatch.chdir(cli_dir['dir'])
    written = relight_orb.main(['--cfg', CLI_CFG, '--hdr', 'env.hdr',
                                '--device', 'cpu', *cli_dir['over']])
    assert [os.path.basename(p) for p in written] == [
        f'relit_{i}.png' for i in range(4)]
    from tensoflow_tpu_torch.data import database as pdb
    from tensoflow_tpu_torch.data import rays as prays
    db = pdb.parse_database_name('toy/sphere_16_4', 'unused', isTest=True)
    tr = cli_dir['trainer']
    shaded = 0
    for i, path in enumerate(written):
        img = image_io.imread(path)
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        info = {'imgs': np.zeros((1, 16, 16, 3), np.float32),
                'Ks': db.get_K(i)[None].astype(np.float32),
                'poses': db.get_pose(i)[None].astype(np.float32)}
        batch = prays.construct_ray_batch_nerf(info)[0]
        hit = pmr.trace_surface(tr.geo_params, tr.rcfg, tr.grid,
                                torch.tensor(batch['rays_o']),
                                torch.tensor(batch['dirs']))[3].numpy()
        hit = hit.reshape(16, 16)
        assert 0 < hit.sum() < 256
        assert np.all(img[~hit] == 255)
        shaded += int((img[hit] < 255).any(-1).sum())
    assert shaded > 0
    # a PNG environment (0-255, divided by 255) and --out
    out = relight_orb.main(['--cfg', CLI_CFG, '--hdr', 'env.png', '--out',
                            'png_env', '--device', 'cpu', *cli_dir['over']])
    assert len(out) == 4 and all(p.startswith('png_env') for p in out)


def test_relight_orb_env_cube_scales_ldr(cli_dir, tmp_path):
    """An image whose largest value is above 2 is read as 0-255, whatever
    its format (the reference's quirk: an HDR map brighter than 2 is
    divided by 255 too); one at most 2 is taken as it is."""
    from tensoflow_tpu_torch.ops.cubemap import latlong_to_cubemap
    d = cli_dir['dir']
    for name in ('env.hdr', 'env.png'):
        env = image_io.read_env_map(str(d / name))
        assert env.max() > 2.0
        want = latlong_to_cubemap(torch.tensor(env / 255.0), 8)
        assert torch.equal(relight_orb.load_env_cube(str(d / name), 'cpu',
                                                     8), want)
    dim = (np.random.RandomState(6).rand(8, 16, 3) * 2).astype(np.float32)
    cv2.imwrite(str(tmp_path / 'dim.hdr'), np.ascontiguousarray(
        dim[..., ::-1]))
    env = image_io.read_env_map(str(tmp_path / 'dim.hdr'))
    assert 1.0 < env.max() <= 2.0
    assert torch.equal(
        relight_orb.load_env_cube(str(tmp_path / 'dim.hdr'), 'cpu', 8),
        latlong_to_cubemap(torch.tensor(env), 8))


def test_eval_mat_relight_writes_the_bundle(cli_dir, monkeypatch, capsys):
    monkeypatch.chdir(cli_dir['dir'])
    monkeypatch.setenv('PATH', '/nonexistent')
    res = eval_mat.main(['--cfg', CLI_CFG, '--relight', '--hdr', 'env.hdr',
                         '--device', 'cpu', *cli_dir['over']])
    assert res['relight'] is None
    assert 'blender not found; relight bundle written to data/relight/' \
        'rl_cli' in capsys.readouterr().out
    out = cli_dir['dir'] / 'data' / 'relight' / 'rl_cli'
    bundle = json.load(open(out / 'relight_cfg.json'))
    assert bundle['hdr'] == 'env.hdr' and bundle['mesh'].endswith('mesh.ply')
    for k in ('albedo', 'roughness', 'metallic'):
        arr = np.load(cli_dir['dir'] / bundle[k])
        assert arr.shape[0] > 100 and np.isfinite(arr).all()
    assert (out / 'relight_driver.py').exists()


# ---------------------------------------------------------------------------
# ValidationEvaluator and utils/timing against JAX
# ---------------------------------------------------------------------------

class _FakeDB:
    def __init__(self):
        rng = np.random.RandomState(5)
        self.imgs = [rng.randint(0, 256, (16, 20, 3)).astype(np.uint8)
                     for _ in range(2)]

    def get_image(self, i):
        return self.imgs[i]

    def get_K(self, i):
        return np.array([[20.0, 0, 10], [0, 20, 8], [0, 0, 1]], np.float32)

    def get_pose(self, i):
        return np.eye(4, dtype=np.float32)[:3] * (i + 1)


def _render(pose, K, h, w):
    y, x = np.mgrid[:h, :w].astype(np.float32)
    v = (np.sin(x * K[0, 0] / 40 + pose[0, 0]) * 0.5 + 0.5)[..., None]
    return {'rgb_pr': np.repeat(v, 3, -1) * (y[..., None] / h),
            'albedo': np.full((h, w, 3), 0.3, np.float32)}


@pytest.mark.parametrize('downsample', [1.0, 0.5])
def test_validation_evaluator_matches_jax(tmp_path, monkeypatch, downsample):
    from tensoflow_tpu.train.metrics_vis import ValidationEvaluator as JVE
    from tensoflow_tpu_torch.train.metrics_vis import (MAT_KEYS,
                                                       ValidationEvaluator)
    from tensoflow_tpu.train import metrics_vis as jmv
    assert MAT_KEYS == jmv.MAT_KEYS
    monkeypatch.chdir(tmp_path)
    db = _FakeDB()
    jm, jk = JVE()(_render, [0, 1], db, 'm', 3, downsample)
    pm, pk = ValidationEvaluator()(_render, [0, 1], db, 'm', 3, downsample)
    assert sorted(pm) == sorted(jm) == ['psnr', 'ssim']
    for k in pm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-6)
    np.testing.assert_allclose(pk, jk, rtol=1e-6)
    assert os.path.exists('data/train_vis/m-val/step3-1.jpg')


def test_train_logger_matches_jax(tmp_path, capsys):
    from tensoflow_tpu.utils import timing as jt
    from tensoflow_tpu_torch.utils import timing as pt
    res = {'loss': 0.123456789, 'step_ms': 12.5, 'n': 3, 'tag': 'x'}
    for name, mod in (('j', jt), ('p', pt)):
        log = mod.TrainLogger(str(tmp_path / name))
        log.log(res, 'train', 7, verbose=True)
        log.log(res, 'val', 8)
    for split in ('train', 'val'):
        assert (open(tmp_path / 'p' / f'{split}.txt').read()
                == open(tmp_path / 'j' / f'{split}.txt').read())
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == ('step 7 loss=0.12346 step_ms=12.5 n=3 '
                                'tag=x')


def test_profile_trace_writes_a_chrome_trace(tmp_path, capsys):
    from tensoflow_tpu_torch.utils import timing as pt
    with pt.profile_trace(str(tmp_path / 'tr')):
        torch.ones(64).sum()
    trace = json.load(open(tmp_path / 'tr' / 'trace.json'))
    assert trace['traceEvents']
    assert f'trace written to {tmp_path / "tr"}' in capsys.readouterr().out
    with pt.profile_trace(str(tmp_path / 'off'), enabled=False):
        pass
    assert not os.path.exists(tmp_path / 'off')
