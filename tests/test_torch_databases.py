"""The port's dataset layer (tensoflow_tpu_torch/data/database.py,
colmap_db.py, colmap_model.py, colmap_dense.py) against the JAX package's.

Each layout (tensoSDF, nerf, tensoIR, orb, syn, real/<size>,
custom/raw, custom/raw_<len>, custom/<size>) is written under tmp_path
with imageio / cv2, as tests/test_colmap_crop.py writes its scene, and
opened by both packages' ``parse_database_name``: ids, images, masks,
normals, albedo, depth and splits must be equal, poses and K equal to
rtol 1e-6.  The COLMAP layouts are opened in two directories, one first
by the JAX package and one first by the port, so each package also reads
the other's caches (cache.pkl, images_<x>/, meta_info.pkl); the resized
and cropped images of the two are held to within one uint8 level, and
the share of pixels that differ at all is printed and asserted (0 on
these scenes: image_ops reproduces cv2 exactly here).

Also: the COLMAP model and dense IO across the packages, every config's
database name dispatching to the same adapter class, the published
custom/* ray setting on COLMAP poses in both packages, chip_smoke.py's
layout writers read back by its own checks at a small size, and a
ShapeTrainer built from a tensoSDF layout of a toy scene giving the ray
batch and the first step of the same trainer fed the views through
ToyDatabase.
"""
import glob
import json
import os
import pickle
import sys

import imageio.v2 as iio
import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from tensoflow_tpu.data import colmap_db as j_colmap_db  # noqa: E402
from tensoflow_tpu.data import colmap_dense as j_dense  # noqa: E402
from tensoflow_tpu.data import colmap_model as j_cm  # noqa: E402
from tensoflow_tpu.data import database as j_db  # noqa: E402
from tensoflow_tpu.ops.mesh import write_ply  # noqa: E402
from tensoflow_tpu_torch.data import colmap_db as p_colmap_db  # noqa: E402
from tensoflow_tpu_torch.data import colmap_dense as p_dense  # noqa: E402
from tensoflow_tpu_torch.data import colmap_model as p_cm  # noqa: E402
from tensoflow_tpu_torch.data import database as p_db  # noqa: E402
from tensoflow_tpu_torch.data import toy as p_toy  # noqa: E402

from test_torch_image_io import write_exr  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32


def _num(v):
    return repr(float(v))


def _views(n, seed, alpha=True):
    """n RGB(A) uint8 views: gradients, a disk of alpha 255 with a soft
    rim of partial alpha, noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    out = []
    for k in range(n):
        rgb = np.stack([(xx * 7 + k * 13) % 256, (yy * 9 + k * 5) % 256,
                        (xx * yy + 31 * k) % 256], -1)
        rgb = np.clip(rgb + rng.randint(-9, 9, rgb.shape), 0, 255)
        r = np.hypot(xx - W / 2 - k, yy - H / 2)
        a = np.clip((9.5 - r) * 90, 0, 255)
        img = np.concatenate([rgb, a[..., None]], -1) if alpha else rgb
        out.append(img.astype(np.uint8))
    return out


def _c2w(k, n, dist=2.0):
    az = 2 * np.pi * k / n
    eye = dist * np.array([np.cos(az) * 0.8, np.sin(az) * 0.8, 0.6])
    return p_toy._look_at(eye)


def _look_at_w2c(eye, target=np.array([0.2, 0.1, 0.1])):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd], 0)
    return np.concatenate([rot, (-rot @ eye)[:, None]], 1)


def _normal_png(path, seed):
    rng = np.random.RandomState(seed)
    n = rng.randn(H, W, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.concatenate([(n * 0.5 + 0.5) * 255,
                          rng.randint(0, 2, (H, W, 1)) * 255], -1)
    cv2.imwrite(path, img.astype(np.uint8)[..., [2, 1, 0, 3]])


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------

def write_transforms_layout(root, splits, extras=False, cax=0.69):
    """Blender layout: transforms_<split>.json + RGBA pngs (imageio); with
    ``extras`` the test split gets _normal.png and a ZIP / HALF RGBA
    _diffColor.exr.  Returns the diffColor planes written, per frame."""
    os.makedirs(root, exist_ok=True)
    written = []
    n_all = sum(splits.values())
    k0 = 0
    for split, n in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k, img in enumerate(_views(n, seed=len(split) + n)):
            fp = f'./{split}/r_{k}'
            iio.imwrite(os.path.join(root, fp + '.png'), img)
            frames.append({'file_path': fp, 'transform_matrix':
                           _c2w(k0 + k, n_all).tolist()})
            if extras and split == 'test':
                _normal_png(os.path.join(root, fp + '_normal.png'), k)
                rng = np.random.RandomState(k)
                planes = {c: rng.rand(H, W).astype(np.float32)
                          for c in 'RGBA'}
                write_exr(os.path.join(root, fp + '_diffColor.exr'), planes,
                          'ZIP', 'HALF')
                written.append(planes)
        k0 += n
        with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
            json.dump({'camera_angle_x': cax, 'frames': frames}, f)
    return written


def write_tensoir(root):
    for split, n in (('train', 3), ('val', 1), ('test', 2)):
        for k, img in enumerate(_views(n, seed=40 + n)):
            d = os.path.join(root, f'{split}_{k:03d}')
            os.makedirs(d)
            meta = {'cam_transform_mat': ','.join(
                        map(_num, _c2w(k, n).reshape(-1).tolist())),
                    'imh': H, 'imw': W, 'cam_angle_x': 0.71}
            with open(os.path.join(d, 'metadata.json'), 'w') as f:
                json.dump(meta, f)
            iio.imwrite(os.path.join(d, 'rgba_sunset_000.png'), img)
            if split == 'test':
                _normal_png(os.path.join(d, 'normal.png'), 50 + k)
                alb = _views(1, seed=60 + k)[0]
                cv2.imwrite(os.path.join(d, 'albedo.png'),
                            alb[..., [2, 1, 0, 3]])


def write_orb(root):
    d = os.path.join(root, 'blender_format_LDR')
    for split, n, alpha in (('train', 3, True), ('test', 2, False)):
        frames = []
        for k, img in enumerate(_views(n, seed=70 + n, alpha=alpha)):
            fp = f'{split}/{k:04d}'
            os.makedirs(os.path.join(d, split), exist_ok=True)
            cv2.imwrite(os.path.join(d, fp + '.png'),
                        img[..., [2, 1, 0, 3][:img.shape[-1]]])
            frames.append({'file_path': fp,
                           'transform_matrix': _c2w(k, n).tolist()})
        with open(os.path.join(d, f'transforms_{split}.json'), 'w') as f:
            json.dump({'camera_angle_x': 0.6, 'frames': frames}, f)


def write_glossy_syn(root):
    os.makedirs(root)
    rng = np.random.RandomState(80)
    for k, img in enumerate(_views(3, seed=81)):
        cv2.imwrite(os.path.join(root, f'{k}.png'), img[..., [2, 1, 0, 3]])
        depth = rng.randint(0, 65536, (H, W)).astype(np.uint16)
        depth[:4] = 65535                                   # background
        cv2.imwrite(os.path.join(root, f'{k}-depth.png'), depth)
        K = np.array([[40.0 + k, 0, W / 2], [0, 41.0, H / 2], [0, 0, 1]])
        with open(os.path.join(root, f'{k}-camera.pkl'), 'wb') as f:
            pickle.dump((_c2w(k, 3)[:3].copy(), K), f)


def write_colmap_scene(root, n=3, masks=False, text=False, ext='.png'):
    """COLMAP capture: images/*<ext> (cv2), a sparse model (binary, or
    text with ``text``), object_point_cloud.ply, optional masks/."""
    os.makedirs(os.path.join(root, 'images'))
    sparse = os.path.join(root, 'colmap', 'sparse', '0')
    rng = np.random.RandomState(90)
    d = rng.randn(128, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (np.asarray([0.2, 0.1, 0.1]) + 0.15 * d).astype(np.float32)
    write_ply(os.path.join(root, 'object_point_cloud.ply'), pts,
              np.zeros((0, 3), np.int32))
    cams = {1: j_cm.Camera(1, 'PINHOLE', W, H,
                           np.array([60.0, 61.0, W / 2 + 1.5, H / 2 - 1]))}
    images = {}
    eyes = [[1.3, 0.2, 0.4], [0.3, 1.4, 0.5], [-0.9, -0.8, 0.7],
            [0.6, -1.2, 0.9]][:n]
    for i, (eye, img) in enumerate(zip(eyes, _views(n, 91, alpha=False))):
        pose = _look_at_w2c(np.asarray(eye))
        name = f'view{i}{ext}'
        images[i + 1] = j_cm.Image(i + 1, j_cm.rotmat2qvec(pose[:, :3]),
                                   pose[:, 3], 1, name, np.zeros((0, 2)),
                                   np.zeros(0, np.int64))
        cv2.imwrite(os.path.join(root, 'images', name), img[..., ::-1])
        if masks and i != 1:                        # view1: no mask file
            os.makedirs(os.path.join(root, 'masks'), exist_ok=True)
            m = (rng.rand(H, W) > 0.5).astype(np.uint8) * 255
            cv2.imwrite(os.path.join(root, 'masks', name), m)
    if text:
        os.makedirs(sparse)
        with open(os.path.join(sparse, 'cameras.txt'), 'w') as f:
            c = cams[1]
            f.write(f'1 PINHOLE {W} {H} ' + ' '.join(map(_num, c.params))
                    + '\n')
        with open(os.path.join(sparse, 'images.txt'), 'w') as f:
            for i, im in images.items():
                f.write(f'{i} ' + ' '.join(map(_num, im.qvec)) + ' '
                        + ' '.join(map(_num, im.tvec)) + f' 1 {im.name}\n'
                        '0.0 0.0 -1\n')
    else:
        j_cm.write_model(cams, images, {}, sparse)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def assert_same(jdb, pdb, getters=(), image_levels=0):
    """Both databases give the same ids, images (within ``image_levels``
    uint8 levels, with the share that differs returned), masks, depth and
    the ``getters``; poses and K to rtol 1e-6."""
    ids = list(jdb.get_img_ids())
    assert list(pdb.get_img_ids()) == ids
    differ = []
    for i in ids:
        a, b = jdb.get_image(i), pdb.get_image(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert d.max() <= image_levels, (i, d.max())
        differ.append((d > 0).mean())
        np.testing.assert_allclose(pdb.get_pose(i), jdb.get_pose(i),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(pdb.get_K(i), jdb.get_K(i), rtol=1e-6)
        ma, mb = jdb.get_mask(i), pdb.get_mask(i)
        assert (ma is None) == (mb is None)
        if ma is not None:
            np.testing.assert_array_equal(mb, ma)
        for x, y in zip(jdb.get_depth(i), pdb.get_depth(i)):
            np.testing.assert_array_equal(y, x)
        for g in getters:
            np.testing.assert_array_equal(getattr(pdb, g)(i),
                                          getattr(jdb, g)(i))
    for manul in (False, True):
        assert p_db.get_database_split(pdb, split_manul=manul,
                                       split_borderline=2) == \
            j_db.get_database_split(jdb, split_manul=manul,
                                    split_borderline=2)
    return float(np.mean(differ))


def _open(mod, name, root, **kw):
    return mod.parse_database_name(name, str(root), **kw)


@pytest.mark.parametrize('is_test', [False, True])
@pytest.mark.parametrize('white', [False, True])
def test_tensosdf_layout(tmp_path, is_test, white):
    written = write_transforms_layout(
        str(tmp_path / 'compressor'), {'train': 3, 'val': 2, 'test': 2},
        extras=True)
    kw = dict(isTest=is_test, isWhiteBG=white)
    jdb = _open(j_db, 'tensoSDF/compressor', tmp_path, **kw)
    pdb = _open(p_db, 'tensoSDF/compressor', tmp_path, **kw)
    assert type(pdb).__name__ == 'TensoSDFSynDatabase'
    assert_same(jdb, pdb, ('get_normal',) if is_test else ())
    if is_test:
        # the JAX package reads diffColor through cv2, which here has no
        # EXR codec, so it holds none; the port's equals what was written
        assert len(pdb.diffColor_all) == 2
        for i, planes in enumerate(written):
            half = {c: planes[c].astype(np.float16).astype(np.float32)
                    for c in 'RGBA'}
            want = (np.stack([half[c] for c in 'RGB'], -1)
                    * half['A'][..., None])
            np.testing.assert_array_equal(pdb.get_albedo(i), want)
            if jdb.diffColor_all:
                np.testing.assert_array_equal(pdb.get_albedo(i),
                                              jdb.get_albedo(i))


def test_nerf_layout_and_scale(tmp_path):
    write_transforms_layout(str(tmp_path / 'lego'), {'train': 3, 'val': 1})
    for name in ('nerf/lego', 'nerf/lego/0.8'):
        jdb = _open(j_db, name, tmp_path, isWhiteBG=True)
        pdb = _open(p_db, name, tmp_path, isWhiteBG=True)
        assert type(pdb).__name__ == 'NeRFSynDatabase'
        assert pdb.scale_factor == jdb.scale_factor
        assert_same(jdb, pdb)


@pytest.mark.parametrize('is_test', [False, True])
def test_tensoir_layout(tmp_path, is_test):
    write_tensoir(str(tmp_path / 'armadillo'))
    jdb = _open(j_db, 'tensoIR/armadillo', tmp_path, isTest=is_test)
    pdb = _open(p_db, 'tensoIR/armadillo', tmp_path, isTest=is_test)
    assert type(pdb).__name__ == 'TensoIRDatabase'
    assert_same(jdb, pdb, ('get_normal', 'get_albedo') if is_test else ())


@pytest.mark.parametrize('is_test', [False, True])
def test_orb_layout(tmp_path, is_test):
    write_orb(str(tmp_path / 'cactus_scene001'))
    jdb = _open(j_db, 'orb/cactus_scene001', tmp_path, isTest=is_test,
                isWhiteBG=True)
    pdb = _open(p_db, 'orb/cactus_scene001', tmp_path, isTest=is_test,
                isWhiteBG=True)
    assert type(pdb).__name__ == 'ORBDatabase'
    assert_same(jdb, pdb)


def test_glossy_synthetic_layout(tmp_path):
    write_glossy_syn(str(tmp_path / 'horse'))
    jdb = _open(j_db, 'syn/horse', tmp_path)
    pdb = _open(p_db, 'syn/horse', tmp_path)
    assert type(pdb).__name__ == 'GlossySyntheticDatabase'
    assert_same(jdb, pdb)


COLMAP_CASES = [('real/bear/24', False, '.png'),
                ('real/bear/6', False, '.png'),
                ('custom/shoe/raw', True, '.png'),
                ('custom/shoe/raw_16', True, '.png'),
                ('custom/shoe/raw_20', False, '.png'),
                ('custom/shoe/18', True, '.png'),
                ('custom/shoe/raw', False, '.jpg'),
                ('custom/shoe/raw_20', False, '.jpg'),
                ('real/bear/6', False, '.jpg')]


@pytest.mark.parametrize('name,masks,ext', COLMAP_CASES,
                         ids=[c[0] + c[2] for c in COLMAP_CASES])
def test_colmap_layouts_and_caches_cross_read(tmp_path, name, masks, ext):
    """Directory A is opened first by the JAX package, B first by the
    port; each package then opens the other's.  real/bear/6 takes the
    crop's blur branch, raw_16 cv2's 2x fast path, raw_20 its area
    weights; the .jpg captures have JPEG caches, as cv2 writes them."""
    obj = name.split('/')[1]
    for d in ('a', 'b'):
        write_colmap_scene(str(tmp_path / d / obj), masks=masks,
                           text=name.endswith('raw'), ext=ext)
    j_a = _open(j_db, name, tmp_path / 'a')
    p_a = _open(p_db, name, tmp_path / 'a')       # reads the JAX caches
    p_b = _open(p_db, name, tmp_path / 'b')
    j_b = _open(j_db, name, tmp_path / 'b')       # reads the port's caches
    assert type(p_a).__name__ == type(j_a).__name__
    assert_same(j_a, p_a)
    assert_same(j_b, p_b)
    share = assert_same(j_a, p_b, image_levels=1)
    print(f'{name}: share of pixels where the port\'s cache differs from '
          f'cv2\'s: {share:.6f}')
    assert share == 0.0
    cached = sorted(os.path.relpath(p, tmp_path / 'b') for p in glob.glob(
        str(tmp_path / 'b' / obj / '**' / '*.p*'), recursive=True))
    assert os.path.join(obj, 'cache.pkl') in cached
    if not name.split('/')[2].startswith('raw'):
        assert os.path.join(obj, f'images_{name.split("/")[2]}',
                            'meta_info.pkl') in cached


def test_test_split_needs_the_split_pickle(tmp_path, monkeypatch):
    """configs/synthetic_split_128.pkl is not in the repository: both
    packages raise FileNotFoundError for split_type 'test'."""
    monkeypatch.chdir(ROOT)
    db = p_toy.ToyDatabase('toy/sphere_8_2')
    for mod in (j_db, p_db):
        with pytest.raises(FileNotFoundError):
            mod.get_database_split(db, split_type='test')


# ---------------------------------------------------------------------------
# COLMAP model and dense IO across the packages
# ---------------------------------------------------------------------------

def _model(cm):
    rng = np.random.RandomState(0)
    cams = {1: cm.Camera(1, 'PINHOLE', 640, 480,
                         np.array([500.0, 510.0, 320.0, 240.0])),
            2: cm.Camera(2, 'SIMPLE_RADIAL', 800, 600,
                         np.array([450.0, 400.0, 300.0, 0.01]))}
    images = {}
    for i in (1, 2, 3):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        n = rng.randint(0, 5)
        images[i] = cm.Image(i, q, rng.randn(3), 1 + (i % 2),
                             f'frame_{i:04d}.png', rng.rand(n, 2) * 640,
                             rng.randint(-1, 100, n).astype(np.int64))
    pts = {}
    for j in (10, 11):
        t = rng.randint(1, 4)
        pts[j] = cm.Point3D(j, rng.randn(3),
                            rng.randint(0, 256, 3).astype(np.uint8),
                            float(rng.rand()),
                            rng.randint(1, 4, t).astype(np.int32),
                            rng.randint(0, 5, t).astype(np.int32))
    return cams, images, pts


def _assert_models_equal(a, b):
    for da, db in zip(a, b):
        assert set(da) == set(db)
        for k in da:
            for fa, fb in zip(da[k], db[k]):
                if isinstance(fa, np.ndarray):
                    np.testing.assert_array_equal(fb, fa)
                else:
                    assert fa == fb


@pytest.mark.parametrize('writer,reader', [(j_cm, p_cm), (p_cm, j_cm)],
                         ids=['jax-to-port', 'port-to-jax'])
def test_colmap_model_io_across_packages(tmp_path, writer, reader):
    model = _model(writer)
    writer.write_model(*model, str(tmp_path / 'bin'))
    _assert_models_equal(j_cm.read_model(str(tmp_path / 'bin')),
                         reader.read_model(str(tmp_path / 'bin')))
    _assert_models_equal(model, reader.read_model(str(tmp_path / 'bin')))
    text = tmp_path / 'txt'
    text.mkdir()
    cams, images, _ = model
    with open(text / 'cameras.txt', 'w') as f:
        f.write('# camera list\n')
        for c in cams.values():
            f.write(f'{c.id} {c.model} {c.width} {c.height} '
                    + ' '.join(map(_num, c.params)) + '\n')
    with open(text / 'images.txt', 'w') as f:
        for im in images.values():
            f.write(f'{im.id} ' + ' '.join(map(_num, im.qvec)) + ' '
                    + ' '.join(map(_num, im.tvec))
                    + f' {im.camera_id} {im.name}\n'
                    + (' '.join(f'{_num(x)} {_num(y)} {p}' for (x, y), p in
                                zip(im.xys, im.point3D_ids))
                       or '0.0 0.0 -1') + '\n')
    _assert_models_equal(reader.read_model(str(text)),
                         writer.read_model(str(text)))
    for i, im in images.items():
        np.testing.assert_array_equal(p_cm.qvec2rotmat(im.qvec),
                                      j_cm.qvec2rotmat(im.qvec))
        np.testing.assert_array_equal(
            p_cm.rotmat2qvec(p_cm.qvec2rotmat(im.qvec)),
            j_cm.rotmat2qvec(j_cm.qvec2rotmat(im.qvec)))
    for c in cams.values():
        np.testing.assert_array_equal(p_cm.camera_K(c), j_cm.camera_K(c))


@pytest.mark.parametrize('writer,reader', [(j_dense, p_dense),
                                           (p_dense, j_dense)],
                         ids=['jax-to-port', 'port-to-jax'])
def test_colmap_dense_io_across_packages(tmp_path, writer, reader):
    rng = np.random.RandomState(1)
    depth = rng.rand(7, 5, 3).astype(np.float32)
    writer.write_array(depth, str(tmp_path / 'd.bin'))
    np.testing.assert_array_equal(reader.read_array(str(tmp_path / 'd.bin')),
                                  depth)
    props = {'x': rng.rand(9).astype(np.float32),
             'y': rng.rand(9).astype(np.float32),
             'z': rng.rand(9).astype(np.float32),
             'red': rng.randint(0, 256, 9).astype(np.uint8)}
    writer.write_ply_points(str(tmp_path / 'p.ply'), props)
    got = reader.read_ply_points(str(tmp_path / 'p.ply'))
    for k, v in props.items():
        np.testing.assert_array_equal(got[k], v)
    pts = [writer.FusedPoint(rng.rand(3).astype(np.float32),
                             rng.randint(0, 256, 3).astype(np.uint8),
                             rng.rand(3).astype(np.float32),
                             rng.randint(0, 9, rng.randint(1, 4)))
           for _ in range(4)]
    writer.write_fused(pts, str(tmp_path / 'f.ply'), str(tmp_path / 'f.vis'))
    back = reader.read_fused(str(tmp_path / 'f.ply'), str(tmp_path / 'f.vis'))
    assert len(back) == len(pts)
    for a, b in zip(pts, back):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fb), np.asarray(fa))


# ---------------------------------------------------------------------------
# every published config opens the adapter the JAX package opens
# ---------------------------------------------------------------------------

CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'configs', '**', '*.yaml'),
                           recursive=True))


def test_every_config_dispatches_to_the_same_adapter(monkeypatch):
    from tensoflow_tpu_torch.config import load_config
    from tensoflow_tpu_torch.data import toy as p_toy_mod
    from tensoflow_tpu.data import toy as j_toy_mod
    classes = {}
    for mods in ((j_db, j_colmap_db, j_toy_mod),
                 (p_db, p_colmap_db, p_toy_mod)):
        for mod in mods:
            for name in ('TensoSDFSynDatabase', 'NeRFSynDatabase',
                         'TensoIRDatabase', 'ORBDatabase', 'ToyDatabase',
                         'GlossyRealDatabase', 'GlossySyntheticDatabase',
                         'CustomDatabase'):
                cls = getattr(mod, name, None)
                if cls is not None:
                    monkeypatch.setattr(cls, '__init__',
                                        lambda self, *a, **k: None)
                    classes[cls] = mod.__name__
    seen = {}
    for path in CONFIGS:
        cfg = load_config(path)
        name = cfg['database_name']
        jd = j_db.parse_database_name(name, cfg['dataset_dir'])
        pd = p_db.parse_database_name(name, cfg['dataset_dir'])
        assert classes[type(pd)].startswith('tensoflow_tpu_torch.'), path
        assert type(pd).__name__ == type(jd).__name__, path
        seen[name.split('/')[0]] = type(pd).__name__
    assert seen == {'tensoSDF': 'TensoSDFSynDatabase',
                    'tensoIR': 'TensoIRDatabase', 'orb': 'ORBDatabase',
                    'custom': 'CustomDatabase',
                    'syn': 'GlossySyntheticDatabase', 'toy': 'ToyDatabase'}
    assert len(CONFIGS) >= 52


# ---------------------------------------------------------------------------
# stage 1 from a layout on disk
# ---------------------------------------------------------------------------

SMALL_HIER = ['sdf_n_comp=2', 'sdf_dim=16', 'app_dim=8',
              'N_voxel_init=4096', 'N_voxel_final=4096', 'train_ray_num=32',
              'n_samples=8', 'n_importance=8', 'occ_loss_max_pn=16',
              'upsample_list=null', 'split_manul=false', 'init_radius=0.5']


def test_shape_trainer_from_disk_matches_toy_database(tmp_path):
    from tensoflow_tpu_torch import config as pconfig
    from tensoflow_tpu_torch.train.trainer import ShapeTrainer
    toy = p_toy.ToyDatabase('toy/sphere_16_4')
    chip_smoke.write_blender_layout(toy, str(tmp_path / 'sphere'),
                                    extras=False)
    runs = {}
    for name, ddir in (('toy/sphere_16_4', 'unused'),
                       ('tensoSDF/sphere', str(tmp_path))):
        cfg = pconfig.load_config(
            os.path.join(ROOT, 'configs/shape/syn/compressor.yaml'),
            overrides=SMALL_HIER + [f'database_name={name}',
                                    f'dataset_dir={ddir}'])
        trainer = ShapeTrainer(cfg, device='cpu')
        trainer.init_dataset()
        batch = {k: v.copy() for k, v in trainer.batcher.batch.items()}
        runs[name] = (trainer, batch, trainer.train(n_steps=1, log_every=1))
    (t0, b0, l0), (t1, b1, l1) = runs.values()
    assert type(t1.database).__name__ == 'TensoSDFSynDatabase'
    assert t0.train_ids == t1.train_ids and t0.test_ids == t1.test_ids
    assert set(b0) == set(b1)
    for k in b0:
        np.testing.assert_array_equal(b1[k], b0[k], err_msg=k)
    assert l0 == l1


def test_chip_smoke_layouts_read_back(tmp_path, monkeypatch):
    """chip_smoke.py's datasets phase at a small size: its writers put a
    toy scene in every layout and its checks read each back equal."""
    monkeypatch.setattr(chip_smoke, 'RESIZE_LEN', 8)
    monkeypatch.setattr(chip_smoke, 'CROP_SIZE', 12)
    toy = p_toy.ToyDatabase('toy/blobs_16_8')
    counts = chip_smoke.check_layouts(toy, chip_smoke.write_layouts(
        toy, str(tmp_path)))
    assert counts == {
        'tensoSDF/blobs (tensoSDF)': 10, 'nerf/blobs (nerf)': 8,
        'tensoIR/blobs (tensoIR)': 10, 'orb/blobs (orb)': 10,
        'syn/blobs (syn)': 8, 'custom/blobs/raw (custom)': 8,
        'custom/blobs/raw_8 (custom_resize)': 8,
        'custom/blobs/raw_8 (custom_jpeg)': 8,
        'custom/blobs/12 (custom_crop)': 8, 'real/blobs/12 (real)': 8}


def test_custom_configs_published_rays_on_colmap_poses(tmp_path):
    """configs/shape/custom/*.yaml publish nerfDataType true; CustomDatabase
    gives COLMAP w2c poses in both packages.  The nerf ray function then
    starts every ray at a w2c translation: both packages keep the same
    rays after the aabb filter (none on this capture), and the w2c function
    keeps the same rays in both."""
    from tensoflow_tpu.data import rays as j_rays
    from tensoflow_tpu_torch.data import rays as p_rays
    toy = p_toy.ToyDatabase('toy/blobs_16_8')
    chip_smoke.write_colmap_layout(toy, str(tmp_path / 'blobs'))
    kept = {}
    for db_m, rays in ((j_db, j_rays), (p_db, p_rays)):
        db = db_m.parse_database_name('custom/blobs/raw', str(tmp_path))
        info = rays.build_imgs_info(db, db.get_img_ids())
        for build in ('construct_ray_batch_nerf', 'construct_ray_batch_w2c'):
            batch = getattr(rays, build)(info)[0]
            kept[build, db_m.__name__] = rays.filter_rays_aabb(
                batch, [[-1, -1, -1], [1, 1, 1]])
    for build in ('construct_ray_batch_nerf', 'construct_ray_batch_w2c'):
        a, b = (kept[build, m.__name__] for m in (j_db, p_db))
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=(build, k))
    assert len(kept['construct_ray_batch_nerf', p_db.__name__]['rays_o']) == 0
    assert len(kept['construct_ray_batch_w2c', p_db.__name__]['rays_o']) > 0
