"""The port's image IO (tensoflow_tpu_torch/data/image_io.py) and cv2
operations (data/image_ops.py) against imageio and cv2.

  * PNG: every colour type and bit depth, files written by imageio, by
    cv2 (adaptive filters) and by the test itself with each of the five
    filter types forced per row, decoded exactly as imageio.v2.imread
    decodes them; the C++ defilter against the numpy plain version byte
    for byte; imwrite_png read back by imageio; interlaced PNG raises.
  * JPEG: baseline files of every chroma sampling, gray, with restart
    markers, from cv2 and from Pillow, decoded exactly as imageio decodes
    them; imwrite_jpeg's files byte for byte those of cv2.imwrite;
    progressive JPEG raises.
  * EXR: scanline files written here to the OpenEXR layout (NONE, RLE,
    ZIPS, ZIP; HALF and FLOAT; channels stored A, B, G, R; a data window
    that does not start at 0) read back exactly; PIZ and tiled raise.
  * image_ops: GaussianBlur, warpPerspective and resize INTER_AREA
    against cv2 (exact on these inputs; the crop's tolerance of one uint8
    level is held in test_torch_databases.py).
"""
import struct
import zlib

import imageio.v2 as iio
import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

cv2 = pytest.importorskip('cv2')

from tensoflow_tpu_torch.data import image_io, image_ops  # noqa: E402

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------------------
# writers the test controls
# ---------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def _pack(vals, bits):
    """[h, n] sample values -> [h, stride] bytes at ``bits`` per sample."""
    if bits == 8:
        return vals.astype(np.uint8)
    if bits == 16:
        return vals.astype('>u2').view(np.uint8).reshape(len(vals), -1)
    per = 8 // bits
    pad = (-vals.shape[1]) % per
    v = np.concatenate([vals, np.zeros((len(vals), pad), vals.dtype)], 1)
    v = v.reshape(len(vals), -1, per).astype(np.int64)
    out = np.zeros(v.shape[:2], np.int64)
    for k in range(per):
        out |= v[..., k] << (8 - bits * (k + 1))
    return out.astype(np.uint8)


def _filter_row(cur, prior, bpp, ft):
    cur, prior = cur.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if ft == 0:
        pred = 0
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = prior
    elif ft == 3:
        pred = (a + prior) >> 1
    else:
        p = a + prior - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, prior, c))
    return ((cur - pred) & 255).astype(np.uint8)


def write_png_forced(path, rows, w, bits, ctype, filters, extra=b'',
                     interlace=0):
    """A PNG of the packed scanlines ``rows`` [h, stride] whose row y is
    filtered with filters[y % len(filters)]; the IDAT split in three."""
    bpp = max(1, CHANNELS[ctype] * bits // 8)
    prior = np.zeros(rows.shape[1], np.uint8)
    body = []
    for y, cur in enumerate(rows):
        ft = filters[y % len(filters)]
        body.append(bytes([ft]) + _filter_row(cur, prior, bpp, ft).tobytes())
        prior = cur
    data = zlib.compress(b''.join(body))
    third = len(data) // 3
    idat = b''.join(_chunk(b'IDAT', data[i:j]) for i, j in (
        (0, third), (third, 2 * third), (2 * third, len(data))))
    with open(path, 'wb') as f:
        f.write(image_io.PNG_SIGNATURE
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, len(rows), bits,
                                              ctype, 0, 0, interlace))
                + _chunk(b'gAMA', struct.pack('>I', 45455)) + extra + idat
                + _chunk(b'IEND', b''))


def _rle_encode(b: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(b):
        j = i
        while j + 1 < len(b) and b[j + 1] == b[i] and j - i < 127:
            j += 1
        if j - i >= 2:                       # a run of j - i + 1 bytes
            out += struct.pack('b', j - i) + b[i:i + 1]
            i = j + 1
            continue
        k = i                                # literals up to the next run
        while k < len(b) and k - i < 127 and not (
                k + 2 < len(b) and b[k] == b[k + 1] == b[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += struct.pack('b', -(k - i)) + b[i:k]
        i = k
    return bytes(out)


def _exr_predict(raw: bytes) -> bytes:
    """OpenEXR's split of even/odd bytes and byte delta (the inverse of
    what a reader undoes)."""
    t = np.frombuffer(raw, np.uint8)
    s = np.concatenate([t[0::2], t[1::2]]).astype(np.int64)
    d = s.copy()
    d[1:] = (s[1:] - s[:-1] + 128) & 255
    return d.astype(np.uint8).tobytes()


def write_exr(path, planes, compression='ZIP', ptype='HALF', origin=(0, 0),
              version_flags=0):
    """A scanline OpenEXR file of ``planes`` {name: [h, w] float} (stored in
    the alphabetical order EXR uses) with the given compression; returns
    the number of blocks stored compressed."""
    comp = {'NONE': 0, 'RLE': 1, 'ZIPS': 2, 'ZIP': 3, 'PIZ': 4}[compression]
    lines = {'NONE': 1, 'RLE': 1, 'ZIPS': 1, 'ZIP': 16, 'PIZ': 32}[
        compression]
    names = sorted(planes)
    h, w = planes[names[0]].shape
    dt = np.dtype('<f2') if ptype == 'HALF' else np.dtype('<f4')
    code = 1 if ptype == 'HALF' else 2
    x0, y0 = origin

    def attr(name, kind, body):
        return (name.encode() + b'\0' + kind.encode() + b'\0'
                + struct.pack('<i', len(body)) + body)
    chl = b''.join(n.encode() + b'\0' + struct.pack('<iB3xii', code, 0, 1, 1)
                   for n in names) + b'\0'
    box = struct.pack('<iiii', x0, y0, x0 + w - 1, y0 + h - 1)
    header = (struct.pack('<ii', image_io.EXR_MAGIC, 2 | version_flags)
              + attr('channels', 'chlist', chl)
              + attr('compression', 'compression', bytes([comp]))
              + attr('dataWindow', 'box2i', box)
              + attr('displayWindow', 'box2i', box)
              + attr('lineOrder', 'lineOrder', b'\0')
              + attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
              + attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0, 0))
              + attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
              + b'\0')
    blocks, packed = [], 0
    for yb in range(0, h, lines):
        raw = b''.join(planes[n][y].astype(dt).tobytes()
                       for y in range(yb, min(yb + lines, h)) for n in names)
        if comp == 1:
            data = _rle_encode(_exr_predict(raw))
        elif comp in (2, 3, 4):
            data = zlib.compress(_exr_predict(raw))
        else:
            data = raw
        if len(data) >= len(raw):
            data = raw                       # stored as is, as OpenEXR does
        packed += data is not raw
        blocks.append(struct.pack('<ii', y0 + yb, len(data)) + data)
    pos = len(header) + 8 * len(blocks)
    table = []
    for b in blocks:
        table.append(pos)
        pos += len(b)
    with open(path, 'wb') as f:
        f.write(header + struct.pack(f'<{len(table)}Q', *table)
                + b''.join(blocks))
    return packed


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

DEPTHS = [(0, b) for b in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + [
    (3, b) for b in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize('ctype,bits', DEPTHS,
                         ids=[f'ct{c}-{b}bit' for c, b in DEPTHS])
def test_png_every_type_and_filter_matches_imageio(tmp_path, ctype, bits):
    """Each colour type and depth with the five filters in turn per row
    (and a palette with a tRNS chunk, which imageio ignores)."""
    rng = np.random.RandomState(ctype * 100 + bits)
    w, h = 13, 11
    ch = CHANNELS[ctype]
    hi = 15 if ctype == 3 else (1 << bits) - 1
    vals = rng.randint(0, hi + 1, (h, w * ch))
    vals[:, ch:] = (vals[:, ch:] // 3 + vals[:, :-ch] // 2) % (hi + 1)
    extra = b''
    if ctype == 3:
        extra = (_chunk(b'PLTE', rng.randint(0, 256, 48).astype(
            np.uint8).tobytes()) + _chunk(b'tRNS', bytes([0, 128, 255])))
    for order in ([0, 1, 2, 3, 4], [4, 3, 2, 1, 0], [4], [3]):
        path = str(tmp_path / f'f{order[0]}.png')
        write_png_forced(path, _pack(vals, bits), w, bits, ctype, order,
                         extra)
        ref = iio.imread(path)
        got = image_io.imread(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (
            order, got.dtype, got.shape, ref.dtype, ref.shape)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('shape,dtype', [
    ((31, 45), np.uint8), ((31, 45, 3), np.uint8), ((31, 45, 4), np.uint8),
    ((31, 45), np.uint16), ((31, 45, 3), np.uint16), ((31, 45, 4), np.uint16),
    ((31, 45, 2), np.uint8)])
def test_png_writers_round_trip(tmp_path, shape, dtype):
    """Files of cv2 (libpng's adaptive filters) and imageio decode as
    imageio decodes them; imwrite_png's files decode to what was written
    (imageio keeps only the high byte of 16-bit colour)."""
    rng = np.random.RandomState(len(shape) * 7 + shape[-1])
    top = np.iinfo(dtype).max
    x = (rng.rand(*shape) * top).astype(dtype)
    x = np.cumsum(x, 1, dtype=np.int64).astype(dtype)       # smooth rows
    if shape[-1] != 2:
        cv2.imwrite(str(tmp_path / 'c.png'), x)
        np.testing.assert_array_equal(image_io.imread(str(tmp_path / 'c.png')),
                                      iio.imread(str(tmp_path / 'c.png')))
    if dtype == np.uint8 or len(shape) == 2:
        iio.imwrite(str(tmp_path / 'i.png'), x)
        np.testing.assert_array_equal(image_io.imread(str(tmp_path / 'i.png')),
                                      iio.imread(str(tmp_path / 'i.png')))
    image_io.imwrite_png(str(tmp_path / 'p.png'), x)
    back = iio.imread(str(tmp_path / 'p.png'))
    want = x
    if dtype == np.uint16 and len(shape) == 3:
        want = (x >> 8).astype(np.uint8)
    elif shape[-1] == 2 and dtype == np.uint16:
        want = (x >> 8).astype(np.uint8)[..., [0, 0, 0, 1]]
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / 'p.png')),
                                  back)


@settings(max_examples=25, deadline=None)
@given(h=hst.integers(1, 9), w=hst.integers(1, 40),
       bpp=hst.sampled_from([1, 2, 3, 4, 6, 8]),
       seed=hst.integers(0, 2 ** 31 - 1))
def test_cpp_defilter_equals_plain_version(h, w, bpp, seed):
    rng = np.random.RandomState(seed)
    stride = w * bpp
    raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, h)
    np.testing.assert_array_equal(
        image_io.unfilter(raw.reshape(-1), h, stride, bpp),
        image_io.unfilter_plain(raw.reshape(-1), h, stride, bpp))


def test_defilter_rejects_a_bad_filter_type():
    raw = np.zeros((2, 5), np.uint8)
    raw[1, 0] = 7
    for fn in (image_io.unfilter, image_io.unfilter_plain):
        with pytest.raises(ValueError, match='row 1: filter type 7'):
            fn(raw.reshape(-1), 2, 4, 1)


def test_interlaced_png_and_progressive_jpeg_raise(tmp_path):
    path = str(tmp_path / 'adam7.png')
    write_png_forced(path, np.zeros((4, 4), np.uint8), 4, 8, 0, [0],
                     interlace=1)
    with pytest.raises(NotImplementedError, match='adam7.png.*interlaced'):
        image_io.imread(path)
    jpg = str(tmp_path / 'view.jpg')
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match='view.jpg.*progressive'):
        image_io.imread(jpg)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

JPEG_SIZES = [(37, 53), (17, 9), (120, 161), (3, 2), (64, 64)]


def _write_jpeg_case(path, x, case):
    if case == 'gray':
        cv2.imwrite(path, x[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    elif case == 'restart-optimized':
        cv2.imwrite(path, x, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                              cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    elif case == 'pillow':
        iio.imwrite(path, x, quality=75)
    else:
        cv2.imwrite(path, x, [cv2.IMWRITE_JPEG_QUALITY, 90,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              getattr(cv2, 'IMWRITE_JPEG_SAMPLING_FACTOR_'
                                      + case)])


@pytest.mark.parametrize('case', ['420', '422', '444', '440', '411', 'gray',
                                  'restart-optimized', 'pillow'])
def test_jpeg_matches_imageio(tmp_path, case):
    """Baseline JPEGs of every chroma sampling (4:1:1 replicates, the
    others take libjpeg's fancy upsampling), gray, restart markers with
    optimized Huffman tables, and Pillow's writer, at sizes that are and
    are not whole MCUs: equal to imageio's decode."""
    for h, w in JPEG_SIZES:
        path = str(tmp_path / f'{h}x{w}.jpg')
        _write_jpeg_case(path, _image(h, w, 3, seed=h * w), case)
        ref = iio.imread(path)
        got = image_io.imread(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref, err_msg=f'{h}x{w}')


@pytest.mark.parametrize('quality', [95, 75, 30])
def test_jpeg_writer_matches_cv2(tmp_path, quality):
    """imwrite_jpeg writes the file that cv2.imwrite writes (RGB at 4:2:0,
    gray), byte for byte."""
    for h, w in JPEG_SIZES:
        x = _image(h, w, 3, seed=h + w)
        for arr, ref_arr in ((x, x[..., ::-1]), (x[..., 1], x[..., 1])):
            mine, theirs = str(tmp_path / 'p.jpg'), str(tmp_path / 'c.jpg')
            image_io.imwrite_jpeg(mine, arr, quality)
            cv2.imwrite(theirs, ref_arr, [cv2.IMWRITE_JPEG_QUALITY, quality])
            with open(mine, 'rb') as f, open(theirs, 'rb') as g:
                assert f.read() == g.read(), (h, w, arr.ndim)
            np.testing.assert_array_equal(image_io.imread(mine),
                                          iio.imread(theirs))


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------

def _planes(h, w, seed, names='RGBA'):
    rng = np.random.RandomState(seed)
    out = {}
    for n in names:
        p = rng.randint(-8, 24, (h, w)).astype(np.float32) / 8
        p[:, ::3] = p[:, :1]                 # runs for RLE
        p[::4, 1::5] = rng.rand(len(p[::4]), len(p[0, 1::5])) * 3 - 1
        out[n] = p
    return out


@pytest.mark.parametrize('compression', ['NONE', 'RLE', 'ZIPS', 'ZIP'])
@pytest.mark.parametrize('ptype', ['HALF', 'FLOAT'])
def test_exr_scanline_reads_back_exactly(tmp_path, compression, ptype):
    h, w = 37, 23                  # ZIP: two full blocks and a short one
    planes = _planes(h, w, seed=len(compression))
    path = str(tmp_path / 'x.exr')
    packed = write_exr(path, planes, compression, ptype, origin=(5, -3))
    assert (packed > 0) == (compression != 'NONE')
    got = image_io.read_exr(path)
    dt = np.float16 if ptype == 'HALF' else np.float32
    want = np.stack([planes[c].astype(dt) for c in 'RGBA'], -1)
    assert got.dtype == np.float32 and got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_exr_rgb_without_alpha_and_unsupported_files(tmp_path):
    planes = _planes(6, 5, seed=3, names='RGB')
    write_exr(str(tmp_path / 'rgb.exr'), planes, 'ZIPS', 'FLOAT')
    got = image_io.read_exr(str(tmp_path / 'rgb.exr'))
    np.testing.assert_array_equal(
        got, np.stack([planes[c] for c in 'RGB'], -1))
    write_exr(str(tmp_path / 'piz.exr'), planes, 'PIZ', 'HALF')
    with pytest.raises(NotImplementedError, match='compression PIZ'):
        image_io.read_exr(str(tmp_path / 'piz.exr'))
    write_exr(str(tmp_path / 'tiled.exr'), planes, 'ZIP', 'HALF',
              version_flags=0x200)
    with pytest.raises(NotImplementedError, match='tiled'):
        image_io.read_exr(str(tmp_path / 'tiled.exr'))


# ---------------------------------------------------------------------------
# cv2's operations
# ---------------------------------------------------------------------------

def _image(h, w, c, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256,
                     128 + 100 * np.sin(xx / 7.0), (xx * yy) % 256], -1)
    img = np.clip(base[..., :c] + rng.randint(-20, 20, (h, w, c)), 0, 255)
    return img.astype(np.uint8)


@pytest.mark.parametrize('h,w,c,k,sigma', [
    (40, 50, 3, 5, 1.2), (37, 61, 4, 9, 2.7), (20, 23, 1, 3, 0.5),
    (11, 9, 3, 13, 3.3)])
def test_gaussian_blur_matches_cv2(h, w, c, k, sigma):
    img = _image(h, w, c, seed=k)[..., 0] if c == 1 else _image(h, w, c, k)
    np.testing.assert_array_equal(
        image_ops.gaussian_blur(img, k, sigma),
        cv2.GaussianBlur(img, (k, k), sigma,
                         borderType=cv2.BORDER_REFLECT101))


@pytest.mark.parametrize('h,w,tw,th', [
    (80, 100, 40, 32), (90, 120, 30, 30), (64, 64, 16, 16),
    (77, 103, 51, 38), (123, 157, 64, 51)])
def test_resize_area_matches_cv2(h, w, tw, th):
    img = _image(h, w, 4, seed=h)
    np.testing.assert_array_equal(
        image_ops.resize_area(img, (tw, th)),
        cv2.resize(img, (tw, th), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize('ow,oh,c', [(50, 40, 3), (96, 96, 4), (17, 9, 1),
                                     (200, 64, 3)])
def test_warp_perspective_matches_cv2(ow, oh, c):
    rng = np.random.RandomState(ow)
    img = _image(60, 80, c, seed=oh).astype(np.float32)
    if c == 1:
        img = img[..., 0]
    hom = (np.eye(3) + rng.randn(3, 3) * np.array(
        [[0.05, 0.05, 3], [0.05, 0.05, 3], [1e-4, 1e-4, 0.01]])).astype(
            np.float32)
    got = image_ops.warp_perspective_linear(img, hom, (ow, oh))
    ref = cv2.warpPerspective(img, hom, (ow, oh), flags=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, ref)
