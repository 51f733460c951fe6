"""Image files of the port's data layer, read and written without imageio,
cv2 or PIL (the card's machine has none of them).

  * ``imread(path)``: a PNG decoded to exactly the array that
    ``imageio.v2.imread`` (Pillow underneath) gives, which is what the JAX
    package's ``data/database.imread`` returns:

      colour type / bit depth     array
      gray 1                      bool [H, W]
      gray 2, 4                   uint8 [H, W], scaled by 0x55 / 0x11
      gray 8 / 16                 uint8 / uint16 [H, W]
      gray+alpha 8                uint8 [H, W, 2]
      gray+alpha 16               uint8 [H, W, 4] (gray, gray, gray, alpha),
                                  the high bytes
      RGB, RGBA 8                 uint8 [H, W, 3 / 4]
      RGB, RGBA 16                uint8 [H, W, 3 / 4], the high bytes
      palette 1, 2, 4, 8          uint8 [H, W, 3], the palette's colours

    A ``tRNS`` chunk is ignored, as Pillow's decode through imageio ignores
    it.  Interlaced PNGs raise ``NotImplementedError``.
  * ``imread(path)`` for a baseline JPEG: libjpeg's samples (see
    ``read_jpeg``); progressive and other JPEG processes raise
    ``NotImplementedError``.
  * ``imwrite_png(path, arr)``: 8- or 16-bit gray, gray+alpha, RGB, RGBA,
    each row under the filter with the least sum of absolute residuals
    (libpng's heuristic).
  * ``read_exr(path)``: a scanline OpenEXR file (compression NONE, RLE,
    ZIPS or ZIP; HALF or FLOAT channels) as float32 [H, W, C] over its
    data window, the channels in the order R, G, B, A, which is what
    ``cv2.imread(..., IMREAD_UNCHANGED)`` followed by ``BGRA2RGBA`` gives.
  * ``read_hdr(path)``: a Radiance RGBE file (``-Y H +X W``, run-length
    encoded or flat scanlines) as float32 RGB [H, W, 3], each channel
    m * 2^(e - 136) (0 where e is 0), which is what
    ``cv2.imread(..., IMREAD_UNCHANGED)[..., ::-1]`` gives.
  * ``read_env_map(path)``: an environment image by its magic bytes (PNG /
    JPEG, OpenEXR, Radiance) as float32 RGB(A).

The PNG filters Average and Paeth depend on the byte to the left in the
same row, and JPEG's Huffman decoding is sequential: both are host C++
(csrc/png_filters.cpp, csrc/jpeg.cpp, built with g++ into
build/kernels/ at first use, bound with ctypes).  A failed build raises.
``unfilter_plain`` is the numpy version the defilter is tested against.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from ..ops import cuda_build

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
JPEG_SIGNATURE = b'\xff\xd8\xff'
EXR_MAGIC = 20000630
RADIANCE_SIGNATURES = (b'#?RADIANCE', b'#?RGBE')
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}        # PNG colour type -> samples
_LIBS = {}
_ARGTYPES = {         # csrc/<name>.cpp: [(function, argtypes)]
    'png_filters': [('png_unfilter', [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p])],
    'jpeg': [('jpeg_decode_scan', [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32] + [
            ctypes.c_void_p] * 7 + [ctypes.c_int32] * 3 + [
            ctypes.c_void_p] * 2),
        ('jpeg_encode_scan', [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64] + [ctypes.c_void_p] * 5
         + [ctypes.c_int64])],
}


def _lib(name: str):
    """The host library of csrc/<name>.cpp, built at first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(cuda_build.build_host(
            os.path.join(cuda_build.CSRC, name + '.cpp')))
        for fn, args in _ARGTYPES[name]:
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = args
        _LIBS[name] = lib
    return _LIBS[name]


# ---------------------------------------------------------------------------
# PNG filters
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int
                   ) -> np.ndarray:
    """numpy reference of the defilter: ``raw`` holds h rows of
    (1 + stride) bytes, the filter type first; returns [h, stride] uint8.
    Sub and Up are vectorised; Average and Paeth walk the row one pixel
    at a time."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ft, x = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ft == 0:
            cur = x
        elif ft == 1:
            cur = (np.cumsum(x.reshape(-1, bpp), 0) & 255).reshape(-1)
        elif ft == 2:
            cur = (x + prior) & 255
        elif ft in (3, 4):
            cur = np.zeros(stride, np.int64)
            zero = np.zeros(bpp, np.int64)
            for i in range(0, stride, bpp):
                a = cur[i - bpp:i] if i >= bpp else zero
                b = prior[i:i + bpp]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[i - bpp:i] if i >= bpp else zero
                    pred = _paeth(a, b, c)
                cur[i:i + bpp] = (x[i:i + bpp] + pred) & 255
        else:
            raise ValueError(f'PNG row {y}: filter type {ft} is not 0-4')
        out[y] = cur
        prior = cur
    return out


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The defilter in host C++; the same bytes as ``unfilter_plain``."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f'PNG data holds {raw.size} bytes, the header '
                         f'needs {h * (stride + 1)}')
    out = np.empty((h, stride), np.uint8)
    bad = _lib('png_filters').png_unfilter(raw.ctypes.data, h, stride, bpp,
                                           out.ctypes.data)
    if bad:
        raise ValueError(f'PNG row {bad - 1}: filter type '
                         f'{int(raw[(bad - 1) * (stride + 1)])} is not 0-4')
    return out


def _filter_rows(img: np.ndarray, bpp: int) -> np.ndarray:
    """The five filters of every row of ``img`` [h, stride] uint8, and per
    row the one with the least sum of absolute residuals (as signed
    bytes); returns h rows of (1 + stride) bytes."""
    x = img.astype(np.int16)
    h, stride = x.shape
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    best = np.zeros((h, stride + 1), np.uint8)
    best_cost = np.full(h, np.iinfo(np.int64).max)
    for ft, pred in enumerate((0, a, b, (a + b) >> 1, _paeth(a, b, c))):
        res = (x - pred).astype(np.uint8)
        cost = np.abs(res.view(np.int8).astype(np.int16)).sum(-1,
                                                              dtype=np.int64)
        win = cost < best_cost
        best[win, 0] = ft
        best[win, 1:] = res[win]
        best_cost = np.where(win, cost, best_cost)
    return best


# ---------------------------------------------------------------------------
# PNG read / write
# ---------------------------------------------------------------------------

def _png_chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f'{path}: truncated {kind!r} chunk')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + n
    raise ValueError(f'{path}: no IEND chunk')


def _unpack_bits(idx: np.ndarray, bits: int, w: int) -> np.ndarray:
    """[h, stride] bytes of packed `bits`-bit samples -> [h, w] values."""
    if bits == 8:
        return idx[:, :w]
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (idx[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(idx.shape[0], idx.shape[1] * per)[:, :w]


class _Png:
    """A decoded PNG: the defiltered rows [h, stride] and its header,
    palette and gamma (gAMA, or 45455 for an sRGB chunk; None without)."""

    def __init__(self, path: str):
        with open(path, 'rb') as f:
            data = f.read()
        if not data.startswith(PNG_SIGNATURE):
            raise ValueError(f'{path}: not a PNG file')
        header, self.palette, self.gamma, idat = None, None, None, []
        for kind, body in _png_chunks(data, path):
            if kind == b'IHDR':
                header = struct.unpack('>IIBBBBB', body)
            elif kind == b'PLTE':
                self.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b'IDAT':
                idat.append(body)
            elif self.palette is not None or idat:
                pass       # libpng ignores a gAMA / sRGB after PLTE or IDAT
            elif kind == b'gAMA' and self.gamma is None:
                (self.gamma,) = struct.unpack('>I', body)
            elif kind == b'sRGB':
                self.gamma = 45455
        if header is None:
            raise ValueError(f'{path}: no IHDR chunk')
        self.w, self.h, self.bits, self.ctype, _, _, interlace = header
        if interlace:
            raise NotImplementedError(
                f'{path}: interlaced (Adam7) PNG is not supported')
        if self.ctype not in _CHANNELS:
            raise ValueError(f'{path}: PNG colour type {self.ctype}')
        if self.ctype == 3 and self.palette is None:
            raise ValueError(f'{path}: palette PNG without PLTE')
        self.ch = _CHANNELS[self.ctype]
        stride = (self.w * self.ch * self.bits + 7) // 8
        bpp = max(1, self.ch * self.bits // 8)
        raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
        self.rows = unfilter(raw, self.h, stride, bpp)

    def samples(self) -> np.ndarray:
        """[h, w, ch] samples at the file's depth (uint8 or uint16;
        1, 2, 4 bits unpacked, unscaled)."""
        if self.bits == 16:
            return self.rows.view('>u2').reshape(self.h, self.w, self.ch
                                                 ).astype(np.uint16)
        if self.bits < 8:
            return _unpack_bits(self.rows, self.bits, self.w)[..., None]
        return self.rows.reshape(self.h, self.w, self.ch)

    def palette_rgb(self) -> np.ndarray:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(self.palette)] = self.palette
        return lut[self.samples()[..., 0]]


def read_png(path: str) -> np.ndarray:
    png = _Png(path)
    if png.ctype == 3:
        return png.palette_rgb()
    v = png.samples()
    if png.bits == 16:
        if png.ctype == 0:
            return v[..., 0]
        hi = (v >> 8).astype(np.uint8)
        if png.ctype == 4:
            return hi[..., [0, 0, 0, 1]]
        return hi
    if png.bits < 8:                               # gray 1, 2, 4
        if png.bits == 1:
            return v[..., 0].astype(bool)
        return (v[..., 0] * (255 // ((1 << png.bits) - 1))).astype(np.uint8)
    return v[..., 0].copy() if png.ch == 1 else v.copy()


def _gamma_table(gamma: int) -> np.ndarray:
    """libpng's 8-bit gamma table: floor(255 (i/255)^(gamma/1e5) + 0.5)."""
    i = np.arange(256, dtype=np.float64)
    t = np.floor(255 * (i / 255) ** (gamma * 1e-5) + 0.5).astype(np.int64)
    t[[0, 255]] = [0, 255]
    return t


def imread_cv2(path: str, grey: bool = False) -> np.ndarray:
    """A PNG as ``cv2.imread(path)[..., ::-1]`` gives it (uint8 RGB
    [H, W, 3]: alpha dropped without compositing, grey replicated, 16-bit
    samples reduced to their high byte, palettes expanded, 1 / 2 / 4-bit
    grey scaled to 0-255), or with ``grey`` as ``cv2.imread(path, 0)``
    (uint8 [H, W]): colour through libpng's rgb_to_gray with cv2's
    coefficients 0.299 / 0.587 (fixed point 9797 / 19234 / 3737 over
    2^15; 8-bit sums truncated, 16-bit ones rounded, then the high byte),
    in linear light when the file's gamma (gAMA, sRGB) is significant."""
    png = _Png(path)
    if png.ctype == 3:
        v, bits = png.palette_rgb(), 8
    else:
        v, bits = png.samples().astype(np.int64), png.bits
        if bits < 8:
            v = v * (255 // ((1 << bits) - 1))
    if png.ctype in (0, 4):                          # grey (+ alpha)
        g = v[..., 0] >> 8 if bits == 16 else v[..., 0]
        g = g.astype(np.uint8)
        return g if grey else np.repeat(g[..., None], 3, -1)
    rgb = v[..., :3].astype(np.int64)
    if not grey:
        return (rgb >> 8 if bits == 16 else rgb).astype(np.uint8)
    coef = np.array([9797, 19234, 3737], np.int64)
    if png.gamma is not None and not 95000 <= png.gamma <= 105000:
        if bits == 16:
            raise NotImplementedError(
                f'{path}: grey of a 16-bit colour PNG with gamma '
                f'{png.gamma / 1e5}')
        # libpng's reciprocals: to linear with 1/gamma, back with the
        # reciprocal of its screen gamma, itself 1/gamma
        screen = int(np.floor(1e10 / png.gamma + 0.5))
        to_1 = _gamma_table(screen)
        from_1 = _gamma_table(int(np.floor(1e10 / screen + 0.5)))
        g = from_1[(to_1[rgb] @ coef + 16384) >> 15]
        flat = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
        return np.where(flat, rgb[..., 0], g).astype(np.uint8)
    if bits == 16:
        return (((rgb @ coef + 16384) >> 15) >> 8).astype(np.uint8)
    return ((rgb @ coef) >> 15).astype(np.uint8)


def imread(path: str) -> np.ndarray:
    """A PNG or a baseline JPEG as ``imageio.v2.imread`` gives it (module
    docstring); any other format raises ValueError."""
    with open(path, 'rb') as f:
        head = f.read(8)
    if head.startswith(PNG_SIGNATURE):
        return read_png(path)
    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(path)
    raise ValueError(f'{path}: neither PNG nor JPEG')


# ---------------------------------------------------------------------------
# JPEG (baseline and extended sequential, Huffman, 8-bit)
# ---------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_JPEG_UNSUPPORTED = {0xC2: 'progressive', 0xC3: 'lossless',
                     0xC5: 'hierarchical', 0xC6: 'hierarchical progressive',
                     0xC7: 'hierarchical lossless', 0xC9: 'arithmetic',
                     0xCA: 'arithmetic progressive',
                     0xCB: 'arithmetic lossless', 0xCD: 'arithmetic',
                     0xCE: 'arithmetic', 0xCF: 'arithmetic'}


def _jpeg_segments(data: bytes, path: str):
    """(marker, body) of every segment; an SOS body runs on to the end of
    its entropy-coded data (RST markers included)."""
    if not data.startswith(b'\xff\xd8'):
        raise ValueError(f'{path}: not a JPEG file')
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f'{path}: no marker at byte {pos}')
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        (n,) = struct.unpack('>H', data[pos:pos + 2])
        body = data[pos + 2:pos + n]
        pos += n
        if m == 0xDA:
            end = pos
            while True:
                end = data.find(b'\xff', end)
                if end < 0 or end + 1 >= len(data):
                    end = len(data)
                    break
                if data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                    end += 2
                    continue
                break
            yield m, (body, data[pos:end])
            pos = end
            continue
        yield m, body
    raise ValueError(f'{path}: no EOI marker')


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg's upsampling of a component plane by (fh, fv), with its
    default fancy (triangle) filters for 2x1, 1x2 and 2x2 on planes wider
    than two samples; other factors replicate samples."""
    x = plane.astype(np.int32)
    h, w = x.shape
    if (fh, fv) == (1, 1):
        return plane
    if fv == 2 and fh in (1, 2) and (fh == 1 or w > 2):
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        if fh == 1:
            out = np.empty((2 * h, w), np.int32)
            out[0::2] = (3 * x + up + 1) >> 2
            out[1::2] = (3 * x + down + 2) >> 2
            return out.astype(np.uint8)
        out = np.empty((2 * h, 2 * w), np.int32)
        for row, nb in ((0, up), (1, down)):
            col = 3 * x + nb
            left = np.concatenate([col[:, :1], col[:, :-1]], 1)
            right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
            out[row::2, 0::2] = (3 * col + left + 8) >> 4
            out[row::2, 1::2] = (3 * col + right + 7) >> 4
        return out.astype(np.uint8)
    if (fh, fv) == (2, 1) and w > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, 0), fh, 1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)                      # noqa: E731
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline (or extended sequential, Huffman, 8-bit) JPEG as
    ``imageio.v2.imread`` gives it through Pillow's libjpeg: uint8 [H, W]
    for one component, [H, W, 3] RGB for three (YCbCr converted; Adobe
    transform 0 and 'R', 'G', 'B' component ids taken as RGB).  The
    samples are libjpeg's: the accurate integer IDCT (host C++,
    csrc/jpeg.cpp), its fancy upsampling and fixed-point colour
    conversion.  Progressive, lossless, arithmetic-coded, 12-bit and
    four-component JPEGs raise NotImplementedError."""
    with open(path, 'rb') as f:
        data = f.read()
    qt = np.zeros((4, 64), np.uint16)
    bits = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    frame, planes, restart = None, None, 0
    jfif, adobe = False, None
    for m, body in _jpeg_segments(data, path):
        if m in _JPEG_UNSUPPORTED:
            raise NotImplementedError(
                f'{path}: {_JPEG_UNSUPPORTED[m]} JPEG is not supported '
                '(baseline and extended sequential Huffman are)')
        if m == 0xE0 and body.startswith(b'JFIF\0'):
            jfif = True
        elif m == 0xEE and body.startswith(b'Adobe') and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                q = np.frombuffer(body[i + 1:i + 1 + n],
                                  '>u2' if pq else np.uint8)
                qt[tq, _ZIGZAG] = q
                i += 1 + n
        elif m == 0xC4:
            i = 0
            while i < len(body):
                slot = (4 if body[i] >> 4 else 0) + (body[i] & 15)
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                n = int(counts.sum())
                bits[slot, 1:] = counts
                vals[slot] = 0
                vals[slot, :n] = np.frombuffer(body[i + 17:i + 17 + n],
                                               np.uint8)
                i += 17 + n
        elif m == 0xDD:
            (restart,) = struct.unpack('>H', body[:2])
        elif m in (0xC0, 0xC1):
            prec, hgt, wid, nf = struct.unpack('>BHHB', body[:6])
            if prec != 8:
                raise NotImplementedError(f'{path}: {prec}-bit JPEG')
            if hgt == 0:
                raise NotImplementedError(f'{path}: JPEG height in a DNL '
                                          'marker')
            if nf not in (1, 3):
                raise NotImplementedError(f'{path}: {nf}-component JPEG '
                                          '(gray and three are read)')
            comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4,
                      body[7 + 3 * k] & 15, body[8 + 3 * k])
                     for k in range(nf)]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
            frame = (hgt, wid, comps, hmax, vmax, mcux, mcuy)
            planes = [np.zeros((mcuy * c[2] * 8, mcux * c[1] * 8), np.uint8)
                      for c in comps]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f'{path}: scan before the frame header')
            header, coded = body
            ns = header[0]
            ids = [c[0] for c in frame[2]]
            idx = [ids.index(header[1 + 2 * k]) for k in range(ns)]
            sel = [header[2 + 2 * k] for k in range(ns)]
            hgt, wid, comps, hmax, vmax, mcux, mcuy = frame
            if ns == 1:                      # non-interleaved: one block
                c = comps[idx[0]]
                hs, vs = [1], [1]
                nx = -(-(-(-wid * c[1] // hmax)) // 8)
                ny = -(-(-(-hgt * c[2] // vmax)) // 8)
            else:
                hs, vs = [comps[k][1] for k in idx], [comps[k][2] for k in idx]
                nx, ny = mcux, mcuy
            q = np.ascontiguousarray(qt[[comps[k][3] for k in idx]])
            chosen = [planes[k] for k in idx]
            ptrs = (ctypes.c_void_p * ns)(*[p.ctypes.data for p in chosen])
            strides = np.array([p.shape[1] for p in chosen], np.int64)
            arr = lambda v, t=np.int32: np.ascontiguousarray(v, t)  # noqa
            hs_, vs_ = arr(hs), arr(vs)
            dc, ac = arr([t >> 4 for t in sel]), arr([t & 15 for t in sel])
            buf = np.frombuffer(coded, np.uint8)
            err = _lib('jpeg').jpeg_decode_scan(
                buf.ctypes.data, len(coded), ns, hs_.ctypes.data,
                vs_.ctypes.data, dc.ctypes.data, ac.ctypes.data,
                q.ctypes.data, bits.ctypes.data, vals.ctypes.data,
                nx, ny, restart, ctypes.cast(ptrs, ctypes.c_void_p),
                strides.ctypes.data)
            if err:
                raise ValueError(f'{path}: corrupt JPEG scan ({err})')
    if frame is None:
        raise ValueError(f'{path}: no JPEG frame header')
    hgt, wid, comps, hmax, vmax, _, _ = frame
    out = []
    for (cid, h, v, _), plane in zip(comps, planes):
        cw, ch = -(-wid * h // hmax), -(-hgt * v // vmax)
        up = _upsample(plane[:ch, :cw], hmax // h, vmax // v)
        out.append(up[:hgt, :wid])
    if len(out) == 1:
        return out[0].copy()
    rgb = ((not jfif and adobe == 0) or (not jfif and adobe is None and [
        c[0] for c in comps] == [82, 71, 66]))
    if rgb:
        return np.stack(out, -1)
    return _ycc_to_rgb(*out)


# libjpeg's defaults for writing (Annex K tables; jcparam.c)
_STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
              99, 24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38))
_STD_HUFF = (   # (bits[1..16], values): DC luma, AC luma, DC chroma, AC chroma
    ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        '01020300041105122131410613516107227114328191a1082342b1c11552d1f0'
        '2433627282090a161718191a25262728292a3435363738393a43444546474849'
        '4a535455565758595a636465666768696a737475767778797a83848586878889'
        '8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
        'c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8'
        'f9fa')),
    ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        '000102031104052131061241510761711322328108144291a1b1c109233352f0'
        '156272d10a162434e125f11718191a262728292a35363738393a434445464748'
        '494a535455565758595a636465666768696a737475767778797a828384858687'
        '88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3'
        'c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8'
        'f9fa')))


def _quant_tables(quality: int) -> np.ndarray:
    """jpeg_set_quality(quality, force_baseline=TRUE): the two standard
    tables scaled, natural order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.stack([np.clip((t * scale + 50) // 100, 1, 255)
                     for t in _STD_QUANT]).astype(np.int64)


def _fdct_islow(x: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer forward DCT (jfdctint.c) of blocks
    [n, 8, 8] of level-shifted samples; the result is scaled by 8."""
    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    def pass_(d, last):
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = np.empty_like(d)
        if last:
            out[..., 0] = descale(t10 + t11, 2)
            out[..., 4] = descale(t10 - t11, 2)
        else:
            out[..., 0] = (t10 + t11) << 2
            out[..., 4] = (t10 - t11) << 2
        sh = 15 if last else 11
        z1 = (t12 + t13) * 4433
        out[..., 2] = descale(z1 + t13 * 6270, sh)
        out[..., 6] = descale(z1 - t12 * 15137, sh)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[..., 7] = descale(t4 + z1 + z3, sh)
        out[..., 5] = descale(t5 + z2 + z4, sh)
        out[..., 3] = descale(t6 + z2 + z3, sh)
        out[..., 1] = descale(t7 + z1 + z4, sh)
        return out
    rows = pass_(x.astype(np.int64), False)
    return pass_(rows.swapaxes(-1, -2), True).swapaxes(-1, -2)


def _blocks(plane: np.ndarray, by: int, bx: int) -> np.ndarray:
    """[by*8, bx*8] -> [by, bx, 8, 8] blocks."""
    return plane.reshape(by, 8, bx, 8).swapaxes(1, 2)


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode='edge')


def imwrite_jpeg(path: str, arr: np.ndarray, quality: int = 95):
    """Write a uint8 gray [H, W] or RGB [H, W, 3] image as a baseline JPEG
    with the coefficients libjpeg computes under its defaults, which are
    what ``cv2.imwrite`` uses (``quality`` 95 unless given): JFIF, the
    fixed-point RGB -> YCbCr of jccolor.c, 4:2:0 chroma downsampled as
    jcsample.c does (alternating rounding bias), edges replicated, the
    accurate integer forward DCT, the standard Huffman tables."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (
            arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(f'imwrite_jpeg: {arr.dtype} {arr.shape} (uint8 '
                         'gray or RGB)')
    h, w = arr.shape[:2]
    qt = _quant_tables(quality)
    if arr.ndim == 2:
        samp, planes = [(1, 1)], [arr.astype(np.int64)]
    else:
        one_half = 1 << 15
        fix = lambda v: int(v * 65536 + 0.5)                  # noqa: E731
        r, g, b = (arr[..., k].astype(np.int64) for k in range(3))
        cbcr = (128 << 16) + one_half - 1
        planes = [
            (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b
             + one_half) >> 16,
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
             + cbcr) >> 16,
            (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
             + cbcr) >> 16]
        samp = [(2, 2), (1, 1), (1, 1)]
    hmax, vmax = samp[0]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks, comp = [], []
    for ci, ((hs, vs), p) in enumerate(zip(samp, planes)):
        if (hs, vs) == (hmax, vmax):
            full = _pad_edge(p, mcuy * vs * 8, mcux * hs * 8)
        else:                    # 2x2 downsampling of the padded planes
            src = _pad_edge(p, -(-h // 2) * 2, mcux * 16)
            s = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
                 + src[1::2, 1::2])
            bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
            full = _pad_edge((s + bias) >> 2, mcuy * 8, mcux * 8)
        coef = _fdct_islow(_blocks(full - 128, mcuy * vs, mcux * hs))
        d = (qt[min(ci, 1)] << 3).reshape(8, 8)
        q = (np.sign(coef) * ((np.abs(coef) + (d >> 1)) // d)).reshape(
            mcuy * vs, mcux * hs, 64)
        # MCU order: [mcuy, mcux, vs, hs] blocks
        q = q.reshape(mcuy, vs, mcux, hs, 64).swapaxes(1, 2).copy()
        # the blocks of the last MCU column / row past the component's
        # own blocks are dummies: no AC, the DC of the block before them
        bw = -(-(-(-w * hs // hmax)) // 8)
        bh = -(-(-(-h * vs // vmax)) // 8)
        for hh in range(1, hs):
            if (mcux - 1) * hs + hh >= bw:
                q[:, -1, :, hh] = 0
                q[:, -1, :, hh, 0] = q[:, -1, :, hh - 1, 0]
        for vv in range(1, vs):
            if (mcuy - 1) * vs + vv >= bh:
                q[-1, :, vv] = 0
                q[-1, :, vv, :, 0] = q[-1, :, vv - 1, -1:, 0]
        blocks.append(q.reshape(mcuy, mcux, vs * hs, 64))
        comp.append(np.full((mcuy, mcux, vs * hs), ci, np.int32))
    blocks = np.ascontiguousarray(np.concatenate(blocks, 2).reshape(-1, 64),
                                  np.int16)
    comp = np.ascontiguousarray(np.concatenate(comp, 2).reshape(-1))
    codes = np.zeros((4, 256), np.uint16)
    sizes = np.zeros((4, 256), np.uint8)
    for slot, (counts, vals) in enumerate(_STD_HUFF):
        code, k = 0, 0
        for length, n in enumerate(counts, 1):
            for v in vals[k:k + n]:
                codes[slot, v], sizes[slot, v] = code, length
                code += 1
            k += n
            code <<= 1
    nc = len(planes)
    dc_slot = np.array([0, 2, 2][:nc], np.int32)
    ac_slot = np.array([1, 3, 3][:nc], np.int32)
    cap = blocks.size * 8 + 1024
    out = np.empty(cap, np.uint8)
    n = _lib('jpeg').jpeg_encode_scan(
        blocks.ctypes.data, comp.ctypes.data, len(blocks),
        dc_slot.ctypes.data, ac_slot.ctypes.data, codes.ctypes.data,
        sizes.ctypes.data, out.ctypes.data, cap)
    if n < 0:
        raise ValueError('imwrite_jpeg: scan buffer overflow')

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack('>H', len(body) + 2) + body
    head = [b'\xff\xd8', seg(0xE0, b'JFIF\0\x01\x01\0\0\x01\0\x01\0\0')]
    for t in range(min(nc, 2)):
        head.append(seg(0xDB, bytes([t]) + bytes(
            qt[t][_ZIGZAG].astype(np.uint8))))
    head.append(seg(0xC0, struct.pack('>BHHB', 8, h, w, nc) + b''.join(
        bytes([ci + 1, (hs << 4) | vs, min(ci, 1)])
        for ci, (hs, vs) in enumerate(samp))))
    for slot, (counts, vals) in enumerate(_STD_HUFF[:2 * min(nc, 2)]):
        head.append(seg(0xC4, bytes([(slot % 2) << 4 | slot // 2])
                        + bytes(counts) + vals))
    head.append(seg(0xDA, bytes([nc]) + b''.join(
        bytes([ci + 1, 0x11 * min(ci, 1)]) for ci in range(nc))
        + b'\x00\x3f\x00'))
    with open(path, 'wb') as f:
        f.write(b''.join(head) + out[:n].tobytes() + b'\xff\xd9')


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def imwrite_png(path: str, arr: np.ndarray, level: int = 6):
    """Write uint8 or uint16 gray [H, W] (or [H, W, 1]), gray+alpha
    [H, W, 2], RGB [H, W, 3] or RGBA [H, W, 4] as a PNG."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f'imwrite_png: dtype {arr.dtype} (uint8 / uint16)')
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f'imwrite_png: shape {arr.shape}')
    h, w, ch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    bits = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(f'>u{arr.dtype.itemsize}')
                                ).view(np.uint8).reshape(h, w * ch
                                                         * arr.dtype.itemsize)
    body = _filter_rows(rows, ch * arr.dtype.itemsize)
    with open(path, 'wb') as f:
        f.write(PNG_SIGNATURE
                + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, bits,
                                                  ctype, 0, 0, 0))
                + _png_chunk(b'IDAT', zlib.compress(body.tobytes(), level))
                + _png_chunk(b'IEND', b''))


# ---------------------------------------------------------------------------
# OpenEXR (scanline)
# ---------------------------------------------------------------------------

_EXR_COMPRESSION = {0: ('NONE', 1), 1: ('RLE', 1), 2: ('ZIPS', 1),
                    3: ('ZIP', 16), 4: ('PIZ', 32), 5: ('PXR24', 16),
                    6: ('B44', 32), 7: ('B44A', 32), 8: ('DWAA', 32),
                    9: ('DWAB', 256)}
_EXR_TYPES = {1: np.dtype('<f2'), 2: np.dtype('<f4')}   # HALF, FLOAT
_EXR_ORDER = ('R', 'G', 'B', 'A')


def _cstr(data: bytes, pos: int):
    end = data.index(b'\0', pos)
    return data[pos:end].decode('latin-1'), end + 1


def _exr_header(data: bytes, path: str):
    magic, version = struct.unpack('<ii', data[:8])
    if magic != EXR_MAGIC:
        raise ValueError(f'{path}: not an OpenEXR file')
    if version & 0x200:
        raise NotImplementedError(f'{path}: tiled OpenEXR is not supported')
    if version & 0x1800:
        raise NotImplementedError(
            f'{path}: multi-part or deep OpenEXR is not supported')
    attrs, pos = {}, 8
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        kind, pos = _cstr(data, pos)
        (size,) = struct.unpack('<i', data[pos:pos + 4])
        attrs[name] = (kind, data[pos + 4:pos + 4 + size])
        pos += 4 + size
    return attrs, pos + 1


def _exr_channels(body: bytes):
    chans, pos = [], 0
    while body[pos] != 0:
        name, pos = _cstr(body, pos)
        ptype, _, xs, ys = struct.unpack('<iB3xii', body[pos:pos + 16])
        chans.append((name, ptype, xs, ys))
        pos += 16
    return chans


def _rle_decode(src: bytes, n: int) -> np.ndarray:
    out = bytearray()
    i = 0
    while i < len(src):
        c = struct.unpack('b', src[i:i + 1])[0]
        if c < 0:
            out += src[i + 1:i + 1 - c]
            i += 1 - c
        else:
            out += src[i + 1:i + 2] * (c + 1)
            i += 2
    if len(out) != n:
        raise ValueError(f'RLE block decodes to {len(out)} bytes, not {n}')
    return np.frombuffer(bytes(out), np.uint8)


def _exr_unpredict(t: np.ndarray) -> np.ndarray:
    """OpenEXR's byte predictor (t[i] = t[i-1] + d[i] - 128) and the
    interleave of the two halves, as RLE and ZIP undo them."""
    d = t.astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) & 255).astype(np.uint8)
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def read_exr(path: str) -> np.ndarray:
    """A scanline OpenEXR file as float32 [H, W, C] (module docstring)."""
    with open(path, 'rb') as f:
        data = f.read()
    attrs, pos = _exr_header(data, path)
    comp = attrs['compression'][1][0]
    name, lines = _EXR_COMPRESSION.get(comp, (str(comp), 0))
    if comp not in (0, 1, 2, 3):
        raise NotImplementedError(
            f'{path}: OpenEXR compression {name} is not supported (NONE, '
            'RLE, ZIPS and ZIP are)')
    chans = _exr_channels(attrs['channels'][1])
    for cname, ptype, xs, ys in chans:
        if ptype not in _EXR_TYPES:
            raise NotImplementedError(
                f'{path}: channel {cname} is UINT (HALF and FLOAT are read)')
        if (xs, ys) != (1, 1):
            raise NotImplementedError(f'{path}: channel {cname} is '
                                      f'subsampled {xs}x{ys}')
    extra = [c[0] for c in chans if c[0] not in _EXR_ORDER]
    if extra:
        raise NotImplementedError(f'{path}: channels {extra} (R, G, B and '
                                  'A are read)')
    x0, y0, x1, y1 = struct.unpack('<iiii', attrs['dataWindow'][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    n_chunks = -(-h // lines)
    offsets = np.frombuffer(data, '<u8', n_chunks, pos)
    line_bytes = sum(w * _EXR_TYPES[c[1]].itemsize for c in chans)
    planes = {c[0]: np.zeros((h, w), np.float32) for c in chans}
    for off in offsets:
        y, size = struct.unpack('<ii', data[off:off + 8])
        n_lines = min(lines, y1 - y + 1)
        want = n_lines * line_bytes
        block = data[off + 8:off + 8 + size]
        if size < want and comp == 1:
            buf = _exr_unpredict(_rle_decode(block, want))
        elif size < want:
            buf = _exr_unpredict(np.frombuffer(zlib.decompress(block),
                                               np.uint8))
        else:                       # NONE, or a block stored uncompressed
            buf = np.frombuffer(block, np.uint8)
        if buf.size != want:
            raise ValueError(f'{path}: block at y={y} holds {buf.size} '
                             f'bytes, not {want}')
        p = 0
        for r in range(n_lines):
            for cname, ptype, _, _ in chans:
                dt = _EXR_TYPES[ptype]
                n = w * dt.itemsize
                planes[cname][y - y0 + r] = buf[p:p + n].view(dt)
                p += n
    names = [c for c in _EXR_ORDER if c in planes]
    return np.stack([planes[c] for c in names], -1)


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) and environment maps
# ---------------------------------------------------------------------------

def _rgbe_scanline(data: bytes, pos: int, w: int, path: str):
    """One scanline as uint8 [w, 4] (R, G, B, E) and the position after it:
    run-length encoded (2, 2, w >> 8, w & 255, then each of the four
    components as runs) or flat (4 bytes a pixel)."""
    head = data[pos:pos + 4]
    if not (8 <= w < 32768 and len(head) == 4 and head[0] == 2
            and head[1] == 2 and not head[2] & 0x80):
        row = np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4)
        if ((row[:, :3] == 1).all(-1)).any():
            raise NotImplementedError(
                f'{path}: old-style run-length RGBE is not supported')
        return row, pos + 4 * w
    if (head[2] << 8 | head[3]) != w:
        raise ValueError(f'{path}: scanline width {head[2] << 8 | head[3]}'
                         f', not {w}')
    pos += 4
    row = np.empty((4, w), np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            n = data[pos]
            if n > 128:                            # a run of n - 128
                n -= 128
                row[c, x:x + n] = data[pos + 1]
                pos += 2
            else:                                  # n literal bytes
                row[c, x:x + n] = np.frombuffer(data, np.uint8, n, pos + 1)
                pos += 1 + n
            if n == 0 or x + n > w:
                raise ValueError(f'{path}: bad RGBE run')
            x += n
    return row.T, pos


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE file as float32 RGB [H, W, 3] (module docstring)."""
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(RADIANCE_SIGNATURES):
        raise ValueError(f'{path}: not a Radiance file')
    pos = data.index(b'\n') + 1
    while True:                                    # header lines, then ''
        end = data.index(b'\n', pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b'FORMAT=') and line != b'FORMAT=32-bit_rle_rgbe':
            raise NotImplementedError(f'{path}: {line.decode()}')
    end = data.index(b'\n', pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b'-Y' or res[2] != b'+X':
        raise NotImplementedError(
            f'{path}: orientation {b" ".join(res).decode()} (-Y H +X W '
            'is read)')
    h, w = int(res[1]), int(res[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        rgbe[y], pos = _rgbe_scanline(data, pos, w, path)
    e = rgbe[..., 3:].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0.0)
    return (rgbe[..., :3] * scale).astype(np.float32)


def read_env_map(path: str) -> np.ndarray:
    """An environment image as float32 RGB(A): PNG or JPEG (the values of
    ``imread``, 0-255), OpenEXR (``read_exr``) or Radiance (``read_hdr``),
    told apart by the file's first bytes."""
    with open(path, 'rb') as f:
        head = f.read(16)
    if head.startswith((PNG_SIGNATURE, JPEG_SIGNATURE)):
        return imread(path).astype(np.float32)
    if head[:4] == struct.pack('<i', EXR_MAGIC):
        return read_exr(path)
    if head.startswith(RADIANCE_SIGNATURES):
        return read_hdr(path)
    raise ValueError(f'{path}: neither PNG, JPEG, OpenEXR nor Radiance')
