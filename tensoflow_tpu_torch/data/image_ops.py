"""The three cv2 image operations of the JAX package's data layer,
reproduced in numpy (the card's machine has no cv2):

  * ``gaussian_blur``: ``cv2.GaussianBlur(img, (k, k), sigma,
    borderType=BORDER_REFLECT101)`` on uint8 images, which cv2 computes in
    fixed point: the kernel rounded to 8 fractional bits with error
    diffusion, both passes in exact integers, one rounding at the end;
  * ``warp_perspective_linear``: ``cv2.warpPerspective(img, H, size,
    flags=INTER_LINEAR)`` on float32 images (BORDER_CONSTANT 0), in
    float32 source coordinates as cv2 4.11 and later compute them (earlier
    releases rounded them to 1/32 pixel);
  * ``resize_area``: ``cv2.resize(img, (tw, th), interpolation=INTER_AREA)``
    for a down-scale of a uint8 image.

Used by data/colmap_db.py for the ``_crop_dir`` and ``_resize_dir``
caches.  Each gives cv2's result bit for bit on the tests' inputs
(tests/test_torch_image_io.py; tests/test_torch_databases.py states the
share of cache pixels that differ from the JAX package's, 0 there).
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# GaussianBlur
# ---------------------------------------------------------------------------

def _gaussian_kernel_fixed(ksize: int, sigma: float) -> np.ndarray:
    """cv2's bit-exact Gaussian kernel in fixed point (8 fractional bits):
    the float kernel normalised to 1, rounded from the outside in with the
    rounding error carried to the next tap, the centre tap taking what is
    left so that the taps sum to exactly 256."""
    n2 = ksize // 2
    x = 2 * np.arange(n2) - (ksize - 1)                # 1 - n, 3 - n, ...
    t = np.exp((x * x).astype(np.float64) * (-0.125 / (sigma * sigma)))
    mul = 1.0 / (2.0 * t.sum() + 1.0)
    out = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(n2):
        adj = t[i] * mul * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
    out[n2] = 256 - 2 * out[:n2].sum()
    return out


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source index of each of the n + 2 * pad positions
    (BORDER_REFLECT101, reflected as often as needed)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur on a uint8 [H, W] or [H, W, C] image with a square
    odd ``ksize`` and BORDER_REFLECT101."""
    if img.dtype != np.uint8:
        raise ValueError(f'gaussian_blur: dtype {img.dtype} (uint8)')
    if ksize % 2 != 1 or ksize < 1:
        raise ValueError(f'gaussian_blur: ksize {ksize} (odd, positive)')
    if ksize == 1:
        return img.copy()
    k = _gaussian_kernel_fixed(ksize, sigma)
    h, w = img.shape[:2]
    pad = ksize // 2
    x = img.astype(np.int64)
    xs = x[:, _reflect101(w, pad)]
    rows = sum(k[j] * xs[:, j:j + w] for j in range(ksize))     # 8 bits
    ys = rows[_reflect101(h, pad)]
    cols = sum(k[i] * ys[i:i + h] for i in range(ksize))        # 16 bits
    return ((cols + (1 << 15)) >> 16).clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# warpPerspective, INTER_LINEAR
# ---------------------------------------------------------------------------

def _invert3x3(m: np.ndarray) -> np.ndarray:
    """cv2.invert of a 3x3 double matrix (DECOMP_LU): the closed form of
    the adjugate over the determinant, in cv2's order of operations."""
    s = np.asarray(m, np.float64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if d == 0:
        raise ValueError('warp_perspective_linear: singular homography')
    d = 1.0 / d
    return np.asarray([
        [(s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
         (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
         (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d],
        [(s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
         (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
         (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d],
        [(s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
         (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
         (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d]])


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


WARP_LANES = 16     # output columns per step of cv2's vector loop (AVX2)


def warp_perspective_linear(img: np.ndarray, hom: np.ndarray,
                            size) -> np.ndarray:
    """cv2.warpPerspective(img, hom, size, flags=INTER_LINEAR) on a float32
    [H, W] or [H, W, C] image; ``size`` = (width, height).

    As cv2 (4.11 and later) computes it: the inverse of ``hom`` in double,
    rounded to float32; each output pixel's source position in float32
    (the vector loop: fma(m0, x, y m1 + m2); the last columns, which the
    scalar loop takes: fma(x, m0, y m1) + m2), divided by the projective
    term; the four taps weighted by the fractions with two fused lerps
    along x and one along y; taps outside the image read 0."""
    src = np.asarray(img, np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    sh, sw, _ = src.shape
    ow, oh = int(size[0]), int(size[1])
    m = _invert3x3(hom).reshape(-1).astype(np.float32)
    x = np.broadcast_to(np.arange(ow, dtype=np.float32)[None], (oh, ow))
    y = np.broadcast_to(np.arange(oh, dtype=np.float32)[:, None], (oh, ow))
    tail = WARP_LANES * (ow // WARP_LANES)

    def coord(i):
        ym = (y * m[i + 1]).astype(np.float32)
        vec = _fma(m[i], x, (ym + m[i + 2]).astype(np.float32))
        scalar = (_fma(x, m[i], ym) + m[i + 2]).astype(np.float32)
        return np.where(x < tail, vec, scalar)

    wv = coord(6)
    sx = (coord(0) / wv).astype(np.float32)
    sy = (coord(3) / wv).astype(np.float32)
    fx, fy = np.floor(sx), np.floor(sy)
    ax = (sx - fx)[..., None]
    ay = (sy - fy)[..., None]
    ix = np.clip(fx, -2, sw + 1).astype(np.int64)
    iy = np.clip(fy, -2, sh + 1).astype(np.int64)

    def tap(dx, dy):
        xx, yy = ix + dx, iy + dy
        inside = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
        v = src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        return np.where(inside[..., None], v, np.float32(0))

    f00, f01, f10, f11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    top = _fma(ax, f01 - f00, f00)
    bot = _fma(ax, f11 - f10, f10)
    out = _fma(ay, bot - top, top)
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# resize, INTER_AREA
# ---------------------------------------------------------------------------

def _area_weights(n_src: int, n_dst: int, scale: float):
    """cv2's INTER_AREA table along one axis for a down-scale by ``scale``
    (source pixels per output pixel): (dst, src, weight) triples."""
    dst, src, wts = [], [], []
    for d in range(n_dst):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cellw = min(scale, n_src - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = int(np.floor(fsx2))
        sx2 = min(sx2, n_src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            dst.append(d), src.append(sx1 - 1)
            wts.append((sx1 - fsx1) / cellw)
        for s in range(sx1, sx2):
            dst.append(d), src.append(s), wts.append(1.0 / cellw)
        if fsx2 - sx2 > 1e-3:
            dst.append(d), src.append(sx2)
            wts.append(min(min(fsx2 - sx2, 1.0), cellw) / cellw)
    return (np.asarray(dst), np.asarray(src),
            np.asarray(wts, np.float64).astype(np.float32))


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size, interpolation=INTER_AREA) for a uint8 [H, W]
    or [H, W, C] image and a down-scale; ``size`` = (width, height).  An
    integer factor in both axes averages its blocks (a factor of 2 as
    (sum + 2) >> 2, as cv2's fast path does; others rounded to nearest);
    otherwise each output pixel is the area-weighted mean of the source
    pixels it covers, in float32, rounded to nearest."""
    if img.dtype != np.uint8:
        raise ValueError(f'resize_area: dtype {img.dtype} (uint8)')
    h, w = img.shape[:2]
    tw, th = int(size[0]), int(size[1])
    if tw > w or th > h:
        raise ValueError(f'resize_area: {w}x{h} -> {tw}x{th} is not a '
                         'down-scale')
    sx, sy = 1.0 / (tw / w), 1.0 / (th / h)       # cv2: 1 / inv_scale
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps \
            and abs(sy - iy) < np.finfo(np.float64).eps:
        x = img[:th * iy, :tw * ix].astype(np.int64)
        blocks = x.reshape(th, iy, tw, ix, *img.shape[2:]).sum((1, 3))
        area = ix * iy
        if ix == 2 and iy == 2:
            return ((blocks + 2) >> 2).astype(np.uint8)
        out = blocks.astype(np.float32) * (np.float32(1) / np.float32(area))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    xd, xsrc, xw = _area_weights(w, tw, sx)
    yd, ysrc, yw = _area_weights(h, th, sy)
    x = img.astype(np.float32)
    rows = np.zeros((h, tw) + img.shape[2:], np.float32)
    for d, s, wt in zip(xd, xsrc, xw):
        rows[:, d] += x[:, s] * wt
    out = np.zeros((th, tw) + img.shape[2:], np.float32)
    for d, s, wt in zip(yd, ysrc, yw):
        out[d] += rows[s] * wt
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
