"""Direction samplers for the Monte-Carlo shader and the flow priors
(counterpart of tensoflow_tpu/ops/samplers.py).

The lattices are built on the host with numpy and reach the device once,
through ``device_constant``.  The train-time azimuth roll is an argument
(``roll``, uniforms in [0, 1) of shape [pn, 1, 1]): the shader draws it
from its torch.Generator, the parity tests from jax.random.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import device_constant
from .brdf import distribution_ggx, tangent_frame
from .math import safe_normalize, saturate_dot

EPS = 1e-6
TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# host-side lattices
# ---------------------------------------------------------------------------

def fibonacci_sphere(num_samples: int, begin_elevation: float = 0):
    """Fibonacci lattice on the upper sphere (ref: base_utils.py:869-882).
    Returns (azimuths [n], elevations [n]) in radians."""
    ratio = (begin_elevation + 90) / 180
    num_points = int(num_samples // (1 - ratio))
    phi = (np.sqrt(5) - 1.0) / 2.0
    ns = np.arange(num_points - num_samples, num_points, dtype=np.float64)
    z = 2.0 * ns / num_points - 1.0
    azimuths = (2 * np.pi * ns * phi) % (2 * np.pi)
    elevations = np.arcsin(z)
    return azimuths, elevations


def az_el_to_points(azimuths, elevations):
    """(ref: base_utils.py:884-888)"""
    z = np.sin(elevations)
    x = np.cos(azimuths) * np.cos(elevations)
    y = np.sin(azimuths) * np.cos(elevations)
    return np.stack([x, y, z], -1)


def direction_samples_01(num_samples: int) -> np.ndarray:
    """The shader's precomputed (az, el) table scaled to [0,1]^2
    (ref: fields.py:733-742).  float32 [n, 2]."""
    az, el = fibonacci_sphere(num_samples, 0)
    az = az * 0.5 / np.pi
    el = 1.0 - 2.0 * el / np.pi
    return np.stack([az, el], -1).astype(np.float32)


def sphere_prior_angles_01(num_samples: int) -> np.ndarray:
    """Flow SphereSampler lattice (ref: flow.py:62-76).  float32 [n, 2]."""
    begin_elevation = 1
    ratio = (begin_elevation + 90) / 180
    num_points = int(num_samples // (1 - ratio))
    phi = (np.sqrt(5) - 1.0) / 2.0
    ns = np.arange(num_points - num_samples, num_points, dtype=np.float64)
    z = 2.0 * ns / num_points - 1.0
    phis = (2 * np.pi * ns * phi) % (2 * np.pi) / (2 * np.pi)
    thetas = np.arcsin(z) / (0.5 * np.pi)
    return np.stack([phis, thetas], -1).astype(np.float32)


def halton_sequence(dim_num: int, sample_num: int) -> np.ndarray:
    """Halton low-discrepancy sequence (replaces the ghalton wheel of
    ref: base_utils.py:68-71).  float32 [sample_num, dim_num]."""
    primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53]
    assert dim_num <= len(primes)
    out = np.zeros((sample_num, dim_num), dtype=np.float64)
    for d in range(dim_num):
        b = primes[d]
        nn = np.arange(1, sample_num + 1, dtype=np.int64)
        f = np.ones(sample_num)
        r = np.zeros(sample_num)
        while nn.max() > 0:
            f = f / b
            r = r + f * (nn % b)
            nn = nn // b
        out[:, d] = r
    return out.astype(np.float32)


def stratified_samples_1d(sample_num: int,
                          rng: np.random.Generator | None = None):
    """(ref: base_utils.py:73-80)"""
    rng = rng or np.random.default_rng()
    t = np.linspace(0.0, 1.0, sample_num, dtype=np.float32)
    mids = 0.5 * (t[1:] + t[:-1])
    upper = np.concatenate([mids, t[-1:]])
    lower = np.concatenate([t[:1], mids])
    return (lower + (upper - lower) * rng.random(sample_num)).astype(
        np.float32)


def stratified_samples_2d(sample_num: int,
                          rng: np.random.Generator | None = None):
    """(ref: base_utils.py:82-83)"""
    return np.stack([stratified_samples_1d(sample_num, rng),
                     stratified_samples_1d(sample_num, rng)], -1)


def direction_table(num_samples: int, device) -> torch.Tensor:
    """direction_samples_01 on ``device`` (built once)."""
    return device_constant(('direction_samples_01', num_samples),
                           lambda: direction_samples_01(num_samples), device)


# ---------------------------------------------------------------------------
# direction sampling (dense [pn, sn, ...] layouts)
# ---------------------------------------------------------------------------

def _angles_of(directions, x, y, z):
    """(phi, theta) of ``directions`` in the (x, y, z) tangent frame
    (ref: fields.py:1035-1048)."""
    cx = torch.sum(x[..., None, :] * directions, -1, keepdim=True)
    cy = torch.sum(y[..., None, :] * directions, -1, keepdim=True)
    cz = torch.clamp(torch.sum(z[..., None, :] * directions, -1,
                               keepdim=True), -1 + EPS, 1 - EPS)
    phi = torch.remainder(torch.atan2(cy, cx) + TWO_PI, TWO_PI)
    theta = torch.acos(cz)
    return torch.cat([phi, theta], dim=-1)


def direction_to_angle(normals, directions):
    """normals [pn,3], directions [pn,sn,3] -> angles [pn,sn,2]
    (ref: fields.py:1035-1048)."""
    x, y, z = tangent_frame(normals)
    return _angles_of(directions, x, y, z)


def sample_diffuse_directions(samples01, normals, view_dirs, roll=None):
    """Cosine-hemisphere sampling about each normal (ref: fields.py:824-856).

    samples01: [sn,2] (az, el) table in [0,1]; normals/view_dirs: [pn,3];
    roll: [pn,1,1] uniforms for the train-time azimuth roll (None = eval).
    Returns (directions [pn,sn,3], angles [pn,sn,2], pdf [pn,sn,1],
    angles_half [pn,sn,2])."""
    pn = normals.shape[0]
    x, y, z = tangent_frame(normals)

    az = samples01[None, :, 0:1] * TWO_PI        # [1,sn,1]
    el = samples01[None, :, 1:2]                 # [1,sn,1]
    el_sqrt = torch.sqrt(el + 1e-7)
    if roll is not None:
        az = torch.remainder(az + roll * TWO_PI, TWO_PI)
    coeff_z = torch.sqrt(1.0 - el + 1e-7)
    coeff_x = el_sqrt * torch.cos(az)
    coeff_y = el_sqrt * torch.sin(az)

    theta = torch.asin(torch.clamp(el_sqrt, 0.0, 1.0 - EPS))
    sn = samples01.shape[0]
    angles = torch.cat([az.expand(pn, sn, 1), theta.expand(pn, sn, 1)],
                       dim=-1)

    directions = (coeff_x * x[:, None, :] + coeff_y * y[:, None, :]
                  + coeff_z * z[:, None, :])

    pdf = (saturate_dot(directions, normals[:, None, :]) / math.pi
           * (torch.cos((1.0 - el) * math.pi / 2) * math.pi / 2))

    h = safe_normalize(directions + view_dirs[:, None, :])
    angles_half = _angles_of(h, x, y, z)
    return directions, angles, pdf, angles_half


def sample_specular_directions(samples01, normals, view_dirs, roughness,
                               roll=None):
    """GGX half-vector importance sampling (ref: fields.py:858-903).

    samples01: [sn,2]; normals/view_dirs [pn,3]; roughness [pn,1] = GGX
    alpha; roll as in sample_diffuse_directions.  Returns (directions
    [pn,sn,3], angles [pn,sn,2], pdf [pn,sn,1], angles_half [pn,sn,2])."""
    pn = normals.shape[0]
    sn = samples01.shape[0]
    x, y, z = tangent_frame(normals)
    a = roughness[:, None, :]                       # [pn,1,1]

    az = samples01[None, :, 0:1]                    # [1,sn,1]
    el = samples01[None, :, 1:2]
    phi = az * TWO_PI
    cos_theta = torch.sqrt(torch.clamp(
        (1.0 - el) / torch.clamp(1.0 + (a * a - 1.0) * el, min=EPS),
        min=EPS))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=EPS))

    if roll is not None:
        phi = torch.remainder(phi + roll * TWO_PI, TWO_PI)

    coeff_x = torch.cos(phi) * sin_theta
    coeff_y = torch.sin(phi) * sin_theta
    coeff_z = cos_theta

    angles_h = torch.cat(
        [phi.expand(pn, sn, 1),
         torch.asin(torch.clamp(sin_theta, 0.0, 1.0 - EPS))], dim=-1)
    h = (coeff_x * x[:, None, :] + coeff_y * y[:, None, :]
         + coeff_z * z[:, None, :])

    voh = saturate_dot(view_dirs[:, None, :], h)
    directions = voh * h * 2.0 - view_dirs[:, None, :]
    angles = _angles_of(directions, x, y, z)

    noh = torch.clamp(coeff_z, min=0.0)
    pdf = (distribution_ggx(noh, a) * noh / torch.clamp(4.0 * voh, min=EPS)
           * (torch.cos((1.0 - el) * math.pi / 2) * math.pi / 2))
    return directions, angles, pdf, angles_h


def _frame_combine(phi, theta, normals):
    x, y, z = tangent_frame(normals)
    coeff_z = torch.cos(theta)
    coeff_x = torch.sin(theta) * torch.cos(phi)
    coeff_y = torch.sin(theta) * torch.sin(phi)
    return (coeff_x * x[:, None, :] + coeff_y * y[:, None, :]
            + coeff_z * z[:, None, :]), (x, y, z)


def half_angles_to_directions(angles_half, normals, view_dirs):
    """Flow samples are half-vector angles; reflect the view about H to
    get outgoing directions (ref: fields.py:1086-1108).

    angles_half: [pn,sn,2] (phi, theta) in radians; returns (directions
    [pn,sn,3], angles [pn,sn,2], hov [pn,sn,1], theta [pn,sn,1])."""
    phi, theta = angles_half[..., 0:1], angles_half[..., 1:2]
    h, (x, y, z) = _frame_combine(phi, theta, normals)
    hov = saturate_dot(view_dirs[:, None, :], h)
    directions = hov * h * 2.0 - view_dirs[:, None, :]
    angles = _angles_of(directions, x, y, z)
    return directions, angles, hov, theta


def angles_to_directions(angles, normals):
    """Direct (non-half) angle -> direction in the tangent frame
    (ref: fields.py:1124-1132)."""
    return _frame_combine(angles[..., 0:1], angles[..., 1:2], normals)[0]
