"""Tonemap operator library.

Rebuilds the eight display transforms of the reference (TracerBoy/Tonemap.h:
173-204): Reinhard, ACES (Stephen Hill fit), Clamp, Uncharted2 (Hable filmic),
Khronos PBR Neutral, AgX, AgX "punchy", and GT (Uchimura). All are standard
published operators implemented from their public formulations; everything is
pure jnp and broadcasts over (..., 3) images.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TONEMAP_REINHARD = 0
TONEMAP_ACES = 1
TONEMAP_CLAMP = 2
TONEMAP_UNCHARTED = 3
TONEMAP_KHRONOS_PBR_NEUTRAL = 4
TONEMAP_AGX = 5
TONEMAP_AGX_PUNCHY = 6
TONEMAP_GT = 7
NUM_TONEMAPPERS = 8


def _luma(c):
    return (
        0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]
    )[..., None]


def reinhard(color: jnp.ndarray) -> jnp.ndarray:
    return color / (1.0 + color)


def clamp_op(color: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(color, 0.0, 1.0)


# --- ACES (Stephen Hill's fitted RRT+ODT approximation) ---------------------

_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    np.float32,
)
_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    np.float32,
)


def _mat3(color, m):
    """color @ m.T in full f32 (a default-precision f32 matmul may run
    in TF32 on the GPU)."""
    return jnp.matmul(color, m.T, precision=jax.lax.Precision.HIGHEST)


def aces_fitted(color: jnp.ndarray) -> jnp.ndarray:
    c = _mat3(color, _ACES_INPUT)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    c = a / b
    c = _mat3(c, _ACES_OUTPUT)
    return jnp.clip(c, 0.0, 1.0)


# --- Uncharted 2 (John Hable's filmic curve) --------------------------------


def _uncharted2_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def uncharted2(color: jnp.ndarray) -> jnp.ndarray:
    exposure_bias = 2.0
    curr = _uncharted2_partial(color * exposure_bias)
    white_scale = 1.0 / _uncharted2_partial(jnp.full((3,), 11.2, jnp.float32))
    return curr * white_scale


# --- Khronos PBR Neutral ----------------------------------------------------


def khronos_pbr_neutral(color: jnp.ndarray) -> jnp.ndarray:
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = jnp.min(color, axis=-1, keepdims=True)
    offset = jnp.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = color - offset
    peak = jnp.max(c, axis=-1, keepdims=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (jnp.maximum(peak, 1e-6) + d - start_compression)
    scaled = c * (new_peak / jnp.maximum(peak, 1e-6))
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    out = jnp.where(
        peak > start_compression,
        scaled * (1.0 - g) + new_peak * g,
        c,
    )
    return out


# --- AgX (Benjamin Wrensch's approximation of Troy Sobotka's AgX) -----------

_AGX_TRANSFORM = np.array(
    [
        [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
        [0.0784335999999992, 0.878468636469772, 0.0784336],
        [0.0792237451477643, 0.0791661274605434, 0.879142973793104],
    ],
    np.float32,
)
_AGX_INV_TRANSFORM = np.array(
    [
        [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
        [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
        [-0.0990297440797205, -0.0989611768448433, 1.15107367264116],
    ],
    np.float32,
)
_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def _agx_contrast_approx(x):
    x2 = x * x
    x4 = x2 * x2
    return (
        +15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )


def _agx_base(color):
    c = _mat3(color, _AGX_TRANSFORM)
    c = jnp.clip(jnp.log2(jnp.maximum(c, 1e-10)), _AGX_MIN_EV, _AGX_MAX_EV)
    c = (c - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV)
    return _agx_contrast_approx(c)


def _agx_eotf(color):
    return jnp.clip(_mat3(color, _AGX_INV_TRANSFORM), 0.0, 1.0)


def agx(color: jnp.ndarray, punchy: bool = False) -> jnp.ndarray:
    val = _agx_base(color)
    if punchy:
        lw = np.array([0.2126, 0.7152, 0.0722], np.float32)
        luma = jnp.sum(val * lw, axis=-1, keepdims=True)
        power = 1.35
        sat = 1.4
        val = jnp.power(jnp.maximum(val, 0.0), power)
        val = luma + sat * (val - luma)
    return _agx_eotf(val)


# --- GT (Hajime Uchimura's Gran Turismo tonemapper) -------------------------


def gt_tonemap(color: jnp.ndarray) -> jnp.ndarray:
    P = 1.0   # max display brightness
    a = 1.0   # contrast
    m = 0.22  # linear section start
    l = 0.4   # linear section length
    c = 1.33  # black
    b = 0.0   # pedestal
    x = color
    l0 = ((P - m) * l) / a
    S0 = m + l0
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P
    w0 = 1.0 - _smooth01(x / jnp.float32(m))
    w2 = jnp.where(x > m + l0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2
    T = m * jnp.power(jnp.maximum(x, 1e-8) / m, c) + b
    S = P - (P - S1) * jnp.exp(CP * (x - S0))
    L = m + a * (x - m)
    return T * w0 + L * w1 + S * w2


def _smooth01(x):
    t = jnp.clip(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# ----------------------------------------------------------------------------

_OPERATORS = {
    TONEMAP_REINHARD: reinhard,
    TONEMAP_ACES: aces_fitted,
    TONEMAP_CLAMP: clamp_op,
    TONEMAP_UNCHARTED: uncharted2,
    TONEMAP_KHRONOS_PBR_NEUTRAL: khronos_pbr_neutral,
    TONEMAP_AGX: agx,
    TONEMAP_AGX_PUNCHY: lambda c: agx(c, punchy=True),
    TONEMAP_GT: gt_tonemap,
}


def tonemap(tonemap_type: int, color: jnp.ndarray) -> jnp.ndarray:
    """Apply tonemap operator `tonemap_type` (static int) to linear RGB."""
    return _OPERATORS[int(tonemap_type)](color)


def gamma_correct(color: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """Linear -> display gamma (Tonemap.h GammaCorrect)."""
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / gamma)


def gamma_to_linear(color: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    return jnp.power(jnp.maximum(color, 0.0), gamma)
