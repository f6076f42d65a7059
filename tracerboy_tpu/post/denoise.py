"""Edge-avoiding a-trous wavelet denoiser (SVGF-style).

Rebuilds DenoiserCS.hlsl: 5x5 B3-spline kernel with dilation
OffsetMultiplier = 2^i per iteration (DenoiserPass.cpp:61-93 ping-pong),
weights = luma (variance-normalized, DenoiserCS.hlsl:33-35) x normal^exp
(37-39) x world-position distance (41-44), variance propagated with w^2
(145-152). The jnp formulation expresses the 25 dilated taps as jnp.roll
shifts, fully vectorized over the image.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracerboy_tpu.core.mathutil import luminance

EPSILON = 1e-4
_KERNEL_1D = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


@partial(jax.jit, static_argnames=("step",))
def atrous_iteration(
    color_var,        # (H, W, 4) color + luminance variance in alpha
    undenoised,       # (H, W, 3) original noisy frame (luma reference)
    normals,          # (H, W, 3)
    positions,        # (H, W, 4) world pos + neighbor distance
    step: int,        # dilation (1, 2, 4, ...)
    luma_weight_mult=4.0,
    normal_exp=128.0,
    position_weight_mult=1.0,
):
    H, W = color_var.shape[:2]
    # Work on dense (H, W) channel planes (see core/vec3.py).
    cr, cg, cb = (color_var[..., k] for k in range(3))
    cvar = color_var[..., 3]
    nx, ny_, nz = (normals[..., k] for k in range(3))
    px_, py_, pz = (positions[..., k] for k in range(3))
    center_luma = luminance(undenoised)
    center_var_sqrt = jnp.sqrt(jnp.maximum(cvar, 0.0))
    neighbor_dist = positions[..., 3]
    valid = (nx != 0.0) | (ny_ != 0.0) | (nz != 0.0)

    # Taps = pad each plane ONCE (edge replicate) + STATIC slices:
    # static slices of one padded buffer fuse into the surrounding
    # arithmetic, where a dilated jnp.roll per tap would not.
    pad = 2 * step
    epad = lambda p: jnp.pad(p, pad, mode="edge")
    p_luma = epad(center_luma)
    p_nx, p_ny, p_nz = epad(nx), epad(ny_), epad(nz)
    p_px, p_py, p_pz = epad(px_), epad(py_), epad(pz)
    p_cr, p_cg, p_cb, p_cv = epad(cr), epad(cg), epad(cb), epad(cvar)

    def tap(p, oy, ox):
        y0 = pad + oy * step
        x0 = pad + ox * step
        return jax.lax.slice(p, (y0, x0), (y0 + H, x0 + W))

    acc_r = jnp.zeros((H, W), jnp.float32)
    acc_g = jnp.zeros((H, W), jnp.float32)
    acc_b = jnp.zeros((H, W), jnp.float32)
    acc_var = jnp.zeros((H, W), jnp.float32)
    acc_w = jnp.zeros((H, W), jnp.float32)

    for oy in range(-2, 3):
        for ox in range(-2, 3):
            luma_w = jnp.exp(
                -jnp.abs(tap(p_luma, oy, ox) - center_luma)
                / jnp.maximum(luma_weight_mult * center_var_sqrt, EPSILON)
            )
            ndot = (
                nx * tap(p_nx, oy, ox) + ny_ * tap(p_ny, oy, ox)
                + nz * tap(p_nz, oy, ox)
            )
            normal_w = jnp.power(jnp.maximum(0.0, ndot), normal_exp)
            dxp = tap(p_px, oy, ox) - px_
            dyp = tap(p_py, oy, ox) - py_
            dzp = tap(p_pz, oy, ox) - pz
            dist = jnp.sqrt(dxp * dxp + dyp * dyp + dzp * dzp)
            # offset-scaled tolerance (DenoiserCS.hlsl:41-44)
            off_mag = jnp.abs(ox * step) + jnp.abs(oy * step)
            pos_w = jnp.exp(
                -dist / (position_weight_mult * off_mag * neighbor_dist
                         + EPSILON)
            )
            w = (
                luma_w * normal_w * pos_w
                * _KERNEL_1D[ox + 2] * _KERNEL_1D[oy + 2]
            )
            # Suppress out-of-image taps (edge padding repeats border
            # pixels; the reference skips them) — constant mask.
            yy = jnp.arange(H)[:, None] + oy * step
            xx = jnp.arange(W)[None, :] + ox * step
            inside = (
                (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            ).astype(jnp.float32)
            w = w * inside

            acc_r = acc_r + tap(p_cr, oy, ox) * w
            acc_g = acc_g + tap(p_cg, oy, ox) * w
            acc_b = acc_b + tap(p_cb, oy, ox) * w
            acc_var = acc_var + tap(p_cv, oy, ox) * w * w
            acc_w = acc_w + w

    inv_w = 1.0 / jnp.maximum(acc_w, 1e-8)
    out = jnp.stack(
        [acc_r * inv_w, acc_g * inv_w, acc_b * inv_w,
         acc_var * inv_w * inv_w], axis=-1,
    )
    # Pixels with no geometry pass through untouched.
    return jnp.where(valid[..., None], out, color_var)


def denoise(color_var, undenoised, normals, positions, iterations: int = 4,
            **weights):
    """N a-trous iterations with doubling dilation (DenoiserPass.cpp:61-93)."""
    out = color_var
    for i in range(iterations):
        out = atrous_iteration(
            out, undenoised, normals, positions, step=2**i, **weights
        )
    return out
