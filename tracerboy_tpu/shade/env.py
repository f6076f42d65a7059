"""Environment map sampling.

Matches the reference's lat-long lookup (TracerBoy/RayGenCommon.h:21-44):
the direction is rotated by the environment transform, then mapped with
uv.x = atan2(y, x) / 2pi (wrapped positive) and uv.y = acos(z) / pi —
a z-up lat-long parameterization — and scaled by the environment color
scale (ConfigConstants, SharedShaderStructs.h:77-83).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_environment(direction, env_map, env_transform, env_color_scale):
    """Evaluate the environment for (N, 3) directions.

    env_map: (H, W, 3); env_transform: (3, 3) world->env rotation;
    env_color_scale: (3,).
    """
    # Full f32 precision: a default-precision f32 matmul may run in
    # reduced precision (TF32) on the GPU and round the directions.
    v = jnp.matmul(direction, env_transform.T,
                   precision=jax.lax.Precision.HIGHEST)
    v = v / jnp.maximum(
        jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12
    )
    p = jnp.arctan2(v[..., 1], v[..., 0])
    p = jnp.where(p > 0, p, p + 2.0 * jnp.pi)
    u = p / (2.0 * jnp.pi)
    w = jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0)) / jnp.pi

    H, W = env_map.shape[0], env_map.shape[1]
    # Bilinear sample with wrap in u, clamp in v.
    fx = u * W - 0.5
    fy = w * H - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = jnp.mod(x0, W)
    x1w = jnp.mod(x0 + 1, W)
    y0c = jnp.clip(y0, 0, H - 1)
    y1c = jnp.clip(y0 + 1, 0, H - 1)
    c00 = env_map[y0c, x0w]
    c01 = env_map[y0c, x1w]
    c10 = env_map[y1c, x0w]
    c11 = env_map[y1c, x1w]
    col = (
        c00 * (1 - tx) * (1 - ty)
        + c01 * tx * (1 - ty)
        + c10 * (1 - tx) * ty
        + c11 * tx * ty
    )
    return col * env_color_scale


def sample_environment_soa(d, env_r, env_g, env_b, env_h: int, env_w: int,
                           env_transform, env_color_scale):
    """SoA environment lookup: V3 directions -> V3 radiance.

    env_r/g/b: flattened (H*W,) channel arrays (dense gathers instead of
    (N, 3) padded results).
    """
    from tracerboy_tpu.core import vec3 as v3

    m = env_transform
    vx = d.x * m[0, 0] + d.y * m[0, 1] + d.z * m[0, 2]
    vy = d.x * m[1, 0] + d.y * m[1, 1] + d.z * m[1, 2]
    vz = d.x * m[2, 0] + d.y * m[2, 1] + d.z * m[2, 2]
    vv = v3.normalize(v3.V3(vx, vy, vz))

    p = jnp.arctan2(vv.y, vv.x)
    p = jnp.where(p > 0, p, p + 2.0 * jnp.pi)
    u = p / (2.0 * jnp.pi)
    w = jnp.arccos(jnp.clip(vv.z, -1.0, 1.0)) / jnp.pi

    H, W = env_h, env_w
    fx = u * W - 0.5
    fy = w * H - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0
    ty = fy - y0
    x0w = jnp.mod(x0, W)
    x1w = jnp.mod(x0 + 1, W)
    y0c = jnp.clip(y0, 0, H - 1)
    y1c = jnp.clip(y0 + 1, 0, H - 1)
    i00 = y0c * W + x0w
    i01 = y0c * W + x1w
    i10 = y1c * W + x0w
    i11 = y1c * W + x1w
    w00 = (1 - tx) * (1 - ty)
    w01 = tx * (1 - ty)
    w10 = (1 - tx) * ty
    w11 = tx * ty

    def chan(c):
        return (c[i00] * w00 + c[i01] * w01 + c[i10] * w10 + c[i11] * w11)

    return v3.V3(
        chan(env_r) * env_color_scale[0],
        chan(env_g) * env_color_scale[1],
        chan(env_b) * env_color_scale[2],
    )


def sample_environment_quad_soa(d, env_quad, env_h: int, env_w: int,
                                env_transform, env_color_scale,
                                gather_mask=None):
    """SoA environment lookup via the precomputed quad-row table.

    env_quad: (H*W, 12) — row i holds the 2x2 bilinear neighborhood of
    texel i (compile.py as_pytree). One wide-row gather replaces the 12
    per-plane gathers of sample_environment_soa.
    """
    from tracerboy_tpu.core import vec3 as v3

    m = env_transform
    vx = d.x * m[0, 0] + d.y * m[0, 1] + d.z * m[0, 2]
    vy = d.x * m[1, 0] + d.y * m[1, 1] + d.z * m[1, 2]
    vz = d.x * m[2, 0] + d.y * m[2, 1] + d.z * m[2, 2]
    vv = v3.normalize(v3.V3(vx, vy, vz))

    p = jnp.arctan2(vv.y, vv.x)
    p = jnp.where(p > 0, p, p + 2.0 * jnp.pi)
    u = p / (2.0 * jnp.pi)
    w = jnp.arccos(jnp.clip(vv.z, -1.0, 1.0)) / jnp.pi

    H, W = env_h, env_w
    fx = u * W - 0.5
    fy = w * H - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0
    # Clamp the vertical blend at the poles: for fy < 0 the quad row of
    # texel (0, x) holds rows 0 and 1, so an unclamped ty would blend
    # toward row 1 where sample_environment_soa clamps both taps to row
    # 0 (advisor finding, round 2).
    ty = jnp.where(y0 < 0, 0.0, fy - y0)
    x0w = jnp.mod(x0, W)
    y0c = jnp.clip(y0, 0, H - 1)
    idx = y0c * W + x0w
    if gather_mask is not None:
        # Lanes whose result is discarded gather the (cache-hot) first
        # row instead of a random texel.
        idx = jnp.where(gather_mask, idx, 0)
    rows = env_quad[idx]                     # (N, 12)
    w00 = (1 - tx) * (1 - ty)
    w01 = tx * (1 - ty)
    w10 = (1 - tx) * ty
    w11 = tx * ty

    def chan(c):
        return (rows[:, c] * w00 + rows[:, 3 + c] * w01
                + rows[:, 6 + c] * w10 + rows[:, 9 + c] * w11)

    return v3.V3(
        chan(0) * env_color_scale[0],
        chan(1) * env_color_scale[1],
        chan(2) * env_color_scale[2],
    )
