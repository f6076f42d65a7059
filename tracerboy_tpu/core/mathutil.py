"""Vector math helpers over (..., 3) jnp arrays.

The compute path works on flat structure-of-arrays ray pools, so every helper
here is written to broadcast over arbitrary leading batch dimensions. This is
the data-parallel replacement for the reference's per-thread HLSL vector math
(reference: TracerBoy/kernel.glsl:441-660 BRDF helpers and
TracerBoy/kernel.glsl:1000-1015 ReorientVectorAroundNormal).
"""

from __future__ import annotations

import jax.numpy as jnp

EPSILON = 1e-4
LARGE_NUMBER = 1e10


def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-20))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v * jax_rsqrt(jnp.maximum(dot(v, v, keepdims=True), 1e-20))


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    import jax.lax

    return jax.lax.rsqrt(x)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """HLSL-style reflect: v - 2*dot(v,n)*n (v points toward the surface)."""
    return v - 2.0 * dot(v, n, keepdims=True) * n


def refract_dir(d: jnp.ndarray, n: jnp.ndarray, nr: jnp.ndarray):
    """Refraction of incoming direction d about normal n with relative IOR nr.

    Returns (direction, total_internal_reflection_mask). Mirrors the inline
    Snell computation of the reference integrator
    (TracerBoy/kernel.glsl:1530-1563): when the discriminant is <= eps the ray
    reflects instead.
    """
    d_dot_n = dot(d, n, keepdims=True)
    nr = jnp.asarray(nr)
    if nr.ndim < d.ndim:
        nr = nr[..., None]
    disc = 1.0 - nr * nr * (1.0 - d_dot_n * d_dot_n)
    tir = disc[..., 0] <= EPSILON
    refr = normalize(nr * (d - n * d_dot_n) - n * jnp.sqrt(jnp.maximum(disc, 0.0)))
    refl = reflect(d, n)
    return jnp.where(tir[..., None], refl, refr), tir


def saturate(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(x, 0.0, 1.0)


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luma (matches ColorToLuma in the reference's Tonemap.h)."""
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


def channel_average(rgb: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(rgb, axis=-1)


def orthonormal_basis(normal: jnp.ndarray):
    """Tangent/bitangent frame around `normal`.

    Uses the same branch structure as the reference's
    ReorientVectorAroundNormal (kernel.glsl:1000-1014) so that sampled
    hemispheres match, but expressed branchlessly with jnp.where for SIMD.
    Returns (tangent, bitangent); the frame maps local (x, y=up, z) into world
    space as x*tangent + y*normal + z*bitangent.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = jnp.abs(nx) > jnp.abs(ny)
    inv_xz = jax_rsqrt(jnp.maximum(nx * nx + nz * nz, 1e-20))
    inv_yz = jax_rsqrt(jnp.maximum(ny * ny + nz * nz, 1e-20))
    t_x = jnp.where(use_x, -nz * inv_xz, jnp.zeros_like(nx))
    t_y = jnp.where(use_x, jnp.zeros_like(nx), nz * inv_yz)
    t_z = jnp.where(use_x, nx * inv_xz, -ny * inv_yz)
    tangent = jnp.stack([t_x, t_y, t_z], axis=-1)
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def reorient_around_normal(v: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Map a local-space direction (y = up) into the frame around `normal`."""
    tangent, bitangent = orthonormal_basis(normal)
    return normalize(
        v[..., 0:1] * tangent + v[..., 1:2] * normal + v[..., 2:3] * bitangent
    )


def spherical_to_dir(phi: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """Local-space direction from polar angle phi (from +y) and azimuth theta."""
    sp = jnp.sin(phi)
    return jnp.stack([sp * jnp.cos(theta), jnp.cos(phi), sp * jnp.sin(theta)], axis=-1)


def transform_points(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a 3x4 (rotation|translation) affine transform to points (..., 3)."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_dirs(m: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    return d @ m[:3, :3].T


def make_affine(linear, translation):
    """Build a 3x4 affine matrix from a 3x3 linear part and a translation."""
    m = jnp.zeros((3, 4), dtype=jnp.float32)
    m = m.at[:3, :3].set(jnp.asarray(linear, jnp.float32))
    m = m.at[:3, 3].set(jnp.asarray(translation, jnp.float32))
    return m
