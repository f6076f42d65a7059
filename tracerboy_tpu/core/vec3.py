"""Structure-of-arrays 3-vectors: tuples of (N,) component arrays.

The hot compute path keeps per-ray vectors in structure-of-arrays form: a
vector is a `V3` namedtuple of three (N,) arrays, so each component is a
contiguous plane and elementwise stages read and write whole planes
instead of strided (N, 3) rows.

All functions broadcast over scalars and (N,) arrays alike.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def from_rows(a: jnp.ndarray) -> V3:
    """(N, 3) -> V3 of (N,) arrays (layout boundary conversion)."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: V3) -> jnp.ndarray:
    """V3 -> (N, 3) (layout boundary conversion)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def splat(c) -> V3:
    """A constant 3-vector (python/np sequence) as scalar components."""
    return V3(jnp.float32(c[0]), jnp.float32(c[1]), jnp.float32(c[2]))


def full_like(ref: V3, value: float) -> V3:
    z = jnp.full_like(ref.x, value)
    return V3(z, jnp.full_like(ref.y, value), jnp.full_like(ref.z, value))


def dot(a: V3, b: V3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(v: V3) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 1e-20))


def normalize(v: V3) -> V3:
    import jax.lax

    inv = jax.lax.rsqrt(jnp.maximum(dot(v, v), 1e-20))
    return V3(v.x * inv, v.y * inv, v.z * inv)


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def reflect(v: V3, n: V3) -> V3:
    d = 2.0 * dot(v, n)
    return V3(v.x - d * n.x, v.y - d * n.y, v.z - d * n.z)


def min_c(v: V3) -> jnp.ndarray:
    return jnp.minimum(jnp.minimum(v.x, v.y), v.z)


def max_c(v: V3) -> jnp.ndarray:
    return jnp.maximum(jnp.maximum(v.x, v.y), v.z)


def mean_c(v: V3) -> jnp.ndarray:
    return (v.x + v.y + v.z) / 3.0


def any_gt(v: V3, t) -> jnp.ndarray:
    return (v.x > t) | (v.y > t) | (v.z > t)


def all_lt(v: V3, t) -> jnp.ndarray:
    return (v.x < t) & (v.y < t) & (v.z < t)


def luminance(v: V3) -> jnp.ndarray:
    return 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z


def exp(v: V3) -> V3:
    return V3(jnp.exp(v.x), jnp.exp(v.y), jnp.exp(v.z))


def isnan_any(v: V3) -> jnp.ndarray:
    return jnp.isnan(v.x) | jnp.isnan(v.y) | jnp.isnan(v.z)


def orthonormal_basis(n: V3):
    """Tangent/bitangent frame matching mathutil.orthonormal_basis."""
    import jax.lax

    use_x = jnp.abs(n.x) > jnp.abs(n.y)
    inv_xz = jax.lax.rsqrt(jnp.maximum(n.x * n.x + n.z * n.z, 1e-20))
    inv_yz = jax.lax.rsqrt(jnp.maximum(n.y * n.y + n.z * n.z, 1e-20))
    t = V3(
        jnp.where(use_x, -n.z * inv_xz, jnp.zeros_like(n.x)),
        jnp.where(use_x, jnp.zeros_like(n.x), n.z * inv_yz),
        jnp.where(use_x, n.x * inv_xz, -n.y * inv_yz),
    )
    return t, cross(n, t)


def reorient(v: V3, n: V3) -> V3:
    """Map local (x, y=up, z) around normal n; matches
    mathutil.reorient_around_normal."""
    t, b = orthonormal_basis(n)
    return normalize(
        V3(
            v.x * t.x + v.y * n.x + v.z * b.x,
            v.x * t.y + v.y * n.y + v.z * b.y,
            v.x * t.z + v.y * n.z + v.z * b.z,
        )
    )
