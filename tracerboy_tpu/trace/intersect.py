"""Ray-primitive intersection: Moller-Trumbore triangles, slab AABB test,
and a brute-force all-triangles intersector.

The reference's hot intersection is the watertight Woop/Benthin/Wald
triangle test inside the traversal ubershader
(D3D12RaytracingFallback/src/TraverseFunction.hlsli:232-313) plus the
box slab test (TraverseFunction.hlsli:204-221). Here everything is batched
jnp over flat ray pools: a (N,)-ray x (T,)-triangle test, which doubles
as:
  - the ground-truth reference the BVH traversal is validated against
    (the analog of CpuBVH2Builder vs GpuBvh2Builder A/B debugging), and
  - the fast path for tiny scenes where a BVH would only add gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracerboy_tpu.core.mathutil import cross, dot

BIG = jnp.float32(1e30)
TRI_EPS = jnp.float32(1e-9)


def ray_triangle(orig, direc, v0, v1, v2, t_max=None):
    """Moller-Trumbore, two-sided.

    orig/direc: (..., 3); v0/v1/v2: (..., 3) broadcastable against rays.
    Returns (t, u, v, hit): t = BIG where missed.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(direc, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > TRI_EPS, 1.0 / det, 0.0)
    tvec = orig - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direc, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > TRI_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 1e-5)
    )
    if t_max is not None:
        hit = hit & (t < t_max)
    return jnp.where(hit, t, BIG), u, v, hit


def ray_shear(direc):
    """Watertight-test shear constants for a ray direction.

    Reference: TraverseFunction.hlsli:469-489 (RayTriangleIntersect
    precompute) — pick the dominant axis kz, cycle kx/ky (swapped when
    d[kz] < 0 to preserve winding), and shear so the ray maps to +Z.
    Returns (kx, ky, kz, sx, sy, sz) with k* int32 and s* float.
    """
    ax = jnp.abs(direc[..., 0])
    ay = jnp.abs(direc[..., 1])
    az = jnp.abs(direc[..., 2])
    kz = jnp.where(
        (az >= ax) & (az >= ay), 2, jnp.where(ay >= ax, 1, 0)
    ).astype(jnp.int32)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = jnp.take_along_axis(direc, kz[..., None], axis=-1)[..., 0]
    swap = dz < 0.0
    kx, ky = jnp.where(swap, ky, kx), jnp.where(swap, kx, ky)
    dx = jnp.take_along_axis(direc, kx[..., None], axis=-1)[..., 0]
    dy = jnp.take_along_axis(direc, ky[..., None], axis=-1)[..., 0]
    safe = jnp.where(dz == 0.0, jnp.float32(1e-30), dz)
    return kx, ky, kz, dx / safe, dy / safe, 1.0 / safe


def ray_triangle_watertight(orig, direc, v0, v1, v2, t_max=None):
    """Watertight Woop/Benthin/Wald ray-triangle test, two-sided.

    The reference's traversal uses this exact algorithm
    (D3D12RaytracingFallback/src/TraverseFunction.hlsli:232-313): shear
    the triangle into ray space and evaluate the three 2D edge functions
    U, V, W. Adjacent triangles sharing an edge compute the same two
    transformed vertices, so the shared edge function is exactly negated
    between them — a ray crossing the edge is accepted by at least one
    triangle and cracks cannot open (the watertight property Moller-
    Trumbore lacks).

    Same signature/return contract as ray_triangle. Barycentrics are
    converted to the MT convention (u weights v1, v weights v2).
    """
    kx, ky, kz, sx, sy, sz = ray_shear(direc)

    def shear(p):
        rel = p - orig
        px = jnp.take_along_axis(rel, kx[..., None], axis=-1)[..., 0]
        py = jnp.take_along_axis(rel, ky[..., None], axis=-1)[..., 0]
        pz = jnp.take_along_axis(rel, kz[..., None], axis=-1)[..., 0]
        return px - sx * pz, py - sy * pz, pz

    ax_, ay_, az_ = shear(jnp.broadcast_to(v0, jnp.broadcast_shapes(
        v0.shape, orig.shape)))
    bx_, by_, bz_ = shear(jnp.broadcast_to(v1, jnp.broadcast_shapes(
        v1.shape, orig.shape)))
    cx_, cy_, cz_ = shear(jnp.broadcast_to(v2, jnp.broadcast_shapes(
        v2.shape, orig.shape)))

    u = cx_ * by_ - cy_ * bx_
    v = ax_ * cy_ - ay_ * cx_
    w = bx_ * ay_ - by_ * ax_

    det = u + v + w
    same_sign = ((u >= 0.0) & (v >= 0.0) & (w >= 0.0)) | (
        (u <= 0.0) & (v <= 0.0) & (w <= 0.0)
    )
    inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
    t = (u * az_ + v * bz_ + w * cz_) * sz * inv_det
    hit = same_sign & (det != 0.0) & (t > 1e-5)
    if t_max is not None:
        hit = hit & (t < t_max)
    # MT convention: u weights v1 (edge function V), v weights v2 (W).
    return (
        jnp.where(hit, t, BIG),
        v * inv_det,
        w * inv_det,
        hit,
    )


def ray_aabb(orig, inv_dir, lo, hi, t_max):
    """Slab test. orig/inv_dir: (..., 3); lo/hi broadcastable.

    Returns (t_near, intersects). Entry at t_near >= 0 or ray starts inside.
    """
    t0 = (lo - orig) * inv_dir
    t1 = (hi - orig) * inv_dir
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    t_near = jnp.max(tmin, axis=-1)
    t_far = jnp.min(tmax, axis=-1)
    hit = (t_far >= jnp.maximum(t_near, 0.0)) & (t_near < t_max)
    return t_near, hit


def brute_force_closest(orig, direc, v0, v1, v2, t_max=None,
                        watertight=False):
    """Closest hit over all triangles by exhaustive (N, T) broadcast.

    The ground-truth oracle for traversal tests. The production brute
    backend uses brute_force_closest_soa below (dense layouts, O(N)
    memory); this (N, T) broadcast form is test-only.
    watertight=True swaps in the Woop/Benthin/Wald test (the reference's
    traversal intersector) for edge-crack-free results.
    """
    tri_test = ray_triangle_watertight if watertight else ray_triangle
    t, u, v, hit = tri_test(
        orig[:, None, :], direc[:, None, :], v0[None], v1[None], v2[None],
        t_max=None if t_max is None else t_max[:, None],
    )
    best = jnp.argmin(t, axis=1)
    n = jnp.arange(t.shape[0])
    t_best = t[n, best]
    found = t_best < BIG
    return (
        t_best,
        jnp.where(found, best, -1),
        u[n, best],
        v[n, best],
    )


def brute_force_anyhit(orig, direc, v0, v1, v2, t_max):
    """Occlusion test over all triangles (shadow rays)."""
    t, _, _, hit = ray_triangle(
        orig[:, None, :], direc[:, None, :], v0[None], v1[None], v2[None],
        t_max=t_max[:, None],
    )
    return jnp.any(hit, axis=1)


# ----------------------------------------------------------------------------
# SoA variants: dense (N,) layouts, per-triangle scalar broadcasting.
# The (N, T) broadcast forms above hold an (N, T) intermediate; these
# loop over triangles with scalar vertex loads instead, keeping every
# array a dense (N,) vector.


def _tri_scalar(tris, i):
    """Nine scalar vertex components of triangle i from a (T, 9) array
    laid out [v0 v1 v2] xyz."""
    row = jax.lax.dynamic_slice(tris, (i, 0), (1, 9))[0]
    return row


def brute_force_closest_soa(o, d, tris, t_max=None):
    """Closest hit over all triangles, SoA rays.

    o, d: V3 of (N,); tris: (T, 9) float32 [v0.xyz v1.xyz v2.xyz].
    Returns (t (N,), tri (N,), u, v).
    """
    import jax

    N = o.x.shape[0]
    T = tris.shape[0]

    def body(i, carry):
        t_best, tri_best, u_best, v_best = carry
        r = _tri_scalar(tris, i)
        v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = (
            r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]
        )
        e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
        e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
        px = d.y * e2z - d.z * e2y
        py = d.z * e2x - d.x * e2z
        pz = d.x * e2y - d.y * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = jnp.where(jnp.abs(det) > TRI_EPS, 1.0 / det, 0.0)
        tvx, tvy, tvz = o.x - v0x, o.y - v0y, o.z - v0z
        uu = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (d.x * qx + d.y * qy + d.z * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (
            (jnp.abs(det) > TRI_EPS)
            & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (tt > 1e-5) & (tt < t_best)
        )
        return (
            jnp.where(ok, tt, t_best),
            jnp.where(ok, i, tri_best),
            jnp.where(ok, uu, u_best),
            jnp.where(ok, vv, v_best),
        )

    # Tie carries to ray data so their device-varying type is stable
    # across iterations under shard_map.
    vz = (o.x + d.x) * 0.0
    init_t = (jnp.full((N,), BIG) + vz if t_max is None
              else jnp.asarray(t_max, jnp.float32) + vz)
    t, tri, u, v = jax.lax.fori_loop(
        0, T, body,
        (init_t, jnp.full((N,), -1, jnp.int32) + vz.astype(jnp.int32),
         vz, vz),
    )
    return jnp.where(tri < 0, BIG, t), tri, u, v


def brute_force_anyhit_soa(o, d, tris, t_max, tri_opaque=None):
    """Occlusion over all triangles, SoA rays; optional per-tri opacity."""
    import jax

    N = o.x.shape[0]
    T = tris.shape[0]

    def body(i, occluded):
        r = _tri_scalar(tris, i)
        v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = (
            r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]
        )
        e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
        e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
        px = d.y * e2z - d.z * e2y
        py = d.z * e2x - d.x * e2z
        pz = d.x * e2y - d.y * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = jnp.where(jnp.abs(det) > TRI_EPS, 1.0 / det, 0.0)
        tvx, tvy, tvz = o.x - v0x, o.y - v0y, o.z - v0z
        uu = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (d.x * qx + d.y * qy + d.z * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (
            (jnp.abs(det) > TRI_EPS)
            & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (tt > 1e-5) & (tt < t_max)
        )
        if tri_opaque is not None:
            ok = ok & (tri_opaque[i] > 0)
        return occluded | ok

    vz = (o.x + d.x + t_max) * 0.0
    return jax.lax.fori_loop(0, T, body, vz != 0.0)
