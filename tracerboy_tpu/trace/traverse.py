"""Wide-BVH traversal, vectorized over flat ray pools.

The data-parallel replacement for the reference's per-thread stack
traversal state machine (D3D12RaytracingFallback/src/
TraverseFunction.hlsli:537-784: two-level stack machine, groupshared
16-deep stacks, slab + watertight triangle tests). This is the BVH path
of the wavefront for scenes above the brute-force crossover. Design
differences:

- All rays advance in lock-step through their own short stacks (SoA
  (N, DEPTH) int32), with lane masking instead of divergent branches —
  the SIMT pattern expressed as jnp ops under lax.while_loop.
- Nodes are 8-wide: one (gathered) node fetch yields 8 sibling boxes which
  are slab-tested simultaneously per ray, amortizing the gather and
  shortening the tree ~3x vs the reference's binary BVH.
- Leaves are clusters of `leaf_size` consecutive triangles in morton order,
  intersected as a (N, K) batch per step.

A `max_steps` bound keeps the loop from spinning on malformed input — the
moral analog of the reference's TdrDelay escape hatch for long traversals
(Scripts/TdrDelay.reg).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracerboy_tpu.accel.bvh import INVALID
from tracerboy_tpu.trace.intersect import ray_aabb, ray_triangle, BIG

# Worst-case growth is (WIDE_FACTOR-1) * tree_depth; 48 covers the depth-6
# wide trees of the largest bundled scene with margin (the reference uses a
# fixed 16-deep stack for its binary BVH, RayTracingHlslCompat.h:15).
STACK_DEPTH = 48


@partial(jax.jit, static_argnames=("leaf_size", "max_steps", "any_hit"))
def traverse_wide(
    orig,
    direc,
    t_max,
    bounds_lo,   # (W, 8, 3)
    bounds_hi,   # (W, 8, 3)
    children,    # (W, 8) int32
    tri_v0,      # (C*K, 3) morton-ordered triangle vertices
    tri_v1,
    tri_v2,
    leaf_size: int,
    max_steps: int = 100_000,
    any_hit: bool = False,
    tri_mask=None,
):
    """Closest-hit (or any-hit) traversal over the 8-wide BVH.

    Returns (t, tri_idx, u, v) with tri_idx an index into the *morton
    ordered* triangle arrays (-1 for miss); t == BIG on miss. With
    any_hit=True returns a boolean occlusion mask instead.
    """
    N = orig.shape[0]
    K = leaf_size
    W = children.shape[0]
    rows = jnp.arange(N)

    safe_dir = jnp.where(
        jnp.abs(direc) < 1e-12, jnp.where(direc < 0, -1e-12, 1e-12), direc
    )
    inv_dir = 1.0 / safe_dir

    # `vz` is a per-lane zero derived from a (possibly device-varying)
    # input: loop carries are tied to it so their sharding type stays
    # consistent across iterations under shard_map (vma tracking).
    vz = (orig[:, 0] + direc[:, 0] + jnp.asarray(t_max, jnp.float32)) * 0.0
    vz = jnp.broadcast_to(vz, (N,))
    vzi = vz.astype(jnp.int32)
    state = dict(
        stack=jnp.zeros((N, STACK_DEPTH), jnp.int32) + vzi[:, None],
        sp=jnp.ones((N,), jnp.int32) + vzi,  # root pre-pushed at slot 0
        t_best=jnp.asarray(t_max, jnp.float32) + vz,
        tri_best=jnp.full((N,), -1, jnp.int32) + vzi,
        u_best=vz,
        v_best=vz,
        occluded=vzi > 0,
        # Per-ray traversal-cost counters (box tests / triangle tests) —
        # the heatmap instrumentation of the reference's traversal
        # (TraverseFunction.hlsli:46-47).
        box_tests=vz,
        tri_tests=vz,
        step=jnp.int32(0),
    )

    def live_mask(s):
        live = s["sp"] > 0
        if any_hit:
            live = live & ~s["occluded"]
        return live

    def cond(s):
        return jnp.any(live_mask(s)) & (s["step"] < max_steps)

    def body(s):
        live = live_mask(s)
        spm1 = jnp.maximum(s["sp"] - 1, 0)
        node = s["stack"][rows, spm1]
        sp = jnp.where(live, spm1, s["sp"])

        node_c = jnp.clip(node, 0, W - 1)
        ch = children[node_c]                  # (N, 8)
        lo = bounds_lo[node_c]                 # (N, 8, 3)
        hi = bounds_hi[node_c]

        _, box_hit = ray_aabb(
            orig[:, None, :], inv_dir[:, None, :], lo, hi,
            s["t_best"][:, None],
        )
        valid = box_hit & (ch != INVALID) & live[:, None]
        is_leaf = valid & (ch < 0)
        is_inner = valid & (ch >= 0)

        box_tests = s["box_tests"] + jnp.where(live, 8.0, 0.0)
        tri_tests = s["tri_tests"] + jnp.sum(
            is_leaf.astype(jnp.float32), axis=1
        ) * K

        # --- push inner children ---
        push_order = jnp.cumsum(is_inner.astype(jnp.int32), axis=1) - 1
        slot_pos = sp[:, None] + push_order  # overflow drops via mode="drop"
        rows8 = jnp.broadcast_to(rows[:, None], (N, 8))
        # Non-pushed slots scatter out of bounds and are dropped.
        stack = s["stack"].at[
            rows8, jnp.where(is_inner, slot_pos, STACK_DEPTH)
        ].set(ch, mode="drop")
        sp_new = jnp.minimum(
            sp + jnp.sum(is_inner, axis=1).astype(jnp.int32), STACK_DEPTH
        )

        # --- intersect leaf clusters, one wide slot at a time ---
        def leaf_slot(sl, carry):
            t_best, tri_best, u_best, v_best, occluded = carry
            leaf_mask = is_leaf[:, sl]
            cluster = jnp.where(leaf_mask, -ch[:, sl] - 1, 0)
            tri_ids = cluster[:, None] * K + jnp.arange(K)[None, :]  # (N, K)
            a = tri_v0[tri_ids]
            b = tri_v1[tri_ids]
            c = tri_v2[tri_ids]
            t, uu, vv, hit = ray_triangle(
                orig[:, None, :], direc[:, None, :], a, b, c,
                t_max=t_best[:, None],
            )
            if tri_mask is not None:
                # Per-triangle participation mask (e.g. shadow rays skip
                # light geometry, matching the reference's IsLight pass-
                # through in shadow feelers, kernel.glsl:1474-1477).
                hit = hit & tri_mask[tri_ids]
            t = jnp.where(leaf_mask[:, None] & hit, t, BIG)
            k_best = jnp.argmin(t, axis=1)
            t_k = t[rows, k_best]
            better = t_k < t_best
            t_best = jnp.where(better, t_k, t_best)
            tri_best = jnp.where(better, tri_ids[rows, k_best], tri_best)
            u_best = jnp.where(better, uu[rows, k_best], u_best)
            v_best = jnp.where(better, vv[rows, k_best], v_best)
            occluded = occluded | jnp.any(t < BIG, axis=1)
            return t_best, tri_best, u_best, v_best, occluded

        t_best, tri_best, u_best, v_best, occluded = jax.lax.fori_loop(
            0, 8, leaf_slot,
            (s["t_best"], s["tri_best"], s["u_best"], s["v_best"],
             s["occluded"]),
        )

        return dict(
            stack=stack, sp=sp_new, t_best=t_best, tri_best=tri_best,
            u_best=u_best, v_best=v_best, occluded=occluded,
            box_tests=box_tests, tri_tests=tri_tests,
            step=s["step"] + 1,
        )

    out = jax.lax.while_loop(cond, body, state)

    if any_hit:
        return out["occluded"]
    miss = out["tri_best"] < 0
    return (
        jnp.where(miss, BIG, out["t_best"]),
        out["tri_best"],
        out["u_best"],
        out["v_best"],
        out["box_tests"] + out["tri_tests"],
    )
