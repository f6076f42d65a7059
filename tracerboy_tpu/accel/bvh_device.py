"""On-device LBVH build: morton -> lax.sort -> Karras -> fit -> collapse.

The reference builds its LBVH on the GPU each time geometry changes
(GpuBVH2Builder.cpp:167-280: scene AABB reduce -> morton codes ->
bitonic sort -> rearrange -> Karras splits -> bottom-up AABB fit ->
treelet reorder).  The host builder (accel/bvh.py) mirrors that pipeline
in vectorized numpy; THIS module is the fully on-device jnp equivalent —
one jit-able function from triangle vertices to the wide-BVH traversal
tables (trace/traverse.py), unlocking per-frame rebuilds for animated geometry with no host
round-trip.

Design notes (vs accel/bvh.py, same topology semantics):

- 32-bit only: morton codes are 30-bit (10 bits/axis, the reference's
  MortonCodesCalculator.cpp:36-60 precision) held in int32.  The host
  builder's 64-bit augmented sort key (code << 32 | index) becomes a
  TWO-key `lax.sort` and a pairwise common-prefix: if codes differ the
  prefix is clz32(code_i ^ code_j), else 32 + clz32(i ^ j) — identical
  ordering, no uint64 under default jax config.
- The depth-3 wide collapse is reformulated without the host builder's
  BFS dict: a wide root is EXACTLY an internal node whose depth is
  divisible by 3 (every slot expansion descends exactly 3 binary
  levels, so roots reproduce at depths 0, 3, 6, ...).  Depths come from
  a parent-pointer doubling sweep; wide ids from a cumsum over the
  depth%3==0 mask (the Karras root is internal node 0, so the root wide
  node is id 0 as the traversal kernels require).
- Static shapes: the wide-node table is padded to n_clusters rows (a
  safe bound on internal nodes); rows [0, W) are the live compacted
  nodes, the rest are never referenced.  For static scenes the caller
  can slice to the concrete W on host; for per-frame animated rebuilds
  the padding is the price of a fixed jit signature.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tracerboy_tpu.accel.bvh import INVALID, WIDE_FACTOR

LEAF = 8  # triangles per leaf cluster of a device rebuild


# ---------------------------------------------------------------------------
# Morton codes (30-bit, reference precision)
# ---------------------------------------------------------------------------

def _expand_bits10(v):
    """Spread the low 10 bits of uint32 v to every 3rd bit."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton30(qx, qy, qz):
    """(N,) uint32 10-bit coords -> 30-bit morton codes (int32)."""
    code = (
        (_expand_bits10(qx) << 2)
        | (_expand_bits10(qy) << 1)
        | _expand_bits10(qz)
    )
    return code.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Karras 2012 radix-tree topology (BuildBVHSplits.hlsli:11-141 semantics)
# ---------------------------------------------------------------------------

def _bit_length32(x):
    """Per-element bit length of non-negative int32."""
    x = x.astype(jnp.uint32)
    out = jnp.zeros(x.shape, jnp.int32)
    for shift in (16, 8, 4, 2, 1):
        mask = x >= (jnp.uint32(1) << jnp.uint32(shift))
        out = jnp.where(mask, out + shift, out)
        x = jnp.where(mask, x >> jnp.uint32(shift), x)
    out = out + (x > 0).astype(jnp.int32)
    return out


def _make_delta(codes, n):
    """delta(i, j): common-prefix length of augmented keys (code, index);
    -1 when j is out of range.  Matches the host builder's 64-bit
    (code << 32 | index) prefix ordering."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        jj = jnp.clip(j, 0, n - 1)
        ci = codes[jnp.clip(i, 0, n - 1)]
        cj = codes[jj]
        code_xor = ci ^ cj
        idx_xor = i ^ jj
        pfx = jnp.where(
            code_xor != 0,
            32 - _bit_length32(code_xor),
            64 - _bit_length32(idx_xor),
        )
        return jnp.where(valid, pfx, -1)

    return delta


def build_karras_topology_device(codes_sorted):
    """left/right child arrays ((n-1,) int32 each) of the binary radix
    tree over n sorted, tie-broken keys.  Children >= n-1 are leaves
    (leaf id = child - (n-1))."""
    n = codes_sorted.shape[0]
    assert n >= 2, "topology needs at least two leaves"
    delta = _make_delta(codes_sorted, n)
    i = jnp.arange(n - 1, dtype=jnp.int32)

    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Per-element exponential range growth (host builder's doubling
    # loop).  Out-of-range probes return -1 so growth self-limits at
    # lmax < 2n — no int32 overflow for any realistic cluster count.
    def grow_body(_, lmax):
        grow = delta(i, i + lmax * d) > delta_min
        return jnp.where(grow, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(
        0, 32, grow_body, jnp.full((n - 1,), 2, jnp.int32)
    )

    # Binary search for the exact range length l.
    def len_body(_, carry):
        l, t = carry
        probe = delta(i, i + (l + t) * d) > delta_min
        l = jnp.where((t > 0) & probe, l + t, l)
        return l, t // 2

    l, _ = jax.lax.fori_loop(
        0, 32, len_body, (jnp.zeros((n - 1,), jnp.int32), lmax // 2)
    )
    j = i + l * d
    delta_node = delta(i, j)

    # Split position search.
    def split_body(_, carry):
        s, t = carry
        probe = delta(i, i + (s + t) * d) > delta_node
        s = jnp.where((t > 0) & probe, s + t, s)
        return s, jnp.where(t > 1, (t + 1) // 2, 0)

    s, _ = jax.lax.fori_loop(
        0, 32, split_body, (jnp.zeros((n - 1,), jnp.int32), (l + 1) // 2)
    )
    gamma = i + s * d + jnp.minimum(d, 0)

    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    left = jnp.where(lo == gamma, gamma + (n - 1), gamma)
    right = jnp.where(hi == gamma + 1, gamma + 1 + (n - 1), gamma + 1)
    return left.astype(jnp.int32), right.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Bottom-up AABB fit (ConstructAABBPass analog)
# ---------------------------------------------------------------------------

def fit_aabbs_bottom_up_device(left, right, leaf_lo, leaf_hi):
    """(n_int, 3) node bounds via masked level sweeps (64 = radix-tree
    depth bound for tie-broken 30+index-bit keys)."""
    n_int = left.shape[0]
    n_leaf = leaf_lo.shape[0]

    def child_box(c, node_lo, node_hi, done):
        is_leaf = c >= n_int
        li = jnp.clip(jnp.where(is_leaf, c - n_int, 0), 0, n_leaf - 1)
        ii = jnp.clip(jnp.where(is_leaf, 0, c), 0, n_int - 1)
        lo = jnp.where(is_leaf[:, None], leaf_lo[li], node_lo[ii])
        hi = jnp.where(is_leaf[:, None], leaf_hi[li], node_hi[ii])
        ready = jnp.where(is_leaf, True, done[ii])
        return lo, hi, ready

    def body(_, carry):
        node_lo, node_hi, done = carry
        llo, lhi, lready = child_box(left, node_lo, node_hi, done)
        rlo, rhi, rready = child_box(right, node_lo, node_hi, done)
        can = lready & rready & ~done
        node_lo = jnp.where(can[:, None], jnp.minimum(llo, rlo), node_lo)
        node_hi = jnp.where(can[:, None], jnp.maximum(lhi, rhi), node_hi)
        return node_lo, node_hi, done | can

    node_lo = jnp.full((n_int, 3), jnp.inf, jnp.float32)
    node_hi = jnp.full((n_int, 3), -jnp.inf, jnp.float32)
    done = jnp.zeros((n_int,), bool)
    node_lo, node_hi, done = jax.lax.fori_loop(
        0, 64, body, (node_lo, node_hi, done)
    )
    return node_lo, node_hi


# ---------------------------------------------------------------------------
# Depth-3 wide collapse
# ---------------------------------------------------------------------------

def _node_depths(left, right):
    """Depth of every internal node via parent-pointer doubling."""
    n_int = left.shape[0]
    par = jnp.full((n_int,), -1, jnp.int32)
    i = jnp.arange(n_int, dtype=jnp.int32)
    # Internal children only; out-of-range scatter indices are dropped.
    par = par.at[jnp.where(left < n_int, left, n_int)].set(i, mode="drop")
    par = par.at[jnp.where(right < n_int, right, n_int)].set(i, mode="drop")

    depth = jnp.where(par >= 0, 1, 0).astype(jnp.int32)
    jump = jnp.where(par >= 0, par, i)  # root jumps to itself
    for _ in range(7):  # 2^7 = 128 >= max radix-tree depth (64)
        depth = depth + depth[jump]
        jump = jump[jump]
    return depth


def collapse_to_wide_device(left, right, node_lo, node_hi,
                            leaf_lo, leaf_hi, pad_nodes: int):
    """(pad_nodes, 8, 3) bounds + (pad_nodes, 8) children, rows [0, W)
    live.  Same slot semantics as the host collapse: children >= 0 are
    wide node ids, -(c+1) is leaf cluster c, INVALID is an empty slot."""
    n_int = left.shape[0]
    n_leaf = leaf_lo.shape[0]
    SENT = jnp.int32(-1) - n_leaf  # sentinel below any ~cluster encoding

    depth = _node_depths(left, right)
    wide_mask = (depth % 3) == 0
    wid = jnp.cumsum(wide_mask.astype(jnp.int32)) - 1  # root -> 0

    def expand(nodes):
        """(n_int, m) -> (n_int, 2m) one binary level down; leaves pass
        through in the left slot, SENT fills the right."""
        is_inner = (nodes >= 0) & (nodes < n_int)
        idx = jnp.clip(jnp.where(is_inner, nodes, 0), 0, n_int - 1)
        lch = jnp.where(is_inner, left[idx], nodes)
        rch = jnp.where(is_inner, right[idx], SENT)
        m = nodes.shape[1]
        out = jnp.stack([lch, rch], axis=2).reshape(nodes.shape[0], 2 * m)
        return out

    roots = jnp.arange(n_int, dtype=jnp.int32)[:, None]
    slots = expand(expand(expand(roots)))            # (n_int, 8)

    is_leaf = slots >= n_int
    is_valid = slots > SENT
    leaf_idx = jnp.clip(jnp.where(is_leaf, slots - n_int, 0), 0, n_leaf - 1)
    inner_idx = jnp.clip(jnp.where(is_valid & ~is_leaf, slots, 0),
                         0, n_int - 1)
    slot_children = jnp.where(
        is_leaf,
        -(leaf_idx + 1),
        jnp.where(is_valid, wid[inner_idx], jnp.int32(INVALID)),
    ).astype(jnp.int32)

    lo = jnp.where(
        is_leaf[..., None], leaf_lo[leaf_idx],
        jnp.where(is_valid[..., None], node_lo[inner_idx], jnp.inf),
    ).astype(jnp.float32)
    hi = jnp.where(
        is_leaf[..., None], leaf_hi[leaf_idx],
        jnp.where(is_valid[..., None], node_hi[inner_idx], -jnp.inf),
    ).astype(jnp.float32)

    rows = jnp.where(wide_mask, wid, pad_nodes)  # dropped when not wide
    b_lo = jnp.full((pad_nodes, WIDE_FACTOR, 3), jnp.inf, jnp.float32)
    b_hi = jnp.full((pad_nodes, WIDE_FACTOR, 3), -jnp.inf, jnp.float32)
    children = jnp.full((pad_nodes, WIDE_FACTOR), INVALID, jnp.int32)
    b_lo = b_lo.at[rows].set(lo, mode="drop")
    b_hi = b_hi.at[rows].set(hi, mode="drop")
    children = children.at[rows].set(slot_children, mode="drop")
    num_wide = jnp.sum(wide_mask.astype(jnp.int32))
    return b_lo, b_hi, children, num_wide


# ---------------------------------------------------------------------------
# Full build
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("leaf_size",))
def build_bvh_device(v0, v1, v2, leaf_size: int = LEAF):
    """Device-built 8-wide LBVH over (T, 3) triangle vertex arrays.

    Returns a dict pytree:
      bounds_lo/bounds_hi (C, 8, 3), children (C, 8) int32 (rows [0,
      num_wide) live), tri_order (C*leaf_size,) int32, num_wide scalar,
      world_lo/world_hi (3,).
    """
    v0 = jnp.asarray(v0, jnp.float32)
    v1 = jnp.asarray(v1, jnp.float32)
    v2 = jnp.asarray(v2, jnp.float32)
    T = v0.shape[0]
    C = (T + leaf_size - 1) // leaf_size

    centroid = (v0 + v1 + v2) * (1.0 / 3.0)
    scene_lo = jnp.minimum(jnp.minimum(v0, v1), v2).min(axis=0)
    scene_hi = jnp.maximum(jnp.maximum(v0, v1), v2).max(axis=0)
    extent = jnp.maximum(scene_hi - scene_lo, 1e-12)

    q = jnp.clip(
        (centroid - scene_lo) / extent * 1023.0, 0.0, 1023.0
    ).astype(jnp.uint32)
    codes = morton30(q[:, 0], q[:, 1], q[:, 2])

    idx = jnp.arange(T, dtype=jnp.int32)
    codes_sorted, order = jax.lax.sort((codes, idx), num_keys=2)

    pad = C * leaf_size - T
    order_padded = jnp.concatenate(
        [order, jnp.broadcast_to(order[-1:], (pad,))]
    ) if pad else order
    cl = order_padded.reshape(C, leaf_size)

    w0, w1, w2 = v0[cl], v1[cl], v2[cl]
    leaf_lo = jnp.minimum(jnp.minimum(w0, w1), w2).min(axis=1)
    leaf_hi = jnp.maximum(jnp.maximum(w0, w1), w2).max(axis=1)

    # Cluster key = first tri's morton code.  cl holds ORIGINAL tri ids,
    # so index the unsorted code array (bvh.py:329 does the same) — NOT
    # codes_sorted, whose order is positional.
    cl_codes = codes[cl[:, 0]]

    if C == 1:
        b_lo = jnp.full((1, WIDE_FACTOR, 3), jnp.inf, jnp.float32)
        b_hi = jnp.full((1, WIDE_FACTOR, 3), -jnp.inf, jnp.float32)
        b_lo = b_lo.at[0, 0].set(leaf_lo[0])
        b_hi = b_hi.at[0, 0].set(leaf_hi[0])
        children = jnp.full((1, WIDE_FACTOR), INVALID, jnp.int32)
        children = children.at[0, 0].set(-1)
        num_wide = jnp.int32(1)
    else:
        left, right = build_karras_topology_device(cl_codes)
        node_lo, node_hi = fit_aabbs_bottom_up_device(
            left, right, leaf_lo, leaf_hi
        )
        b_lo, b_hi, children, num_wide = collapse_to_wide_device(
            left, right, node_lo, node_hi, leaf_lo, leaf_hi, pad_nodes=C
        )

    return dict(
        bounds_lo=b_lo,
        bounds_hi=b_hi,
        children=children,
        tri_order=order_padded.astype(jnp.int32),
        num_wide=num_wide,
        world_lo=scene_lo,
        world_hi=scene_hi,
    )


def to_host_widebvh(built, num_tris: int, leaf_size: int = LEAF):
    """Materialize a device build as the host WideBVH dataclass (rows
    sliced to the concrete wide-node count) for the validators."""
    from tracerboy_tpu.accel.bvh import WideBVH

    W = int(built["num_wide"])
    return WideBVH(
        bounds_lo=np.asarray(built["bounds_lo"])[:W],
        bounds_hi=np.asarray(built["bounds_hi"])[:W],
        children=np.asarray(built["children"])[:W],
        tri_order=np.asarray(built["tri_order"]).astype(np.int64),
        leaf_size=leaf_size,
        num_tris=num_tris,
        world_lo=np.asarray(built["world_lo"]),
        world_hi=np.asarray(built["world_hi"]),
        num_clusters=built["tri_order"].shape[0] // leaf_size,
    )
