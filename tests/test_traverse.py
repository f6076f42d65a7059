"""The lock-step wide-BVH traversal (trace/traverse.py) against the
exhaustive brute-force reference: closest hit and any hit, with and
without a per-triangle participation mask, at three scene sizes
(below, near and above the renderer's 2,048-triangle crossover)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tracerboy_tpu.accel.native import build_bvh_auto
from tracerboy_tpu.trace.intersect import BIG, ray_triangle
from tracerboy_tpu.trace.traverse import traverse_wide


def _soup(rng, n):
    base = (rng.random((n, 3), np.float32) - 0.5) * 12.0
    e1 = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    e2 = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    return base, base + e1, base + e2


def _brute(o, d, t_max, v0, v1, v2, mask):
    """(N, T) Moller-Trumbore reference: closest t/id and any-hit."""
    t, _, _, hit = ray_triangle(
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
        jnp.asarray(v0)[None], jnp.asarray(v1)[None], jnp.asarray(v2)[None],
        t_max=jnp.asarray(t_max)[:, None],
    )
    hit = np.asarray(hit) & mask[None, :]
    t = np.where(hit, np.asarray(t), np.float32(BIG))
    best = np.argmin(t, axis=1)
    t_best = t[np.arange(t.shape[0]), best]
    return t_best, np.where(t_best < BIG, best, -1), hit.any(axis=1)


@pytest.mark.parametrize("n_tris", [60, 2_000, 12_000])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_wide_matches_brute(n_tris, masked, any_hit):
    rng = np.random.default_rng(n_tris)
    v0, v1, v2 = _soup(rng, n_tris)
    mask = (rng.random(n_tris) > 0.3) if masked else np.ones(n_tris, bool)
    bvh = build_bvh_auto(v0, v1, v2, leaf_size=4)
    order = np.asarray(bvh.tri_order)
    n_rays = 512
    o = (rng.random((n_rays, 3), np.float32) - 0.5) * 20.0
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(n_rays) < 0.5, 1e30, 6.0).astype(np.float32)

    out = traverse_wide(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(bvh.bounds_lo), jnp.asarray(bvh.bounds_hi),
        jnp.asarray(bvh.children),
        jnp.asarray(v0[order]), jnp.asarray(v1[order]),
        jnp.asarray(v2[order]),
        leaf_size=4, any_hit=any_hit,
        tri_mask=jnp.asarray(mask[order]) if masked else None,
    )
    t_ref, id_ref, occ_ref = _brute(o, d, t_max, v0, v1, v2, mask)
    assert occ_ref.any() and not occ_ref.all()
    if any_hit:
        np.testing.assert_array_equal(np.asarray(out), occ_ref)
        return
    t, tri = np.asarray(out[0]), np.asarray(out[1])
    hit = tri >= 0
    np.testing.assert_array_equal(hit, id_ref >= 0)
    np.testing.assert_array_equal(order[tri[hit]], id_ref[hit])
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    assert np.all(t[~hit] == np.float32(BIG))
