"""BVH builder + traversal tests: validator checks and brute-force parity."""

import numpy as np
import jax.numpy as jnp
import pytest

from tracerboy_tpu.accel.bvh import build_bvh, morton3d
from tracerboy_tpu.accel.validate import validate_bvh
from tracerboy_tpu.trace.intersect import brute_force_closest, brute_force_anyhit, BIG
from tracerboy_tpu.trace.traverse import traverse_wide


def random_tris(rng, n, spread=10.0, size=0.5):
    base = (rng.random((n, 3)) - 0.5) * spread
    e1 = rng.normal(size=(n, 3)) * size
    e2 = rng.normal(size=(n, 3)) * size
    return (
        base.astype(np.float32),
        (base + e1).astype(np.float32),
        (base + e2).astype(np.float32),
    )


def padded_tris(bvh, v0, v1, v2):
    return v0[bvh.tri_order], v1[bvh.tri_order], v2[bvh.tri_order]


class TestMorton:
    def test_ordering_locality(self):
        # Codes of identical coords are equal; nearby coords share prefixes
        c1 = morton3d(np.array([0]), np.array([0]), np.array([0]))
        c2 = morton3d(np.array([1023]), np.array([1023]), np.array([1023]))
        assert int(c1[0]) == 0
        assert int(c2[0]) == 2**30 - 1

    def test_interleave_axes(self):
        x = morton3d(np.array([1]), np.array([0]), np.array([0]))
        y = morton3d(np.array([0]), np.array([1]), np.array([0]))
        z = morton3d(np.array([0]), np.array([0]), np.array([1]))
        assert {int(x[0]), int(y[0]), int(z[0])} == {1, 2, 4}


class TestBuilder:
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1000])
    def test_validates(self, rng, n):
        v0, v1, v2 = random_tris(rng, n)
        bvh = build_bvh(v0, v1, v2, leaf_size=4)
        errs = validate_bvh(bvh, v0, v1, v2)
        assert errs == [], errs

    def test_duplicate_centroids(self, rng):
        # Degenerate case: all triangles at the same place (tie-broken keys)
        v0 = np.zeros((33, 3), np.float32)
        v1 = np.tile(np.array([[1, 0, 0]], np.float32), (33, 1))
        v2 = np.tile(np.array([[0, 1, 0]], np.float32), (33, 1))
        bvh = build_bvh(v0, v1, v2, leaf_size=4)
        assert validate_bvh(bvh, v0, v1, v2) == []

    def test_tri_order_is_permutation(self, rng):
        v0, v1, v2 = random_tris(rng, 500)
        bvh = build_bvh(v0, v1, v2, leaf_size=4)
        assert sorted(set(bvh.tri_order[:500].tolist())) == list(range(500))

    def test_cornell_box_scene(self):
        from tests.conftest import require_scene
        from tracerboy_tpu.scene.pbrt_parser import parse_pbrt
        from tracerboy_tpu.scene.types import TriangleMeshIR

        path = require_scene("cornell-box/scene.pbrt")
        scene = parse_pbrt(path)
        tris = []
        for s in scene.all_shapes():
            if isinstance(s, TriangleMeshIR):
                p = s.positions @ s.transform[:3, :3].T + s.transform[:3, 3]
                tris.append(p[s.indices])
        tri = np.concatenate(tris).astype(np.float32)
        bvh = build_bvh(tri[:, 0], tri[:, 1], tri[:, 2])
        assert validate_bvh(bvh, tri[:, 0], tri[:, 1], tri[:, 2]) == []


class TestTraversal:
    @pytest.mark.parametrize("n_tris,leaf", [(9, 2), (257, 4), (1000, 8)])
    def test_matches_brute_force(self, rng, n_tris, leaf):
        v0, v1, v2 = random_tris(rng, n_tris)
        bvh = build_bvh(v0, v1, v2, leaf_size=leaf)
        p0, p1, p2 = padded_tris(bvh, v0, v1, v2)

        n_rays = 256
        orig = (rng.random((n_rays, 3)).astype(np.float32) - 0.5) * 30
        target = (rng.random((n_rays, 3)).astype(np.float32) - 0.5) * 8
        d = target - orig
        d = d / np.linalg.norm(d, axis=1, keepdims=True)

        t_ref, tri_ref, _, _ = brute_force_closest(
            jnp.asarray(orig), jnp.asarray(d),
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
        )
        t_bvh, tri_bvh, _, _, cost = traverse_wide(
            jnp.asarray(orig), jnp.asarray(d), jnp.full((n_rays,), 1e30),
            jnp.asarray(bvh.bounds_lo), jnp.asarray(bvh.bounds_hi),
            jnp.asarray(bvh.children),
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
            leaf_size=leaf,
        )
        t_ref = np.asarray(t_ref)
        t_bvh = np.asarray(t_bvh)
        hit_ref = t_ref < BIG
        hit_bvh = np.asarray(tri_bvh) >= 0
        np.testing.assert_array_equal(hit_bvh, hit_ref)
        np.testing.assert_allclose(t_bvh[hit_bvh], t_ref[hit_ref], rtol=1e-4)
        # hit triangles must agree (tri ids are permuted; compare via t only
        # except exact duplicates — t equality is the functional contract)

    def test_anyhit_matches(self, rng):
        v0, v1, v2 = random_tris(rng, 300)
        bvh = build_bvh(v0, v1, v2, leaf_size=4)
        p0, p1, p2 = padded_tris(bvh, v0, v1, v2)
        n_rays = 128
        orig = (rng.random((n_rays, 3)).astype(np.float32) - 0.5) * 30
        d = rng.normal(size=(n_rays, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_max = np.full((n_rays,), 15.0, np.float32)

        occ_ref = brute_force_anyhit(
            jnp.asarray(orig), jnp.asarray(d),
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
            jnp.asarray(t_max),
        )
        occ_bvh = traverse_wide(
            jnp.asarray(orig), jnp.asarray(d), jnp.asarray(t_max),
            jnp.asarray(bvh.bounds_lo), jnp.asarray(bvh.bounds_hi),
            jnp.asarray(bvh.children),
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
            leaf_size=4, any_hit=True,
        )
        np.testing.assert_array_equal(np.asarray(occ_bvh), np.asarray(occ_ref))

    def test_miss_everything(self, rng):
        v0, v1, v2 = random_tris(rng, 50)
        bvh = build_bvh(v0, v1, v2)
        p0, p1, p2 = padded_tris(bvh, v0, v1, v2)
        orig = np.full((8, 3), 100.0, np.float32)
        d = np.tile(np.array([[1.0, 0, 0]], np.float32), (8, 1))
        t, tri, _, _, _ = traverse_wide(
            jnp.asarray(orig), jnp.asarray(d), jnp.full((8,), 1e30),
            jnp.asarray(bvh.bounds_lo), jnp.asarray(bvh.bounds_hi),
            jnp.asarray(bvh.children),
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
            leaf_size=4,
        )
        assert np.all(np.asarray(tri) == -1)


class TestWatertight:
    """Woop/Benthin/Wald watertight test (TraverseFunction.hlsli:232-313)."""

    def test_agrees_with_moller_trumbore(self):
        from tracerboy_tpu.trace.intersect import (
            ray_triangle,
            ray_triangle_watertight,
        )

        rng = np.random.default_rng(3)
        n = 512
        v0, v1, v2 = random_tris(rng, n, spread=4.0, size=1.0)
        # Rays aimed at triangle interiors (guaranteed hits) plus random
        # rays (mostly misses).
        b1 = rng.random(n, dtype=np.float32) * 0.8 + 0.1
        b2 = (1 - b1) * (rng.random(n, dtype=np.float32) * 0.8 + 0.1)
        target = v0 * (1 - b1 - b2)[:, None] + v1 * b1[:, None] + v2 * b2[:, None]
        o = (rng.random((n, 3), dtype=np.float32) - 0.5) * 20
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        t_mt, u_mt, v_mt, h_mt = ray_triangle(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
        )
        t_wt, u_wt, v_wt, h_wt = ray_triangle_watertight(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
        )
        h_mt = np.asarray(h_mt)
        h_wt = np.asarray(h_wt)
        # Away from edges the two tests agree exactly on hit/miss.
        assert (h_mt == h_wt).mean() > 0.999
        both = h_mt & h_wt
        assert both.sum() > n // 2  # the aimed rays hit
        np.testing.assert_allclose(
            np.asarray(t_wt)[both], np.asarray(t_mt)[both], rtol=2e-3,
            atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(u_wt)[both], np.asarray(u_mt)[both], atol=2e-3)
        np.testing.assert_allclose(
            np.asarray(v_wt)[both], np.asarray(v_mt)[both], atol=2e-3)

    def test_no_cracks_on_shared_edge(self):
        """Rays through points exactly on a quad's shared diagonal must
        hit one of the two triangles — the watertight property."""
        from tracerboy_tpu.trace.intersect import brute_force_closest

        # Unit quad split along the diagonal (0,0)-(1,1), z = 0.
        a = np.array([0, 0, 0], np.float32)
        b = np.array([1, 0, 0], np.float32)
        c = np.array([1, 1, 0], np.float32)
        dd = np.array([0, 1, 0], np.float32)
        v0 = np.stack([a, a])
        v1 = np.stack([b, c])
        v2 = np.stack([c, dd])

        # Points on the diagonal, including awkward fractions; rays from
        # a skewed origin so the shear axes differ per ray.
        s = np.linspace(0.001, 0.999, 997, dtype=np.float32)
        pts = np.stack([s, s, np.zeros_like(s)], axis=1)
        o = np.array([[0.3, -0.2, 5.0]], np.float32) + np.array(
            [[0.1, 0.05, 0.0]], np.float32
        ) * s[:, None]
        d = pts - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        t, tri, _, _ = brute_force_closest(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
            watertight=True,
        )
        misses = int((np.asarray(tri) < 0).sum())
        assert misses == 0, f"{misses} cracks on the shared edge"

    def test_shared_vertex_fan(self):
        """Rays through the apex shared by a fan of triangles hit it."""
        from tracerboy_tpu.trace.intersect import brute_force_closest

        apex = np.array([0.5, 0.5, 0.0], np.float32)
        k = 8
        ang = np.linspace(0, 2 * np.pi, k + 1)
        ring = np.stack(
            [0.5 + np.cos(ang), 0.5 + np.sin(ang), np.zeros(k + 1)], axis=1
        ).astype(np.float32)
        v0 = np.broadcast_to(apex, (k, 3)).copy()
        v1 = ring[:-1]
        v2 = ring[1:]

        o = np.tile(np.array([[1.7, -2.1, 7.0]], np.float32), (64, 1))
        o += np.linspace(0, 0.3, 64, dtype=np.float32)[:, None] * np.array(
            [[0.5, 1.0, 0.0]], np.float32
        )
        d = apex - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t, tri, _, _ = brute_force_closest(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
            watertight=True,
        )
        assert int((np.asarray(tri) < 0).sum()) == 0
