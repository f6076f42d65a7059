"""On-device LBVH builder tests (accel/bvh_device.py).

Oracle strategy per SURVEY.md section 4: structural validation with the
BVHValidator port (containment + reachability) plus closest-hit parity
against the brute-force intersector — the same bar the host builder
meets.  The device build need not be byte-identical to the host build
(wide ids are assigned in node order, not BFS order); it must be a
VALID tree that finds the same hits.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from tracerboy_tpu.accel.bvh import build_bvh
from tracerboy_tpu.accel.bvh_device import build_bvh_device, to_host_widebvh
from tracerboy_tpu.accel.validate import validate_bvh
from tracerboy_tpu.trace.intersect import BIG, brute_force_closest
from tracerboy_tpu.trace.traverse import traverse_wide


def random_soup(rng, n, spread=10.0, size=0.4):
    base = (rng.random((n, 3), np.float32) - 0.5) * spread
    e1 = rng.standard_normal((n, 3)).astype(np.float32) * size
    e2 = rng.standard_normal((n, 3)).astype(np.float32) * size
    return base, base + e1, base + e2


def make_rays(rng, n, spread=18.0):
    o = (rng.random((n, 3), np.float32) - 0.5) * spread
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def closest_via_tables(built, v0, v1, v2, o, d):
    order = np.asarray(built["tri_order"])
    w0 = jnp.asarray(v0[order])
    w1 = jnp.asarray(v1[order])
    w2 = jnp.asarray(v2[order])
    t, tri, u, v, _cost = traverse_wide(
        jnp.asarray(o), jnp.asarray(d),
        jnp.full((o.shape[0],), BIG, jnp.float32),
        built["bounds_lo"], built["bounds_hi"], built["children"],
        w0, w1, w2, leaf_size=8,
    )
    return np.asarray(t), np.asarray(tri)


@pytest.mark.parametrize("n_tris", [5, 300, 5000])
def test_device_build_valid_and_hit_parity(rng, n_tris):
    v0, v1, v2 = random_soup(rng, n_tris)
    built = build_bvh_device(jnp.asarray(v0), jnp.asarray(v1),
                             jnp.asarray(v2))
    bvh = to_host_widebvh(built, num_tris=n_tris)
    assert validate_bvh(bvh, v0, v1, v2) == []

    o, d = make_rays(rng, 2048)
    t, tri = closest_via_tables(built, v0, v1, v2, o, d)
    t_ref, _, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
    )
    t_ref = np.asarray(t_ref)
    hit = tri >= 0
    hit_ref = t_ref < BIG * 0.5
    assert not np.any(hit_ref & ~hit), "device-built BVH missed a hit"
    assert (hit == hit_ref).mean() > 0.999
    both = hit & hit_ref
    np.testing.assert_allclose(t[both], t_ref[both], rtol=1e-3, atol=1e-4)


def test_device_build_degenerate_common_centroid(rng):
    """All-identical morton codes exercise the index tie-break path."""
    n = 64
    base = np.zeros((n, 3), np.float32)
    e1 = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    e2 = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    v0, v1, v2 = base, base + e1, base + e2
    built = build_bvh_device(jnp.asarray(v0), jnp.asarray(v1),
                             jnp.asarray(v2))
    bvh = to_host_widebvh(built, num_tris=n)
    assert validate_bvh(bvh, v0, v1, v2) == []
    o, d = make_rays(rng, 512, spread=4.0)
    t, tri = closest_via_tables(built, v0, v1, v2, o, d)
    t_ref, _, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
    )
    t_ref = np.asarray(t_ref)
    hit_ref = t_ref < BIG * 0.5
    assert not np.any(hit_ref & (tri < 0))


def test_device_matches_host_topology_quality(rng):
    """Same leaf clustering (identical morton order modulo ties) — the
    device tri_order must equal the host builder's on tie-free input,
    and the wide-node count must be within the depth-3 cut's bound."""
    v0, v1, v2 = random_soup(rng, 1000)
    built = build_bvh_device(jnp.asarray(v0), jnp.asarray(v1),
                             jnp.asarray(v2))
    host = build_bvh(v0, v1, v2, leaf_size=8)
    np.testing.assert_array_equal(
        np.asarray(built["tri_order"]), np.asarray(host.tri_order)
    )
    W_dev = int(built["num_wide"])
    assert W_dev == host.num_nodes, (W_dev, host.num_nodes)


def test_single_cluster_scene(rng):
    v0, v1, v2 = random_soup(rng, 3)
    built = build_bvh_device(jnp.asarray(v0), jnp.asarray(v1),
                             jnp.asarray(v2))
    o, d = make_rays(rng, 256)
    t, tri = closest_via_tables(built, v0, v1, v2, o, d)
    t_ref, _, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
    )
    t_ref = np.asarray(t_ref)
    hit_ref = t_ref < BIG * 0.5
    assert not np.any(hit_ref & (tri < 0))


# ---------------------------------------------------------------------------
# The product animated-geometry path (Renderer.update_geometry)
# ---------------------------------------------------------------------------


def _cornell_renderer(size=(24, 24), traversal=None):
    import os

    import tests.conftest as c
    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.utils.config import default_output_settings

    path = c.require_scene("cornell-box/scene.pbrt")
    import dataclasses

    s = default_output_settings()
    s = s.replace(performance_settings=dataclasses.replace(
        s.performance_settings, max_bounces=2, use_blue_noise=False,
    ))
    old = os.environ.get("TB_TRAVERSAL")
    try:
        if traversal:
            os.environ["TB_TRAVERSAL"] = traversal
        return Renderer(path, settings=s, film_size=size)
    finally:
        if traversal:
            if old is None:
                os.environ.pop("TB_TRAVERSAL", None)
            else:
                os.environ["TB_TRAVERSAL"] = old


class TestUpdateGeometry:
    def test_identity_update_preserves_image(self):
        r = _cornell_renderer()
        r.render_sample()
        ref = np.asarray(r.resolve_radiance())
        sp = r.scene_pytree
        r.update_geometry(sp["tri_v0"], sp["tri_v1"], sp["tri_v2"],
                          normals=sp["tri_n0"])
        assert r.state.spp == 0  # history invalidated
        r.render_sample()
        np.testing.assert_allclose(
            np.asarray(r.resolve_radiance()), ref, atol=1e-5
        )

    def test_moved_geometry_changes_image(self):
        r = _cornell_renderer()
        r.render_sample()
        ref = np.asarray(r.resolve_radiance())
        sp = r.scene_pytree
        delta = jnp.asarray([0.35, 0.0, 0.0], jnp.float32)
        r.update_geometry(sp["tri_v0"] + delta, sp["tri_v1"] + delta,
                          sp["tri_v2"] + delta)
        r.render_sample()
        moved = np.asarray(r.resolve_radiance())
        assert np.isfinite(moved).all()
        assert np.abs(moved - ref).mean() > 1e-3

    @pytest.mark.parametrize("warp", ["shift", "twist"])
    def test_jnp_update_matches_brute(self, warp):
        """After an on-device rebuild (leaf-8 device LBVH, tables
        reordered by its leaf order), the lock-step BVH backend agrees
        with brute force on the deformed scene — the product animation
        loop with no host rebuild."""
        size = (16, 16)

        def deform(v):
            v = jnp.asarray(v)
            if warp == "shift":
                return v + jnp.asarray([0.0, 0.2, 0.0], jnp.float32)
            ang = 0.3 * v[:, 1:2]          # twist about +y with height
            c, s_ = jnp.cos(ang), jnp.sin(ang)
            return jnp.concatenate(
                [c * v[:, 0:1] + s_ * v[:, 2:3], v[:, 1:2],
                 -s_ * v[:, 0:1] + c * v[:, 2:3]], axis=1)

        imgs = {}
        for trav in ("brute", "jnp"):
            r = _cornell_renderer(size=size, traversal=trav)
            c = r.compiled
            r.update_geometry(deform(c.tri_v0), deform(c.tri_v1),
                              deform(c.tri_v2))
            r.render_sample()
            imgs[trav] = np.asarray(r.resolve_radiance())
            if trav == "jnp":
                assert r.leaf_size == 8
                assert r.wave_config().leaf_size == 8
        np.testing.assert_allclose(imgs["jnp"], imgs["brute"], atol=1e-4)

    def test_repeated_updates_take_compile_order(self):
        """Every call takes vertices in the compiled scene's order, even
        after an earlier rebuild reordered the device tables."""
        r = _cornell_renderer(size=(12, 12), traversal="jnp")
        c = r.compiled
        r.update_geometry(c.tri_v0 + 0.1, c.tri_v1 + 0.1, c.tri_v2 + 0.1)
        r.update_geometry(c.tri_v0, c.tri_v1, c.tri_v2)
        r.render_sample()
        back = np.asarray(r.resolve_radiance())
        ref = _cornell_renderer(size=(12, 12), traversal="brute")
        ref.update_geometry(c.tri_v0, c.tri_v1, c.tri_v2)  # flat normals
        ref.render_sample()
        np.testing.assert_allclose(
            back, np.asarray(ref.resolve_radiance()), atol=1e-4)

    def test_rejects_topology_change(self):
        r = _cornell_renderer()
        with pytest.raises(ValueError):
            r.update_geometry(np.zeros((3, 3)), np.zeros((3, 3)),
                              np.zeros((3, 3)))


class TestInstancedFlatten:
    """Object instances are composed into the flat triangle soup at
    compile time (one BVH; no TLAS/BLAS split)."""

    @staticmethod
    def _compile(tmp_path, grid):
        from tracerboy_tpu.scene.compile import compile_scene
        from tracerboy_tpu.scene.pbrt_parser import parse_pbrt

        insts = "".join(f"""
            AttributeBegin
            Translate {i * 3.0} 0 {j * 3.0 - 3.0}
            ObjectInstance "ball"
            AttributeEnd
            """ for i in range(grid) for j in range(grid))
        p = tmp_path / f"inst{grid}.pbrt"
        p.write_text(f"""
            Camera "perspective" "float fov" [55]
            Film "image" "integer xresolution" [24]
                 "integer yresolution" [16]
            WorldBegin
            LightSource "infinite" "rgb L" [1 1 1]
            Material "matte" "rgb Kd" [0.6 0.4 0.3]
            ObjectBegin "ball"
            Shape "sphere" "float radius" [1]
            ObjectEnd
            {insts}
            WorldEnd
        """)
        scene = parse_pbrt(str(p))
        assert len(scene.instances) == grid * grid
        return compile_scene(scene)

    def test_sixteen_instances_flatten(self, tmp_path):
        one = self._compile(tmp_path, 1)
        cs = self._compile(tmp_path, 4)
        assert cs.num_tris == 16 * one.num_tris
        lo = np.minimum(np.minimum(cs.tri_v0, cs.tri_v1), cs.tri_v2)
        hi = np.maximum(np.maximum(cs.tri_v0, cs.tri_v1), cs.tri_v2)
        np.testing.assert_allclose(lo.min(0), [-1, -1, -4], atol=1e-5)
        np.testing.assert_allclose(hi.max(0), [10, 1, 7], atol=1e-5)
        assert not hasattr(cs, "inst_tables")
