"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracerboy_tpu.parallel.sharding import (
    make_mesh,
    render_spp_sharded,
    render_wave_tiled,
    shard_pixels,
)
from tracerboy_tpu.scene.compile import load_scene
from tracerboy_tpu.trace.wavefront import WaveConfig, render_wave


@pytest.fixture(scope="module")
def small_scene():
    import tests.conftest as c

    path = c.require_scene("cornell-box/scene.pbrt")
    cs = load_scene(path, use_cache=False, film_size=(32, 32))
    cfg = WaveConfig(
        width=32, height=32, max_bounces=3, leaf_size=cs.leaf_size,
        num_lights=cs.num_lights, has_env=cs.has_env,
        use_blue_noise=False, traversal="brute",
    )
    params = dict(
        dof_focus=jnp.float32(0.0), dof_aperture=jnp.float32(0.0),
        firefly_clamp=jnp.float32(0.0), seed=jnp.int32(0),
    )
    return cs.as_pytree(), cfg, params


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_tiled_matches_single_device(small_scene):
    scene, cfg, params = small_scene
    mesh = make_mesh()
    pixel_ids, pad = shard_pixels(mesh, 32, 32)
    out = render_wave_tiled(mesh, scene, params, pixel_ids, jnp.int32(0), cfg)
    tiled = np.asarray(out["radiance"])[: 32 * 32]

    single = np.asarray(
        render_wave(scene, params, jnp.arange(32 * 32, dtype=jnp.int32),
                    jnp.int32(0), cfg)["radiance"]
    )
    np.testing.assert_allclose(tiled, single, atol=1e-5)


def test_spp_sharded_matches_sequential(small_scene):
    """psum-merged multi-device accumulation == sum of sequential waves."""
    scene, cfg, params = small_scene
    mesh = make_mesh()
    ids = jnp.arange(32 * 32, dtype=jnp.int32)
    rad_sh, fw_sh, rays_sh = render_spp_sharded(
        mesh, scene, params, ids, jnp.int32(0), cfg, samples_per_device=1
    )
    rad_seq = jnp.zeros_like(rad_sh)
    fw_seq = jnp.zeros_like(fw_sh)
    for dev in range(8):
        out = render_wave(scene, params, ids, jnp.int32(dev), cfg)
        rad_seq = rad_seq + out["radiance"]
        fw_seq = fw_seq + out["filter_weight"]
    np.testing.assert_allclose(
        np.asarray(rad_sh), np.asarray(rad_seq), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(fw_sh), np.asarray(fw_seq), rtol=1e-5, atol=1e-5
    )
    assert float(rays_sh) > 0


def test_tiled_nondivisible_padding(small_scene):
    """Pixel counts that don't divide the mesh get padded lanes; padded
    output must not pollute the real pixels."""
    scene, cfg, params = small_scene
    import dataclasses

    W, H = 30, 19  # 570 pixels, not divisible by 8
    cfg = dataclasses.replace(cfg, width=W, height=H)
    mesh = make_mesh()
    pixel_ids, pad = shard_pixels(mesh, W, H)
    assert pad == (-W * H) % 8 and pad > 0
    out = render_wave_tiled(mesh, scene, params, pixel_ids, jnp.int32(0), cfg)
    tiled = np.asarray(out["radiance"])[: W * H]
    single = np.asarray(
        render_wave(scene, params, jnp.arange(W * H, dtype=jnp.int32),
                    jnp.int32(0), cfg)["radiance"]
    )
    np.testing.assert_allclose(tiled, single, atol=1e-5)


@pytest.fixture(scope="module")
def cornell_path():
    import tests.conftest as c

    return c.require_scene("cornell-box/scene.pbrt")


def _mini_renderer(cornell_path, shard, size=(32, 32), **kw):
    import dataclasses

    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.utils.config import default_output_settings

    s = default_output_settings()
    s = s.replace(performance_settings=dataclasses.replace(
        s.performance_settings, max_bounces=3, use_blue_noise=True,
    ))
    return Renderer(cornell_path, settings=s, film_size=size,
                    shard=shard, **kw)


class TestRendererSharding:
    """The PRODUCT multi-chip path: Renderer(shard=...) end to end."""

    @pytest.mark.smoke
    @pytest.mark.slow
    def test_tiles_matches_single_device(self, cornell_path):
        r_ref = _mini_renderer(cornell_path, shard=None)
        r_ref.render_sample()
        ref = np.asarray(r_ref.resolve_radiance())

        r = _mini_renderer(cornell_path, shard="tiles")
        assert r.mesh.devices.size == 8
        r.render_sample()
        assert r.state.spp == 1
        got = np.asarray(r.resolve_radiance())
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_spp_sharded_matches_sequential_renderer(self, cornell_path):
        """8 devices x 1 sample == the same 8 samples traced serially:
        the sharded accumulator must be bit-equivalent modulo float
        reduction order."""
        r = _mini_renderer(cornell_path, shard="spp")
        r.render_sample(8)          # one step: 8 devices x 1 sample
        assert r.state.spp == 8
        got = np.asarray(r.resolve_radiance())

        r_ref = _mini_renderer(cornell_path, shard=None)
        for _ in range(8):
            r_ref.render_sample()   # serial samples 0..7
        ref = np.asarray(r_ref.resolve_radiance())
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    def test_spp_rounds_up_to_mesh_multiple(self, cornell_path):
        r = _mini_renderer(cornell_path, shard="spp")
        r.render_sample(3)
        assert r.state.spp == 8

    @pytest.mark.slow
    def test_tiles_nondivisible_film(self, cornell_path):
        """30x19 = 570 pixels pads to the mesh; padded lanes must not
        pollute the accumulator."""
        r = _mini_renderer(cornell_path, shard="tiles", size=(30, 19))
        r.render_sample()
        r_ref = _mini_renderer(cornell_path, shard=None, size=(30, 19))
        r_ref.render_sample()
        np.testing.assert_allclose(
            np.asarray(r.resolve_radiance()),
            np.asarray(r_ref.resolve_radiance()), atol=1e-5,
        )

    def test_tiles_feeds_display(self, cornell_path):
        r = _mini_renderer(cornell_path, shard="tiles")
        r.render_sample(2)
        img = r.current_image()
        assert img.shape == (32, 32, 3)
        assert np.isfinite(img).all() and img.mean() > 0

    def test_cli_sharded_render(self, cornell_path, tmp_path):
        from tracerboy_tpu.app.cli import main

        out = tmp_path / "sharded.png"
        rc = main([cornell_path, "--spp", "8", "--shard", "spp",
                   "--size", "24x24", "--max-bounces", "2",
                   "--out", str(out), "-q"])
        assert rc == 0 and out.exists()


def test_sharded_accumulation_feeds_post_pipeline(small_scene):
    """End to end: spp-sharded accumulators -> weighted resolve ->
    display transform, the full multi-chip progressive loop."""
    scene, cfg, params = small_scene
    from tracerboy_tpu.post.pipeline import display_transform

    mesh = make_mesh()
    ids = jnp.arange(32 * 32, dtype=jnp.int32)
    rad = jnp.zeros((32 * 32, 3), jnp.float32)
    fw = jnp.zeros((32 * 32,), jnp.float32)
    for step in range(2):
        r, f, _ = render_spp_sharded(
            mesh, scene, params, ids, jnp.int32(step * 8), cfg,
            samples_per_device=1,
        )
        rad = rad + r
        fw = fw + f
    resolved = (rad / jnp.maximum(fw, 1e-8)[:, None]).reshape(32, 32, 3)
    img = np.asarray(display_transform(resolved, 1.0, 0, True, False))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert 0.0 < img.mean() < 1.0
