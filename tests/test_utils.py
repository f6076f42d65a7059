"""Utility module tests: gather, profiling, checkpoint, config."""

import numpy as np
import jax.numpy as jnp
import pytest

from tracerboy_tpu.shade.surface import _take_cols
from tracerboy_tpu.utils.config import (
    default_output_settings,
    invalidates_history,
)
from tracerboy_tpu.utils.profiling import FrameStats, scope


def _one_hot_cols(table_t, idx):
    """The one-hot product formula the column lookups replace, in f64:
    (k, M) @ one_hot(idx) (M, N)."""
    t = np.asarray(table_t, np.float64)
    oh = (np.arange(t.shape[1])[:, None] == np.asarray(idx)[None, :])
    return t @ oh.astype(np.float64)


class TestGather:
    """Material/light table lookups are plain gathers; they must equal
    the one-hot product formula exactly, integer-valued columns (flags,
    texture ids, light types) included."""

    def test_one_hot_matches_take_float(self, rng):
        table_t = jnp.asarray(rng.random((21, 8)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, 8, 100).astype(np.int32))
        np.testing.assert_array_equal(
            np.asarray(_take_cols(table_t, idx)),
            _one_hot_cols(table_t, idx).astype(np.float32),
        )

    def test_one_hot_matches_take_int(self, rng):
        # Integer columns ride the f32 table (|v| < 2^24 is exact).
        ints = rng.integers(-4, 1 << 20, (3, 16)).astype(np.float32)
        table_t = jnp.asarray(ints)
        idx = jnp.asarray(rng.integers(0, 16, 64).astype(np.int32))
        got = np.asarray(_take_cols(table_t, idx))
        np.testing.assert_array_equal(got, _one_hot_cols(ints, idx))
        np.testing.assert_array_equal(
            np.round(got).astype(np.int32), got.astype(np.int32))

    def test_large_table_falls_back_to_gather(self, rng):
        table_t = jnp.asarray(rng.random((2, 1000)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, 1000, 32).astype(np.int32))
        np.testing.assert_array_equal(
            np.asarray(_take_cols(table_t, idx)),
            np.asarray(table_t)[:, np.asarray(idx)],
        )

    @pytest.mark.parametrize("has_mix", [False, True])
    def test_material_fetch_matches_one_hot(self, rng, has_mix):
        """fetch_material_soa's gathered record equals the one-hot
        formula on the shadertoy scene's material table."""
        from tracerboy_tpu.scene.compile import load_scene
        from tracerboy_tpu.shade.surface import (
            _mat_table_t,
            fetch_material_soa,
        )

        scene = load_scene("shadertoy", film_size=(8, 8)).as_pytree()
        M = scene["materials"]["flags"].shape[0]
        mid = jnp.asarray(rng.integers(0, M, 257).astype(np.int32))
        mat = fetch_material_soa(
            scene, mid, jnp.zeros(257), jnp.zeros(257),
            jnp.zeros(257, bool), jnp.arange(257), jnp.int32(0), 0,
            has_mix=has_mix, has_textures=False,
        )
        ref = _one_hot_cols(_mat_table_t(scene["materials"]), mid)
        np.testing.assert_array_equal(
            np.asarray(mat["ior"]), ref[6].astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(mat["flags"]), np.round(ref[15]).astype(np.int32))

    def test_light_rows_match_one_hot(self, rng):
        from tracerboy_tpu.scene.compile import load_scene
        from tracerboy_tpu.shade.nee import _light_rows, _light_table_t

        scene = load_scene("shadertoy:cornell", film_size=(8, 8))
        lights = {k: jnp.asarray(v) for k, v in scene.lights.items()}
        L = scene.num_lights
        idx = jnp.asarray(rng.integers(0, L, 99).astype(np.int32))
        rows = _light_rows(lights, idx)
        ref = _one_hot_cols(_light_table_t(lights), idx)
        np.testing.assert_array_equal(
            np.asarray(rows["color"]), ref[18:21].T.astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(rows["ltype"]), np.round(ref[22]).astype(np.int32))


class TestConfig:
    def test_post_changes_keep_history(self):
        import dataclasses

        s = default_output_settings()
        s2 = s.replace(post_settings=dataclasses.replace(
            s.post_settings, exposure_multiplier=2.0))
        assert not invalidates_history(s, s2)

    def test_camera_changes_invalidate(self):
        import dataclasses

        s = default_output_settings()
        s2 = s.replace(camera_settings=dataclasses.replace(
            s.camera_settings, dof_focus_distance=3.0))
        assert invalidates_history(s, s2)

    def test_bounce_change_invalidates(self):
        import dataclasses

        s = default_output_settings()
        s2 = s.replace(performance_settings=dataclasses.replace(
            s.performance_settings, max_bounces=3))
        assert invalidates_history(s, s2)


class TestProfiling:
    def test_frame_stats(self):
        import time

        fs = FrameStats(window=4)
        for _ in range(3):
            with fs.time_pass("trace"):
                time.sleep(0.002)
        fs.add_counter("rays", 1e6)
        assert fs.mean_ms("trace") >= 1.0
        assert fs.mean_counter("rays") == 1e6
        assert "trace" in fs.summary() and "rays" in fs.summary()

    def test_scope_nests(self):
        with scope("outer"):
            with scope("inner"):
                x = jnp.sum(jnp.arange(4.0))
        assert float(x) == 6.0


class TestCheckpoint:
    def test_resolution_mismatch_rejected(self, tmp_path):
        import tests.conftest as c
        from tracerboy_tpu import Renderer
        from tracerboy_tpu.utils.checkpoint import (
            load_render_checkpoint,
            save_render_checkpoint,
        )

        path = c.require_scene("cornell-box/scene.pbrt")
        r1 = Renderer(path, film_size=(16, 12))
        r1.render_sample(2)
        ck = str(tmp_path / "ck.npz")
        save_render_checkpoint(ck, r1)

        r2 = Renderer(path, film_size=(32, 24))
        assert not load_render_checkpoint(ck, r2)  # shape mismatch
        r3 = Renderer(path, film_size=(16, 12))
        assert load_render_checkpoint(ck, r3)
        assert r3.state.spp == 2
        np.testing.assert_array_equal(
            np.asarray(r3.state.accum), np.asarray(r1.state.accum)
        )


class TestSceneFacts:
    """The static scene facts that specialize render_wave's jit must
    match what each scene actually contains (wrong facts silently
    compile out shading paths)."""

    def test_cornell_facts(self):
        from tracerboy_tpu.renderer import Renderer

        r = Renderer("shadertoy:cornell", film_size=(32, 32))
        cfg = r.wave_config()
        assert not cfg.has_textures
        assert not cfg.has_image_tex
        assert not cfg.has_alpha
        assert not cfg.has_volume
        assert cfg.num_lights > 0
        assert cfg.traversal == "brute"

    def test_teapot_facts(self):
        """The procedural benchmark scene (spheres over a checker floor
        under an env dome): textured, env-lit, above the brute-force
        crossover."""
        from tracerboy_tpu.renderer import Renderer

        r = Renderer("shadertoy", film_size=(32, 32))
        cfg = r.wave_config()
        assert cfg.has_textures          # checker floor
        assert not cfg.has_image_tex     # procedural only
        assert not cfg.has_scale_tex
        assert not cfg.has_emissive_tex
        assert cfg.has_env
        assert cfg.traversal == "jnp"


def test_checkpoint_realtime_history_roundtrip(tmp_path):
    """Round-3 scope: the RealTime temporal history (TAA color/moment/
    indirect, raw, AOVs) and governor pad survive checkpoint/resume, so
    a resumed RealTime session keeps its converged history."""
    import dataclasses

    import tests.conftest as c
    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.utils.checkpoint import (
        load_render_checkpoint,
        save_render_checkpoint,
    )
    from tracerboy_tpu.utils.config import RenderMode

    scene = c.require_scene("cornell-box/scene.pbrt")
    r1 = Renderer(scene, film_size=(16, 16))
    r1.settings = dataclasses.replace(
        r1.settings, render_mode=RenderMode.REAL_TIME
    )
    for _ in range(3):
        r1.render_realtime_frame_fused()
    ck = str(tmp_path / "rt.npz")
    save_render_checkpoint(ck, r1)

    r2 = Renderer(scene, film_size=(16, 16))
    r2.settings = dataclasses.replace(
        r2.settings, render_mode=RenderMode.REAL_TIME
    )
    r2.render_realtime_frame_fused()   # create same-shaped history
    assert load_render_checkpoint(ck, r2)
    assert r2.state.spp == r1.state.spp
    h1 = r1._rt_hist_fused
    h2 = r2._rt_hist_fused
    np.testing.assert_allclose(
        np.asarray(h2["final"]), np.asarray(h1["final"]), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(h2["moments"]), np.asarray(h1["moments"]), rtol=1e-6
    )


def test_checkpoint_realtime_lazy_resume(tmp_path):
    """A checkpoint with RealTime history loads into a FRESH renderer
    (no prior warmup frame): the pending path restores the history on
    the first fused frame instead of silently dropping it."""
    import dataclasses

    import tests.conftest as c
    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.utils.checkpoint import (
        load_render_checkpoint,
        save_render_checkpoint,
    )
    from tracerboy_tpu.utils.config import RenderMode

    scene = c.require_scene("cornell-box/scene.pbrt")
    r1 = Renderer(scene, film_size=(16, 16))
    r1.settings = dataclasses.replace(
        r1.settings, render_mode=RenderMode.REAL_TIME
    )
    for _ in range(3):
        r1.render_realtime_frame_fused()
    hist_saved = np.asarray(r1._rt_hist_fused["final"])
    ck = str(tmp_path / "rt.npz")
    save_render_checkpoint(ck, r1)

    r2 = Renderer(scene, film_size=(16, 16))
    r2.settings = dataclasses.replace(
        r2.settings, render_mode=RenderMode.REAL_TIME
    )
    assert load_render_checkpoint(ck, r2)   # no history template yet
    assert getattr(r2, "_rt_checkpoint_pending", None) is not None
    # Frame 4 on BOTH renderers from the same restored history must agree.
    img1 = r1.render_realtime_frame_fused(as_numpy=True)
    img2 = r2.render_realtime_frame_fused(as_numpy=True)
    assert getattr(r2, "_rt_checkpoint_pending", None) is None
    np.testing.assert_allclose(img2, img1, rtol=1e-5, atol=1e-6)
    del hist_saved


def test_checkpoint_legacy_scalar_diffuse_contrib(tmp_path):
    """Checkpoints written before the diffuse_contrib history grew from
    (H, W) to (H, W, 3) still restore (the scalar plane broadcasts)."""
    import dataclasses

    import tests.conftest as c
    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.utils.checkpoint import (
        _flatten_tree,
        _unflatten_tree,
    )
    from tracerboy_tpu.utils.config import RenderMode

    scene = c.require_scene("cornell-box/scene.pbrt")
    r = Renderer(scene, film_size=(16, 16))
    r.settings = dataclasses.replace(
        r.settings, render_mode=RenderMode.REAL_TIME
    )
    r.render_realtime_frame_fused()
    hist = r._rt_hist_fused
    legacy = dict(hist)
    legacy["aovs"] = dict(hist["aovs"])
    legacy["aovs"]["diffuse_contrib"] = (
        np.asarray(hist["aovs"]["diffuse_contrib"])[..., 0])
    flat = {}
    _flatten_tree("rt_hist", legacy, flat)
    np.savez(str(tmp_path / "legacy.npz"), **flat)
    z = np.load(str(tmp_path / "legacy.npz"))
    restored = _unflatten_tree("rt_hist", hist, z)
    assert restored is not None
    dc = np.asarray(restored["aovs"]["diffuse_contrib"])
    assert dc.shape == np.asarray(hist["aovs"]["diffuse_contrib"]).shape
    np.testing.assert_allclose(dc[..., 0], dc[..., 1])
