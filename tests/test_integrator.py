"""Integrator correctness tests: exact analytic cases + consistency.

The reference ships no integrator tests; these are the energy-conservation
and estimator-consistency checks SURVEY.md section 4 prescribes for the
rebuild.
"""

import textwrap

import numpy as np
import pytest

from tracerboy_tpu import Renderer
from tracerboy_tpu.utils.config import default_output_settings


def write_scene(tmp_path, body, name="scene.pbrt"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


PLANE_UNDER_SKY = """
    LookAt 0 5 0  0 0 0  0 0 1
    Camera "perspective" "float fov" [ 30 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 32 ]
    Integrator "path" "integer maxdepth" [ 4 ]
    WorldBegin
    LightSource "infinite" "rgb L" [ 1 1 1 ]
    Material "matte" "rgb Kd" [ 0.3 0.5 0.7 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -50 0 -50  50 0 -50  50 0 50  -50 0 50 ]
    WorldEnd
"""


class TestAnalytic:
    def test_lambert_under_uniform_sky_equals_albedo(self, tmp_path):
        """A lambertian plane under a uniform unit sky reflects exactly its
        albedo: L_out = a/pi * integral(cos) = a. With cosine sampling the
        estimator is zero-variance, so even 4 spp must match closely."""
        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)
        r.render_sample(4)
        img = np.asarray(r.resolve_radiance())
        center = img[8:24, 8:24]  # stay away from plane edges
        np.testing.assert_allclose(
            center.mean(axis=(0, 1)), [0.3, 0.5, 0.7], atol=0.01
        )

    def test_camera_sees_light_radiance_exactly(self, tmp_path):
        """Pixels covering an area light read back its radiance L."""
        path = write_scene(tmp_path, """
            LookAt 0 0 -3  0 0 0  0 1 0
            Camera "perspective" "float fov" [ 40 ]
            Film "image" "integer xresolution" [ 16 ] "integer yresolution" [ 16 ]
            WorldBegin
            AttributeBegin
              AreaLightSource "diffuse" "rgb L" [ 2 3 4 ]
              Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
                "point P" [ -5 -5 0  5 -5 0  5 5 0  -5 5 0 ]
                "normal N" [ 0 0 -1  0 0 -1  0 0 -1  0 0 -1 ]
            AttributeEnd
            WorldEnd
        """)
        r = Renderer(path)
        r.render_sample(2)
        img = np.asarray(r.resolve_radiance())
        np.testing.assert_allclose(
            img[4:12, 4:12].mean(axis=(0, 1)), [2.0, 3.0, 4.0], rtol=1e-3
        )

    def test_black_scene_is_black(self, tmp_path):
        path = write_scene(tmp_path, """
            LookAt 0 0 -3  0 0 0  0 1 0
            Camera "perspective" "float fov" [ 40 ]
            Film "image" "integer xresolution" [ 8 ] "integer yresolution" [ 8 ]
            WorldBegin
            Material "matte" "rgb Kd" [ 0.5 0.5 0.5 ]
            Shape "trianglemesh" "integer indices" [ 0 1 2 ]
              "point P" [ -5 -5 0  5 -5 0  0 5 0 ]
            WorldEnd
        """)
        r = Renderer(path)
        r.render_sample(2)
        assert float(np.abs(np.asarray(r.resolve_radiance())).max()) == 0.0


class TestConsistency:
    def test_nee_on_off_agree_on_cornell(self, tmp_path):
        """NEE and BSDF-only sampling are both unbiased: their converged
        means must agree. Coarse 16x12 render, block-averaged."""
        import tests.conftest as c

        path = c.require_scene("cornell-box/scene.pbrt")
        imgs = {}
        for nee in (True, False):
            s = default_output_settings()
            s = s.replace(
                performance_settings=s.performance_settings.__class__(
                    max_bounces=4,
                    enable_next_event_estimation=nee,
                    use_blue_noise=False,
                ),
            )
            r = Renderer(path, settings=s, film_size=(16, 12))
            r.render_sample(600)
            imgs[nee] = np.asarray(r.resolve_radiance())
        a, b = imgs[True], imgs[False]
        # Compare overall mean energy; light pixels dominate variance in
        # the BSDF-only image, so exclude the brightest 5%.
        mask = a.mean(-1) < np.quantile(a.mean(-1), 0.95)
        ma, mb = a[mask].mean(), b[mask].mean()
        assert abs(ma - mb) / ma < 0.12, (ma, mb)

    def test_spec_importance_unbiased_and_lower_variance(self, tmp_path):
        """Fresnel-weighted lobe selection (kernel.glsl:1397-1414's
        bUseSpecularRayImportanceSampling) is a sampling-probability
        change compensated in the one-sample-MIS pdf: the converged mean
        must match the reference-default 50/50 estimator, and on an
        uber surface the per-sample variance must drop."""
        from dataclasses import replace as dreplace

        from tracerboy_tpu.trace.wavefront import render_wave

        import jax.numpy as jnp

        path = write_scene(tmp_path, """
            LookAt 0 5 0  0 0 0  0 0 1
            Camera "perspective" "float fov" [ 30 ]
            Film "image" "integer xresolution" [ 16 ] "integer yresolution" [ 16 ]
            WorldBegin
            LightSource "infinite" "rgb L" [ 1 1 1 ]
            Material "uber" "rgb Kd" [ 0.7 0.7 0.7 ]
              "rgb Ks" [ 0.1 0.1 0.1 ] "float roughness" [ 0.1 ]
            Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
              "point P" [ -50 0 -50  50 0 -50  50 0 50  -50 0 50 ]
            WorldEnd
        """)
        r = Renderer(path, film_size=(16, 16))
        pixel_ids = jnp.arange(16 * 16, dtype=jnp.int32)
        params = r.frame_params()
        stats = {}
        for si in (True, False):
            cfg = dreplace(r.wave_config(), spec_importance=si,
                           use_blue_noise=False)
            vals = []
            for s in range(200):
                out = render_wave(r.scene_pytree, params, pixel_ids,
                                  jnp.int32(s), cfg)
                vals.append(np.asarray(out["radiance"]).mean(-1))
            v = np.stack(vals)          # (spp, npix)
            stats[si] = (v.mean(), v.var(axis=0).mean())
        mean_is, var_is = stats[True]
        mean_50, var_50 = stats[False]
        assert abs(mean_is - mean_50) / mean_50 < 0.05, (mean_is, mean_50)
        assert var_is < var_50 * 0.5, (var_is, var_50)

    def test_merged_wave_matches_separate_samples(self, tmp_path):
        """render_wave_merged(k) traces the SAME sample set as k calls to
        render_wave (identical per-lane RNG streams), so the summed
        radiance must match exactly; only packet grouping differs."""
        import jax.numpy as jnp

        from tracerboy_tpu.trace.wavefront import (
            render_wave,
            render_wave_merged,
        )

        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)  # 32x32 film
        cfg = r.wave_config()
        pixel_ids = jnp.arange(32 * 32, dtype=jnp.int32)
        params = r.frame_params()
        k = 3
        sep_rad = 0.0
        sep_fw = 0.0
        for s in range(k):
            out = render_wave(r.scene_pytree, params, pixel_ids,
                              jnp.int32(s), cfg)
            sep_rad = sep_rad + np.asarray(out["radiance"])
            sep_fw = sep_fw + np.asarray(out["filter_weight"])
        merged = render_wave_merged(r.scene_pytree, params, pixel_ids,
                                    jnp.int32(0), k, cfg)
        np.testing.assert_allclose(
            np.asarray(merged["radiance"]), sep_rad, rtol=1e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(merged["filter_weight"]), sep_fw,
            rtol=1e-5, atol=1e-6,
        )
        # AOVs come from the first sample's replica.
        out0 = render_wave(r.scene_pytree, params, pixel_ids,
                           jnp.int32(0), cfg)
        np.testing.assert_allclose(
            np.asarray(merged["normal"]), np.asarray(out0["normal"]),
            rtol=1e-5, atol=1e-6,
        )

    def test_convergence_metric_decreases(self, tmp_path):
        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)
        r.render_sample(2)
        e1 = r.convergence_error()
        r.render_sample(30)
        e2 = r.convergence_error()
        assert e2 <= e1 + 1e-3


class TestAOVs:
    def test_aov_outputs(self, tmp_path):
        from tracerboy_tpu.utils.config import OutputType

        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)
        r.render_sample(1)
        for ot in (OutputType.LIT, OutputType.ALBEDO, OutputType.NORMAL,
                   OutputType.DEPTH, OutputType.LUMINANCE):
            r.settings = r.settings.replace(output_type=ot)
            img = r.current_image()
            assert img.shape == (32, 32, 3), ot
            assert np.isfinite(img).all(), ot

    def test_albedo_aov_matches_material(self, tmp_path):
        from tracerboy_tpu.utils.config import OutputType

        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)
        r.render_sample(1)
        r.settings = r.settings.replace(output_type=OutputType.ALBEDO)
        img = r.current_image()
        np.testing.assert_allclose(img[16, 16], [0.3, 0.5, 0.7], atol=1e-5)

    def test_pixel_inspection(self, tmp_path):
        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)
        r.render_sample(1)
        info = r.select_pixel(16, 16)
        assert info["material_id"] >= 0
        assert info["depth"] > 0
        mat = r.get_material(info["material_id"])
        np.testing.assert_allclose(mat["albedo"], [0.3, 0.5, 0.7], atol=1e-6)

    def test_material_edit_roundtrip(self, tmp_path):
        path = write_scene(tmp_path, PLANE_UNDER_SKY)
        r = Renderer(path)
        r.render_sample(1)
        info = r.select_pixel(16, 16)
        r.set_material(info["material_id"], albedo=[0.9, 0.1, 0.1])
        assert r.state.spp == 0  # history invalidated
        r.render_sample(4)
        img = np.asarray(r.resolve_radiance())
        np.testing.assert_allclose(
            img[8:24, 8:24].mean(axis=(0, 1)), [0.9, 0.1, 0.1], atol=0.01
        )


@pytest.mark.parametrize("backend", ["brute", "jnp"])
def test_set_material_rebuilds_backend_pytree(backend, monkeypatch):
    """A live material edit rebuilds the scene pytree for the same
    traversal backend, and the next render still runs."""
    import tests.conftest as c

    path = c.require_scene("cornell-box/scene.pbrt")
    monkeypatch.setenv("TB_TRAVERSAL", backend)
    r = Renderer(path, film_size=(16, 16))
    assert r.traversal == backend
    r.render_sample()
    r.set_material(0, albedo=[0.9, 0.1, 0.1])
    assert r.traversal == backend
    r.render_sample()
    img = np.asarray(r.resolve_radiance())
    assert np.isfinite(img).all()


def _bench_like_setup(film=(32, 24), traversal=None, want_aovs=False):
    """Reproduce bench.py's _wave_step environment exactly (the shapes
    the harness dispatches MUST be pinned by tests — round-3 regression,
    VERDICT item 1)."""
    import dataclasses

    import jax.numpy as jnp

    import tests.conftest as c
    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.trace.wavefront import make_blue_noise_params

    path = c.require_scene("cornell-box/scene.pbrt")
    r = Renderer(path, film_size=film)
    cfg = dataclasses.replace(
        r.wave_config(), max_bounces=3, want_aovs=want_aovs,
        traversal="brute",
    )
    W, H = film
    pixel_ids = jnp.arange(W * H, dtype=jnp.int32)
    params = dict(
        dof_focus=jnp.float32(0.0), dof_aperture=jnp.float32(0.0),
        firefly_clamp=jnp.float32(0.0), seed=jnp.int32(0),
        bn=make_blue_noise_params(r.scene_pytree, pixel_ids, W),
    )
    return r, cfg, params, pixel_ids


LEAN_KEYS = {"radiance_r", "radiance_g", "radiance_b", "filter_weight",
             "rays_traced", "live_end"}
AOV_KEYS = {"radiance", "albedo", "normal", "world_pos", "depth",
            "emissive", "material", "diffuse_contrib", "neighbor_dist",
            "heatmap"}


@pytest.mark.smoke
class TestDispatchContracts:
    """Pin the return-key contract of EVERY dispatch shape bench.py and
    renderer.py use (render_wave / render_wave_batch / render_wave_merged
    x want_aovs on/off). The round-3 bench shipped broken because
    render_wave_batch's contract drifted untested (BENCH_r03.json rc=1,
    KeyError 'albedo'); these tests make that class of regression
    impossible to miss."""

    def test_render_wave_lean_keys(self):
        import jax.numpy as jnp
        from tracerboy_tpu.trace.wavefront import render_wave

        r, cfg, params, ids = _bench_like_setup(want_aovs=False)
        out = render_wave(r.scene_pytree, params, ids, jnp.int32(0), cfg)
        assert LEAN_KEYS <= set(out), sorted(out)
        assert not (AOV_KEYS & set(out)), sorted(out)

    def test_render_wave_batch_lean(self):
        """bench.py bench_headline: render_wave_batch(k=16, want_aovs=False)."""
        import jax
        import jax.numpy as jnp
        from functools import partial
        from tracerboy_tpu.trace.wavefront import (
            render_wave, render_wave_batch,
        )

        r, cfg, params, ids = _bench_like_setup(want_aovs=False)
        step = jax.jit(partial(render_wave_batch, k=3, cfg=cfg))
        out = step(r.scene_pytree, params, ids, jnp.int32(0))
        assert LEAN_KEYS <= set(out), sorted(out)
        # The batch must SUM the per-sample planes.
        sep_r = 0.0
        sep_rays = 0.0
        for s in range(3):
            o = render_wave(r.scene_pytree, params, ids, jnp.int32(s), cfg)
            sep_r = sep_r + np.asarray(o["radiance_r"])
            sep_rays += float(o["rays_traced"])
        np.testing.assert_allclose(np.asarray(out["radiance_r"]), sep_r,
                                   rtol=1e-5, atol=1e-6)
        assert float(out["rays_traced"]) == sep_rays

    def test_render_wave_batch_aovs(self):
        """renderer.render_sample(n>1) non-merged path: batch with AOVs.
        Radiance planes sum; AOVs carry the LAST sample's values."""
        import jax.numpy as jnp
        from tracerboy_tpu.trace.wavefront import (
            render_wave, render_wave_batch,
        )

        r, cfg, params, ids = _bench_like_setup(want_aovs=True)
        out = render_wave_batch(r.scene_pytree, params, ids,
                                jnp.int32(0), 2, cfg)
        assert (LEAN_KEYS | AOV_KEYS) <= set(out), sorted(out)
        last = render_wave(r.scene_pytree, params, ids, jnp.int32(1), cfg)
        np.testing.assert_allclose(
            np.asarray(out["normal"]), np.asarray(last["normal"]),
            rtol=1e-5, atol=1e-6,
        )
        # The stacked (N, 3) radiance the renderer accumulates must be
        # the SUM (not the last sample).
        first = render_wave(r.scene_pytree, params, ids, jnp.int32(0), cfg)
        np.testing.assert_allclose(
            np.asarray(out["radiance"]),
            np.asarray(first["radiance"]) + np.asarray(last["radiance"]),
            rtol=1e-5, atol=1e-6,
        )

    def test_render_wave_merged_lean(self):
        """bench.py bench_config_waves: render_wave_merged(want_aovs=False)."""
        import jax
        import jax.numpy as jnp
        from functools import partial
        from tracerboy_tpu.trace.wavefront import render_wave_merged

        r, cfg, params, ids = _bench_like_setup(want_aovs=False)
        step = jax.jit(partial(render_wave_merged, k=2, cfg=cfg))
        out = step(r.scene_pytree, params, ids, jnp.int32(0))
        assert LEAN_KEYS <= set(out), sorted(out)
        assert out["radiance_r"].shape == (ids.shape[0],)

    def test_batch_with_decoupled_albedo(self):
        """render_denoised's demod path: decouple_albedo adds radiance_d."""
        import dataclasses

        import jax.numpy as jnp
        from tracerboy_tpu.trace.wavefront import render_wave_batch

        r, cfg, params, ids = _bench_like_setup(want_aovs=True)
        cfg = dataclasses.replace(cfg, decouple_albedo=True)
        out = render_wave_batch(r.scene_pytree, params, ids,
                                jnp.int32(0), 2, cfg)
        assert "radiance_d" in out
        assert out["radiance_d"].shape == (ids.shape[0], 3)


class TestBenchPath:
    def test_want_aovs_false_matches_radiance(self, tmp_path):
        """The AOV-free bench configuration produces identical radiance."""
        import dataclasses
        import jax.numpy as jnp
        from functools import partial
        import tests.conftest as c
        from tracerboy_tpu.scene.compile import load_scene
        from tracerboy_tpu.trace.wavefront import (
            WaveConfig, render_wave, make_blue_noise_params,
        )

        path = c.require_scene("cornell-box/scene.pbrt")
        cs = load_scene(path, use_cache=False, film_size=(32, 24))
        scene = cs.as_pytree()
        base = dict(
            width=32, height=24, max_bounces=4, leaf_size=cs.leaf_size,
            num_lights=cs.num_lights, has_env=cs.has_env,
            traversal="brute", has_mix=False, has_textures=False,
        )
        ids = jnp.arange(32 * 24, dtype=jnp.int32)
        params = dict(
            dof_focus=jnp.float32(0), dof_aperture=jnp.float32(0),
            firefly_clamp=jnp.float32(0), seed=jnp.int32(0),
            bn=make_blue_noise_params(scene, ids, 32),
        )
        full = render_wave(scene, params, ids, jnp.int32(0),
                           WaveConfig(**base, want_aovs=True))
        lean = render_wave(scene, params, ids, jnp.int32(0),
                           WaveConfig(**base, want_aovs=False))
        np.testing.assert_allclose(
            np.asarray(full["radiance_r"]), np.asarray(lean["radiance_r"]),
            atol=1e-6,
        )
        assert "albedo" not in lean and "albedo" in full
        assert float(lean["rays_traced"]) == float(full["rays_traced"])


class TestSplitEarly:
    """Contribution-depth split (WaveConfig.split_early): the early
    plane plus its complement must partition the total EXACTLY on the
    same samples, and split_early >= max_bounces-1 must equal the
    total."""

    def _run(self, split, env_nee=False, max_bounces=4):
        import jax.numpy as jnp

        import tests.conftest as c
        from tracerboy_tpu.scene.compile import load_scene
        from tracerboy_tpu.trace.wavefront import (
            WaveConfig, render_wave, make_blue_noise_params,
        )

        path = c.require_scene("cornell-box/scene.pbrt")
        cs = load_scene(path, use_cache=False, film_size=(32, 24))
        scene = cs.as_pytree()
        cfg = WaveConfig(
            width=32, height=24, max_bounces=max_bounces,
            leaf_size=cs.leaf_size, num_lights=cs.num_lights,
            has_env=cs.has_env, traversal="brute", has_mix=False,
            has_textures=False, want_aovs=False, split_early=split,
            env_nee=env_nee,
        )
        ids = jnp.arange(32 * 24, dtype=jnp.int32)
        params = dict(
            dof_focus=jnp.float32(0), dof_aperture=jnp.float32(0),
            firefly_clamp=jnp.float32(0), seed=jnp.int32(0),
            bn=make_blue_noise_params(scene, ids, 32),
        )
        return render_wave(scene, params, ids, jnp.int32(0), cfg)

    def test_partition_and_saturation(self):
        out = self._run(split=1)
        assert "radiance_early_r" in out
        early = np.asarray(out["radiance_early_r"])
        total = np.asarray(out["radiance_r"])
        # early is a nonnegative part of the total
        assert (early >= -1e-6).all()
        assert (early <= total + 1e-5).all()
        assert 0.0 < early.sum() < total.sum()

        # split beyond the deepest bounce captures everything
        sat = self._run(split=99)
        np.testing.assert_allclose(
            np.asarray(sat["radiance_early_r"]),
            np.asarray(sat["radiance_r"]), atol=1e-6)

        off = self._run(split=-1)
        assert "radiance_early_r" not in off
        # the split must not perturb the estimator
        np.testing.assert_allclose(
            np.asarray(off["radiance_r"]), total, atol=1e-6)

    def test_merged_fold_carries_planes(self):
        import jax.numpy as jnp

        import tests.conftest as c
        from tracerboy_tpu.scene.compile import load_scene
        from tracerboy_tpu.trace.wavefront import (
            WaveConfig, render_wave_merged, make_blue_noise_params,
        )

        path = c.require_scene("cornell-box/scene.pbrt")
        cs = load_scene(path, use_cache=False, film_size=(16, 16))
        scene = cs.as_pytree()
        cfg = WaveConfig(
            width=16, height=16, max_bounces=3,
            leaf_size=cs.leaf_size, num_lights=cs.num_lights,
            has_env=cs.has_env, traversal="brute", has_mix=False,
            has_textures=False, want_aovs=False, split_early=1,
        )
        ids = jnp.arange(16 * 16, dtype=jnp.int32)
        params = dict(
            dof_focus=jnp.float32(0), dof_aperture=jnp.float32(0),
            firefly_clamp=jnp.float32(0), seed=jnp.int32(0),
            bn=make_blue_noise_params(scene, ids, 16),
        )
        out = render_wave_merged(scene, params, ids, jnp.int32(0),
                                 k=2, cfg=cfg)
        assert out["radiance_early_r"].shape == (16 * 16,)
        early = np.asarray(out["radiance_early_r"])
        total = np.asarray(out["radiance_r"])
        assert (early <= total + 1e-5).all()
