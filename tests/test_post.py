"""Post-processing tests: exposure, TAA, denoiser, realtime composite."""

import numpy as np
import jax.numpy as jnp
import pytest

from tracerboy_tpu.post import pipeline
from tracerboy_tpu.post.denoise import denoise
from tracerboy_tpu.post.temporal import temporal_accumulate, generate_motion_vectors
from tracerboy_tpu.post.realtime import composite_albedo, FrameRateGovernor


def make_cam(pos=(0, 0, 0), look=(0, 0, -1)):
    return dict(
        position=jnp.asarray(pos, jnp.float32),
        look_at=jnp.asarray(look, jnp.float32),
        up=jnp.asarray([0.0, 1.0, 0.0]),
        right=jnp.asarray([1.0, 0.0, 0.0]),
        lens_height=jnp.float32(2.0),
        focal_distance=jnp.float32(1.0),
    )


class TestExposure:
    def test_auto_exposure_scales_to_gray(self):
        img = jnp.full((32, 32, 3), 0.36)
        scale = pipeline.auto_exposure_scale(img)
        # avg luminance 0.36 -> scale approx 0.18/0.36 = 0.5
        assert float(scale) == pytest.approx(0.5, rel=0.1)

    def test_histogram_ignores_black(self):
        img = jnp.zeros((16, 16, 3)).at[0, 0].set(1.0)
        hist = pipeline.luminance_histogram(img)
        assert int(hist[0]) == 255  # black pixels in bin 0
        avg = pipeline.average_luminance(hist)
        assert float(avg) == pytest.approx(1.0, rel=0.15)

    def test_histogram_matches_bincount(self):
        """The sort+searchsorted histogram equals a direct bincount of
        the bin indices (the scatter-add formulation it replaced)."""
        rng = np.random.default_rng(5)
        img = jnp.asarray(rng.random((24, 24, 3)).astype(np.float32) * 4.0)
        hist = np.asarray(pipeline.luminance_histogram(img))
        luma = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        log_luma = np.log2(np.maximum(np.asarray(luma), 1e-12))
        t = (log_luma + 6.0) / 12.0
        idx = np.clip((t * 254).astype(np.int32) + 1, 1, 255)
        idx = np.where(np.asarray(luma) < 1e-8, 0, idx)
        ref = np.bincount(idx.reshape(-1), minlength=256)
        np.testing.assert_array_equal(hist, ref)

    def test_resolve_divides_by_weight(self):
        accum = jnp.concatenate(
            [jnp.full((4, 4, 3), 8.0), jnp.full((4, 4, 1), 4.0)], axis=-1
        )
        out = pipeline.resolve_accumulator(accum)
        np.testing.assert_allclose(np.asarray(out), 2.0)


class TestTAA:
    def test_static_camera_blends_history(self):
        H = W = 16
        cam = make_cam()
        world = jnp.concatenate(
            [jnp.full((H, W, 3), 1.0) * jnp.array([0, 0, -5.0]),
             jnp.full((H, W, 1), 0.5)], axis=-1,
        )
        normals = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (H, W, 1))
        current = jnp.full((H, W, 3), 1.0)
        history = jnp.full((H, W, 3), 0.0)
        moments = jnp.zeros((H, W, 3))
        out, new_m = temporal_accumulate(
            current, world, normals, world, history, moments, cam,
            2.0, history_weight=0.9,
        )
        # Blend = 0.1*current + 0.9*history, but neighborhood clamping
        # pulls history up to the current min => output = current.
        assert np.asarray(out)[..., :3].max() <= 1.0
        assert int(np.asarray(new_m)[8, 8, 2]) == 1  # sample count started

    def test_ignore_history_passes_current(self):
        H = W = 8
        cam = make_cam()
        world = jnp.zeros((H, W, 4)).at[..., 2].set(-5.0)
        normals = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (H, W, 1))
        current = jnp.full((H, W, 3), 0.7)
        out, _ = temporal_accumulate(
            current, world, normals, world,
            jnp.full((H, W, 3), 0.1), jnp.zeros((H, W, 3)), cam, 2.0,
            ignore_history=True,
        )
        np.testing.assert_allclose(np.asarray(out)[..., :3], 0.7, atol=1e-6)

    def test_motion_vectors_zero_when_static(self):
        H = W = 8
        cam = make_cam()
        world = jnp.zeros((H, W, 4)).at[..., 2].set(-5.0)
        mv = generate_motion_vectors(world, cam, cam, 2.0, W, H)
        np.testing.assert_allclose(np.asarray(mv), 0.0, atol=1e-4)


class TestDenoiser:
    def test_flat_image_unchanged(self):
        H = W = 16
        cv = jnp.concatenate(
            [jnp.full((H, W, 3), 0.5), jnp.full((H, W, 1), 0.01)], axis=-1
        )
        normals = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (H, W, 1))
        pos = jnp.zeros((H, W, 4)).at[..., 3].set(0.1)
        out = denoise(cv, cv[..., :3], normals, pos, iterations=2)
        np.testing.assert_allclose(
            np.asarray(out)[..., :3], 0.5, atol=1e-3
        )

    def test_reduces_noise_variance(self, rng):
        H = W = 32
        noisy = jnp.asarray(
            0.5 + rng.normal(0, 0.2, (H, W, 3)).astype(np.float32)
        )
        cv = jnp.concatenate([noisy, jnp.full((H, W, 1), 0.04)], axis=-1)
        normals = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (H, W, 1))
        pos = jnp.zeros((H, W, 4)).at[..., 3].set(0.1)
        out = denoise(cv, noisy, normals, pos, iterations=3)
        assert float(jnp.std(out[..., 0])) < float(jnp.std(noisy[..., 0])) / 2

    def test_respects_normal_edges(self, rng):
        """A sharp normal discontinuity should keep the color edge."""
        H = W = 32
        color = jnp.zeros((H, W, 3)).at[:, : W // 2].set(1.0)
        cv = jnp.concatenate([color, jnp.full((H, W, 1), 0.04)], axis=-1)
        normals = (
            jnp.zeros((H, W, 3))
            .at[:, : W // 2].set(jnp.array([0.0, 0.0, 1.0]))
            .at[:, W // 2 :].set(jnp.array([1.0, 0.0, 0.0]))
        )
        pos = jnp.zeros((H, W, 4)).at[..., 3].set(0.1)
        out = denoise(cv, color, normals, pos, iterations=3)
        left = float(jnp.mean(out[:, : W // 2 - 4, 0]))
        right = float(jnp.mean(out[:, W // 2 + 4 :, 0]))
        assert left > 0.9 and right < 0.1


class TestRealtime:
    def test_composite_formula(self):
        albedo = jnp.full((4, 4, 3), 0.5)
        indirect = jnp.full((4, 4, 3), 2.0)
        emissive = jnp.full((4, 4, 3), 0.25)
        dc = jnp.full((4, 4), 1.0)
        out = composite_albedo(albedo, dc, indirect, emissive)
        np.testing.assert_allclose(np.asarray(out), 0.5 * 2.0 + 0.25)
        dc0 = jnp.zeros((4, 4))
        out0 = composite_albedo(albedo, dc0, indirect, emissive)
        np.testing.assert_allclose(np.asarray(out0), 2.0 + 0.25)

    def test_governor_raises_pad_when_slow(self):
        g = FrameRateGovernor(target_fps=30.0, pad=0.05)
        for _ in range(5):
            g.update(0.1)  # 10 fps
        assert g.pad > 0.05

    def test_governor_lowers_pad_when_fast(self):
        g = FrameRateGovernor(target_fps=30.0, pad=0.5)
        for _ in range(5):
            g.update(0.01)  # 100 fps
        assert g.pad < 0.5


class TestML:
    def test_tza_parses_reference_weights(self):
        import os

        path = "/root/reference/TracerBoy/ML/rt_ldr_alb_nrm.tza"
        if not os.path.exists(path):
            pytest.skip("reference weights not present")
        from tracerboy_tpu.ml.tza import read_tza

        w = read_tza(path)
        assert w["enc_conv0.weight"][0].shape == (32, 9, 3, 3)
        assert w["dec_conv0.weight"][0].shape == (3, 32, 3, 3)
        # 16 convs: enc 0,1,2,3,4,5a,5b + dec 4a,4b,3a,3b,2a,2b,1a,1b,0
        assert len([k for k in w if k.endswith(".weight")]) == 16

    def test_oidn_smooths(self, rng):
        """The committed UNet weights (ml/weights/rt_ldr_ft.npz)."""
        from tracerboy_tpu.ml.oidn import load_oidn, denoise_image

        params = load_oidn()
        noisy = jnp.asarray(
            np.clip(0.5 + rng.normal(0, 0.2, (32, 48, 3)), 0, 1),
            jnp.float32,
        )
        out = denoise_image(params, noisy)
        assert out.shape == (32, 48, 3)
        tv = lambda im: float(jnp.abs(jnp.diff(im, axis=0)).mean())
        assert tv(out) < tv(noisy) / 3

    def test_fsr_upscale_shapes(self, rng):
        from tracerboy_tpu.ml.fsr import fsr_upscale

        img = jnp.asarray(rng.random((24, 36, 3)), jnp.float32)
        out = fsr_upscale(img, 2.0)
        assert out.shape == (48, 72, 3)
        # Mean brightness approximately preserved
        assert abs(float(out.mean()) - float(img.mean())) < 0.05

    def test_superres_residual_identity_tendency(self, rng):
        import os

        path = "/root/reference/TracerBoy/ML/weights.bin"
        if not os.path.exists(path):
            pytest.skip("reference weights not present")
        from tracerboy_tpu.ml.superres import load_superres, upscale2x

        p = load_superres(path)
        img = jnp.asarray(rng.random((16, 16, 3)), jnp.float32)
        out = upscale2x(p, img)
        assert out.shape == (32, 32, 3)
        assert np.isfinite(np.asarray(out)).all()


class TestAdaptiveRealtime:
    def test_governor_reference_increment_dynamics(self):
        """Increment flips sign and accelerates like
        TracerBoy.cpp:2691-2727; pad stays >= 0."""
        g = FrameRateGovernor(target_fps=30.0, pad=0.1)
        for _ in range(25):
            g.update(0.2)  # consistently slow
        grown = g.pad
        assert grown > 0.1
        for _ in range(60):
            g.update(0.001)  # consistently fast
        assert g.pad < grown
        assert g.pad >= 0.0

    def test_adaptive_mask_from_moments(self):
        from tracerboy_tpu.post.realtime import adaptive_active_mask

        mu = jnp.full((4, 4), 0.5)
        noisy = jnp.stack([mu, mu * mu + 0.25, jnp.full((4, 4), 9.0)], -1)
        clean = jnp.stack([mu, mu * mu, jnp.full((4, 4), 9.0)], -1)
        m_noisy = adaptive_active_mask(noisy, 0.05, 0.0, jnp.int32(100))
        m_clean = adaptive_active_mask(clean, 0.05, 0.0, jnp.int32(100))
        assert bool(m_noisy.all())
        assert not bool(m_clean.any())
        # warmup forces everything active
        m_warm = adaptive_active_mask(clean, 0.05, 0.0, jnp.int32(2))
        assert bool(m_warm.all())

    def test_fused_realtime_adaptive_skips_converged(self):
        import dataclasses
        import tests.conftest as c
        from tracerboy_tpu import Renderer
        from tracerboy_tpu.utils.config import (
            RenderMode,
            default_output_settings,
        )

        path = c.require_scene("cornell-box/scene.pbrt")
        s = default_output_settings().replace(render_mode=RenderMode.REAL_TIME)
        s = s.replace(performance_settings=dataclasses.replace(
            s.performance_settings, target_frame_rate=30.0,
            min_convergence=0.5,  # aggressive so pixels converge fast
        ))
        r = Renderer(path, settings=s, film_size=(32, 32))
        lives = []
        for _ in range(12):
            img = r.render_realtime_frame_fused()
            lives.append(float(r._rt_live_pixels))
        img = np.asarray(img)
        assert np.isfinite(img).all()
        assert lives[0] == 32 * 32          # warmup: all pixels live
        assert lives[-1] < 32 * 32          # some pixels went inactive


def test_taa_catmull_rom_option():
    """The optional Catmull-Rom history path
    (TemporalAccumulationCS.hlsl:24-72): for a SMOOTH history with a
    static camera it must agree closely with the bilinear default, and
    the neighborhood clamp bounds it everywhere."""
    from tracerboy_tpu.post.temporal import temporal_accumulate
    from tracerboy_tpu.trace.camera import Camera

    H, W = 24, 32
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack(
        [0.3 + 0.3 * np.sin(xx / 7), 0.4 + 0.2 * np.cos(yy / 5),
         np.full((H, W), 0.5, np.float32)], axis=-1,
    ).astype(np.float32)
    cam = Camera(
        position=np.array([0, 0, 5], np.float32),
        look_at=np.array([0, 0, 0], np.float32),
        up=np.array([0, 1, 0], np.float32),
        right=np.array([1, 0, 0], np.float32),
        lens_height=2.0, focal_distance=5.0,
    )
    # world positions on the focal plane so reprojection is identity-ish
    u = (xx + 0.5) / W - 0.5
    v = 0.5 - (yy + 0.5) / H
    wp = np.stack(
        [u * 2.0 * W / H, v * 2.0, np.zeros_like(u),
         np.full_like(u, 0.1)], axis=-1,
    ).astype(np.float32)
    normals = np.broadcast_to(
        np.array([0, 0, 1], np.float32), (H, W, 3)
    ).copy()
    cur = smooth * 0.9
    moments = np.zeros((H, W, 3), np.float32)

    args = (jnp.asarray(cur), jnp.asarray(wp), jnp.asarray(normals),
            jnp.asarray(wp), jnp.asarray(smooth), jnp.asarray(moments),
            cam.as_pytree(), 2.0)
    out_bi, _ = temporal_accumulate(*args, catmull_rom=False)
    out_cr, _ = temporal_accumulate(*args, catmull_rom=True)
    bi = np.asarray(out_bi)[..., :3]
    cr = np.asarray(out_cr)[..., :3]
    assert np.isfinite(cr).all()
    # interior agreement on smooth data (borders may differ by the pad)
    diff = np.abs(bi - cr)[2:-2, 2:-2]
    assert diff.max() < 0.05, diff.max()
