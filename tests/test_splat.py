"""Tent reconstruction splat (CameraSettings.filter_splat).

Checks the splat fold against a numpy reference, the partition-of-unity
property (constant field reconstructs exactly), and the renderer
plumbing end-to-end on CPU.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest

CORNELL = os.path.join(os.path.dirname(__file__), "scenes", "cornell-box",
                       "scene.pbrt")


def _numpy_splat(rad, ju, jv, W, H):
    """Reference: per-sample loop over the 2x2 nearest pixel centers."""
    k = rad.shape[0]
    out = np.zeros((H, W)), np.zeros((H, W))
    acc, fw = out
    for s in range(k):
        for y in range(H):
            for x in range(W):
                sx, sy = x + ju[s, y, x], y + jv[s, y, x]
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        ty, tx = y + dy, x + dx
                        if not (0 <= ty < H and 0 <= tx < W):
                            continue
                        w = max(0.0, 1 - abs(tx + 0.5 - sx)) * max(
                            0.0, 1 - abs(ty + 0.5 - sy))
                        acc[ty, tx] += w * rad[s, y, x]
                        fw[ty, tx] += w
    return acc, fw


class TestSplatFold:
    def test_matches_numpy_reference(self):
        from tracerboy_tpu.trace.wavefront import splat_fold_tent

        rng = np.random.default_rng(5)
        k, H, W = 3, 6, 7
        rad = rng.uniform(0, 4, size=(3, k, H, W)).astype(np.float32)
        ju = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
        jv = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
        rr, gg, bb, fw = splat_fold_tent(
            *(jnp.asarray(c.reshape(-1)) for c in rad),
            jnp.asarray(ju.reshape(-1)), jnp.asarray(jv.reshape(-1)),
            W, H, k,
        )
        want_r, want_fw = _numpy_splat(rad[0], ju, jv, W, H)
        np.testing.assert_allclose(
            np.asarray(rr).reshape(H, W), want_r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(fw).reshape(H, W), want_fw, rtol=1e-5, atol=1e-5)

    def test_partition_of_unity_constant_field(self):
        """A constant radiance field reconstructs to exactly that
        constant after the fw division, everywhere including borders."""
        from tracerboy_tpu.trace.wavefront import splat_fold_tent

        rng = np.random.default_rng(9)
        k, H, W = 4, 8, 8
        C = 2.5
        rad = np.full((k, H, W), C, np.float32)
        ju = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
        jv = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
        rr, _, _, fw = splat_fold_tent(
            jnp.asarray(rad.reshape(-1)), jnp.asarray(rad.reshape(-1)),
            jnp.asarray(rad.reshape(-1)),
            jnp.asarray(ju.reshape(-1)), jnp.asarray(jv.reshape(-1)),
            W, H, k,
        )
        rr = np.asarray(rr)
        fw = np.asarray(fw)
        assert fw.min() > 0
        np.testing.assert_allclose(rr / fw, C, rtol=1e-5)
        # Interior weight mass: each sample deposits total weight 1, so
        # pixels away from the border collect k on average (exactly k
        # summed over any full row/col interior block).
        assert abs(fw.reshape(H, W)[2:-2, 2:-2].mean() - k) < 0.35


class TestSplatRenderer:
    @pytest.mark.smoke
    def test_renderer_splat_end_to_end(self):
        """Splat render is finite, close to the box render in the mean
        (same estimator, different reconstruction), and goes through
        the merged fold."""
        from tracerboy_tpu.renderer import Renderer

        if not os.path.exists(CORNELL):
            pytest.skip("cornell scene not present")
        r0 = Renderer(CORNELL, film_size=(64, 64))
        r0.render_sample(4)
        box = np.asarray(r0.resolve_radiance())

        r1 = Renderer(CORNELL, film_size=(64, 64))
        cam = dataclasses.replace(
            r1.settings.camera_settings, filter_splat=True)
        r1.settings = dataclasses.replace(
            r1.settings, camera_settings=cam)
        assert r1.wave_config().filter_splat
        r1.render_sample(4)
        sp = np.asarray(r1.resolve_radiance())
        assert np.isfinite(sp).all()
        assert abs(sp.mean() - box.mean()) / box.mean() < 0.05

    def test_variance_reduction_synthetic(self):
        """Noisy samples of a smooth field: tent-splat reconstruction
        beats the box fold in MSE (the ~2.25x effective-spp claim)."""
        from tracerboy_tpu.trace.wavefront import splat_fold_tent

        rng = np.random.default_rng(17)
        k, H, W = 8, 32, 32
        ju = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
        jv = rng.uniform(0, 1, size=(k, H, W)).astype(np.float32)
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        sx = xx[None] + ju
        sy = yy[None] + jv

        def field(x, y):
            return 1.5 + np.sin(x * 0.21) * np.cos(y * 0.17)

        noise = rng.normal(0, 0.5, size=(k, H, W)).astype(np.float32)
        L = (field(sx, sy) + noise).astype(np.float32)
        truth = field(xx + 0.5, yy + 0.5)

        box = L.mean(axis=0)
        rr, _, _, fw = splat_fold_tent(
            jnp.asarray(L.reshape(-1)), jnp.asarray(L.reshape(-1)),
            jnp.asarray(L.reshape(-1)),
            jnp.asarray(ju.reshape(-1)), jnp.asarray(jv.reshape(-1)),
            W, H, k,
        )
        tent = (np.asarray(rr) / np.asarray(fw)).reshape(H, W)
        mse_box = np.mean((box - truth)[2:-2, 2:-2] ** 2)
        mse_tent = np.mean((tent - truth)[2:-2, 2:-2] ** 2)
        # i.i.d.-noise theory: ~2.25x variance reduction; allow slack
        # for the smooth-field bias term.
        assert mse_tent < 0.6 * mse_box, (mse_tent, mse_box)
