"""Heterogeneous volume tests: loaders, delta tracking, transmittance,
phase sampling, and an end-to-end render.

The reference only loads a grid (TracerBoy.cpp:1096-1184, disabled);
the shading here is validated against analytic homogeneous-medium
results on a constant-density grid.
"""

import os
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest

from tracerboy_tpu.core.vec3 import V3
from tracerboy_tpu.scene.volume import (
    VolumeIR,
    from_pbrt_medium,
    procedural_cloud,
    read_vol,
    write_vol,
)


def constant_volume(d=1.0, sigma_a=0.3, sigma_s=0.7):
    return VolumeIR(
        density=np.full((4, 4, 4), d, np.float32),
        lo=np.array([0, 0, 0], np.float32),
        hi=np.array([1, 1, 1], np.float32),
        sigma_a=np.full(3, sigma_a, np.float32),
        sigma_s=np.full(3, sigma_s, np.float32),
    )


def scene_dict(vol: VolumeIR):
    """Minimal scene pytree carrying just the volume keys."""
    sig_t = vol.sigma_a + vol.sigma_s
    return dict(
        vol_density=jnp.asarray(vol.density.reshape(-1)),
        vol_dims=jnp.asarray(np.array(vol.density.shape, np.int32)),
        vol_lo=jnp.asarray(vol.lo), vol_hi=jnp.asarray(vol.hi),
        vol_sigma_a=jnp.asarray(vol.sigma_a),
        vol_sigma_s=jnp.asarray(vol.sigma_s),
        vol_g=jnp.float32(vol.g),
        vol_majorant=jnp.float32(vol.density.max() * sig_t.max() * 1.1),
    )


class TestLoaders:
    def test_vol_roundtrip(self):
        vol = procedural_cloud(n=8)
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "c.vol")
            write_vol(p, vol)
            back = read_vol(p)
        np.testing.assert_allclose(back.density, vol.density)
        np.testing.assert_allclose(back.lo, vol.lo)
        np.testing.assert_allclose(back.hi, vol.hi)

    def test_pbrt_medium_params(self):
        params = dict(
            type=["heterogeneous"],
            nx=np.array([2]), ny=np.array([3]), nz=np.array([4]),
            density=np.arange(24, dtype=np.float64),
            p0=np.array([0.0, 0.0, 0.0]), p1=np.array([1.0, 2.0, 3.0]),
            sigma_a=np.array([0.1, 0.2, 0.3]),
            sigma_s=np.array([1.0, 1.0, 1.0]),
            scale=np.array([2.0]),
            g=np.array([0.4]),
        )
        vol = from_pbrt_medium(params)
        assert vol.density.shape == (4, 3, 2)
        np.testing.assert_allclose(vol.sigma_a, [0.2, 0.4, 0.6])
        assert vol.g == pytest.approx(0.4)

    def test_pbrt_parse_makenamedmedium(self):
        body = """
Transform [ 1 0 0 0  0 1 0 0  0 0 -1 0  0 -1 6.8 1]
Camera "perspective" "float fov" [ 19.5 ]
Film "image" "integer xresolution" [ 8 ] "integer yresolution" [ 8 ]
WorldBegin
MakeNamedMedium "smoke" "string type" "heterogeneous"
  "integer nx" [ 2 ] "integer ny" [ 2 ] "integer nz" [ 2 ]
  "point p0" [ -1 -1 -1 ] "point p1" [ 1 1 1 ]
  "float density" [ 0 1 2 3 4 5 6 7 ]
Material "matte" "rgb Kd" [ 0.7 0.7 0.7 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 ] "point P" [ -1 0 -1 -1 0 1 1 0 1 ]
WorldEnd
"""
        import tempfile as tf

        from tracerboy_tpu.scene.pbrt_parser import parse_pbrt

        with tf.NamedTemporaryFile("w", suffix=".pbrt", delete=False) as f:
            f.write(body)
            path = f.name
        scene = parse_pbrt(path)
        os.unlink(path)
        assert scene.volume is not None
        assert scene.volume.density.shape == (2, 2, 2)
        assert scene.volume.density[1, 1, 1] == 7.0


class TestDeltaTracking:
    def test_constant_grid_matches_beer_lambert(self):
        """On a constant-density gray medium, the fraction of rays that
        traverse the unit box without a real collision must equal
        exp(-sigma_t * L)."""
        from tracerboy_tpu.shade.volumetric import delta_track

        vol = constant_volume(d=1.0, sigma_a=0.4, sigma_s=0.6)
        scene = scene_dict(vol)
        N = 4096
        o = V3(jnp.full((N,), -0.5), jnp.full((N,), 0.5),
               jnp.full((N,), 0.5))
        d = V3(jnp.ones((N,)), jnp.zeros((N,)), jnp.zeros((N,)))
        rng = np.random.default_rng(0)
        us = jnp.asarray(rng.random((24, 2, N)).astype(np.float32))

        def rng2(k):
            # k is traced inside the while_loop walk.
            return us[k, 0], us[k, 1]

        active = jnp.ones((N,), bool)
        scattered, t_sc, w = delta_track(
            scene, o, d, jnp.full((N,), 10.0), active, rng2, steps=24
        )
        frac_pass = 1.0 - float(jnp.mean(scattered.astype(jnp.float32)))
        expect = float(np.exp(-1.0))  # sigma_t = 1, L = 1
        assert frac_pass == pytest.approx(expect, abs=0.03)
        # Scatter distances are inside the box span [0.5, 1.5].
        ts = np.asarray(t_sc)[np.asarray(scattered)]
        assert ts.min() >= 0.5 - 1e-4 and ts.max() <= 1.5 + 1e-4

    def test_spectral_weights_match_transmittance(self):
        """Colored sigma_t: E[weight | no scatter] over many runs should
        track exp(-sigma_t_c L) / exp(-sigma_t_max L) per channel (the
        null-collision correction)."""
        from tracerboy_tpu.shade.volumetric import delta_track

        vol = VolumeIR(
            density=np.ones((2, 2, 2), np.float32),
            lo=np.zeros(3, np.float32), hi=np.ones(3, np.float32),
            sigma_a=np.array([0.1, 0.4, 0.8], np.float32),
            sigma_s=np.array([0.0, 0.0, 0.0], np.float32),
        )
        scene = scene_dict(vol)
        # Loose majorant (2x the bound): null-collision weights stay
        # near 1, keeping the estimator variance small enough for a
        # statistical assertion. (Production uses a tight 1.1x bound
        # for efficiency; unbiasedness holds for any majorant >= bound.)
        scene["vol_majorant"] = jnp.float32(0.8 * 2.0)
        N = 8192
        o = V3(jnp.full((N,), -0.5), jnp.full((N,), 0.5),
               jnp.full((N,), 0.5))
        d = V3(jnp.ones((N,)), jnp.zeros((N,)), jnp.zeros((N,)))
        rng = np.random.default_rng(1)
        us = jnp.asarray(rng.random((32, 2, N)).astype(np.float32))
        scattered, _, w = delta_track(
            scene, o, d, jnp.full((N,), 10.0), jnp.ones((N,), bool),
            lambda k: (us[k, 0], us[k, 1]),
            steps=32,
        )
        # Unconditional estimator mean = channel transmittance
        # (sigma_s = 0 so any real collision kills the ray: weight
        # contributes only on pass-through).
        alive = ~np.asarray(scattered)
        for c, sig in enumerate([0.1, 0.4, 0.8]):
            est = float(np.mean(np.where(alive, np.asarray(w[c]), 0.0)))
            assert est == pytest.approx(np.exp(-sig), abs=0.05), c

    def test_ratio_marching_transmittance(self):
        from tracerboy_tpu.shade.volumetric import transmittance

        vol = constant_volume(d=2.0, sigma_a=0.25, sigma_s=0.25)
        scene = scene_dict(vol)
        N = 16
        o = V3(jnp.full((N,), -1.0), jnp.full((N,), 0.5),
               jnp.full((N,), 0.5))
        d = V3(jnp.ones((N,)), jnp.zeros((N,)), jnp.zeros((N,)))
        t = transmittance(
            scene, o, d, jnp.full((N,), 10.0), jnp.ones((N,), bool),
            jnp.full((N,), 0.5), steps=16,
        )
        # tau = 2.0 * 0.5 * 1.0
        np.testing.assert_allclose(np.asarray(t.x), np.exp(-1.0),
                                   rtol=1e-3)

    def test_hg_mean_cosine(self):
        from tracerboy_tpu.shade.volumetric import sample_hg

        N = 8192
        rng = np.random.default_rng(2)
        d = V3(jnp.zeros((N,)), jnp.zeros((N,)), jnp.ones((N,)))
        for g in (0.0, 0.5, -0.3):
            out = sample_hg(
                d, jnp.float32(g),
                jnp.asarray(rng.random(N, np.float32)),
                jnp.asarray(rng.random(N, np.float32)),
            )
            mean_cos = float(jnp.mean(out.z))
            assert mean_cos == pytest.approx(g, abs=0.04), g
            lens = np.asarray(
                out.x * out.x + out.y * out.y + out.z * out.z
            )
            np.testing.assert_allclose(lens, 1.0, atol=1e-4)


class TestVolumeRender:
    def test_cloud_render_end_to_end(self):
        """Cornell + the procedural cloud: renders finite radiance that
        differs from the no-volume render (the volume is visible)."""
        from tracerboy_tpu.renderer import Renderer
        from tracerboy_tpu.scene.volume import procedural_cloud

        import tests.conftest as c

        path = c.require_scene("cornell-box/scene.pbrt")
        vol = procedural_cloud(n=16)
        # Place the cloud inside the cornell box.
        vol.lo = np.array([-0.6, 0.3, -0.4], np.float32)
        vol.hi = np.array([0.6, 1.5, 0.6], np.float32)
        base = Renderer(path, film_size=(64, 64))
        base.render_sample(2)
        img0 = np.asarray(base.resolve_radiance())

        r = Renderer(path, film_size=(64, 64), volume=vol)
        assert r.wave_config().has_volume
        r.render_sample(2)
        img1 = np.asarray(r.resolve_radiance())
        assert np.isfinite(img1).all()
        assert np.abs(img1 - img0).max() > 1e-3  # the cloud shows up

    def test_volume_scene_cache_roundtrip(self):
        from tracerboy_tpu.scene.compile import (
            load_compiled,
            save_compiled,
        )
        from tracerboy_tpu.scene.compile import load_scene

        import tests.conftest as c

        path = c.require_scene("cornell-box/scene.pbrt")
        cs = load_scene(path, use_cache=False, film_size=(32, 32))
        import dataclasses

        vol = procedural_cloud(n=8)
        cs = dataclasses.replace(
            cs, vol_density=vol.density, vol_lo=vol.lo, vol_hi=vol.hi,
            vol_sigma_a=vol.sigma_a, vol_sigma_s=vol.sigma_s, vol_g=0.3,
        )
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "s.npz")
            save_compiled(p, cs)
            back = load_compiled(p)
        assert back.has_volume
        np.testing.assert_allclose(back.vol_density, vol.density)
        assert back.vol_g == pytest.approx(0.3)
        pt = back.as_pytree()
        assert "vol_majorant" in pt


class TestTrilinear:
    def _oct_scene(self, dd, lo=None, hi=None):
        import dataclasses

        vol = VolumeIR(
            density=dd.astype(np.float32),
            lo=np.array([0, 0, 0], np.float32) if lo is None else lo,
            hi=np.array([1, 1, 1], np.float32) if hi is None else hi,
            sigma_a=np.full(3, 0.3, np.float32),
            sigma_s=np.full(3, 0.7, np.float32),
        )
        sc = scene_dict(vol)
        D, H, W = dd.shape
        zs = np.minimum(np.arange(D) + 1, D - 1)
        ys = np.minimum(np.arange(H) + 1, H - 1)
        xs = np.minimum(np.arange(W) + 1, W - 1)
        sc["vol_oct"] = jnp.asarray(np.stack(
            [dd, dd[:, :, xs], dd[:, ys], dd[:, ys][:, :, xs],
             dd[zs], dd[zs][:, :, xs], dd[zs][:, ys],
             dd[zs][:, ys][:, :, xs]], axis=-1,
        ).reshape(-1, 8).astype(np.float32))
        return sc

    def test_matches_numpy_trilerp(self):
        """sample_density_trilinear == scipy-style trilerp on random
        points strictly inside the voxel-center hull."""
        from tracerboy_tpu.shade.volumetric import (
            sample_density_trilinear,
        )

        rng = np.random.default_rng(7)
        dd = rng.uniform(0.0, 2.0, size=(5, 6, 7)).astype(np.float32)
        sc = self._oct_scene(dd)
        D, H, W = dd.shape
        # Points inside the center hull: f in [0.5/n, (n-0.5)/n).
        n = 256
        fz = rng.uniform(0.5 / D, (D - 0.51) / D, n)
        fy = rng.uniform(0.5 / H, (H - 0.51) / H, n)
        fx = rng.uniform(0.5 / W, (W - 0.51) / W, n)
        got = np.asarray(sample_density_trilinear(
            sc, jnp.asarray(fx, jnp.float32), jnp.asarray(fy, jnp.float32),
            jnp.asarray(fz, jnp.float32)))

        def ref(fz1, fy1, fx1):
            cz, cy, cx = fz1 * D - 0.5, fy1 * H - 0.5, fx1 * W - 0.5
            bz, by, bx = int(np.floor(cz)), int(np.floor(cy)), int(np.floor(cx))
            wz, wy, wx = cz - bz, cy - by, cx - bx
            v = 0.0
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        w = ((wz if dz else 1 - wz) * (wy if dy else 1 - wy)
                             * (wx if dx else 1 - wx))
                        v += w * dd[min(bz + dz, D - 1),
                                    min(by + dy, H - 1),
                                    min(bx + dx, W - 1)]
            return v

        want = np.array([ref(fz[i], fy[i], fx[i]) for i in range(n)])
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)

    def test_never_exceeds_majorant(self):
        """Interpolated density <= max(density): the delta-tracking
        majorant stays a true bound under trilinear taps."""
        from tracerboy_tpu.shade.volumetric import (
            sample_density_trilinear,
        )

        rng = np.random.default_rng(3)
        dd = rng.uniform(0.0, 5.0, size=(8, 8, 8)).astype(np.float32)
        sc = self._oct_scene(dd)
        n = 4096
        f = rng.uniform(-0.2, 1.2, size=(3, n)).astype(np.float32)
        got = np.asarray(sample_density_trilinear(
            sc, jnp.asarray(f[0]), jnp.asarray(f[1]), jnp.asarray(f[2])))
        assert got.max() <= dd.max() + 1e-5
        assert got.min() >= 0.0


class TestVolumeLightMIS:
    def test_hg_pdf_normalized(self):
        """hg_pdf integrates to 1 over the sphere for several g."""
        from tracerboy_tpu.shade.volumetric import hg_pdf

        mu = np.linspace(-1, 1, 20001)
        for g in (0.0, 0.3, -0.5, 0.85):
            pdf = np.asarray(hg_pdf(jnp.asarray(mu, jnp.float32),
                                    jnp.float32(g)))
            integral = 2 * np.pi * np.trapezoid(pdf, mu)
            assert abs(integral - 1.0) < 2e-3, (g, integral)

    def test_balance_weights_complementary(self):
        """w_nee + w_phase == 1 for the same light point: the NEE-side
        weight (solid-angle-converted area pdf, shade path) and the
        hit-side weight (t^2/(num_lights*area*cos), emissive path) use
        the same p_L, so the pair telescopes to an unbiased estimator."""
        from tracerboy_tpu.shade.volumetric import hg_pdf

        rng = np.random.default_rng(11)
        num_lights = 3
        for _ in range(50):
            area = float(rng.uniform(0.05, 4.0))
            dist = float(rng.uniform(0.2, 10.0))
            cos_l = float(rng.uniform(0.05, 1.0))
            cos_ph = float(rng.uniform(-1.0, 1.0))
            g = float(rng.uniform(-0.8, 0.8))
            p_phase = float(np.asarray(hg_pdf(jnp.float32(cos_ph),
                                              jnp.float32(g))))
            pdf_area = 1.0 / (num_lights * area)
            p_lw_nee = pdf_area * dist * dist / cos_l          # NEE side
            p_lw_hit = dist * dist / (num_lights * area * cos_l)  # hit side
            assert abs(p_lw_nee - p_lw_hit) < 1e-9 * max(p_lw_nee, 1.0)
            w_nee = p_lw_nee / (p_lw_nee + p_phase)
            w_ph = p_phase / (p_phase + p_lw_hit)
            assert abs(w_nee + w_ph - 1.0) < 1e-6

    @pytest.mark.slow
    def test_mis_unbiased_cornell_cloud(self):
        """Cornell + cloud: the MIS estimator's mean matches the
        NEE-only estimator's within joint SE (both unbiased)."""
        import dataclasses

        from tracerboy_tpu.renderer import Renderer

        import tests.conftest as c

        path = c.require_scene("cornell-box/scene.pbrt")
        vol = procedural_cloud(n=8)
        vol.lo = np.array([-0.6, 0.3, -0.4], np.float32)
        vol.hi = np.array([0.6, 1.5, 0.6], np.float32)

        means, errs = [], []
        for mis in (True, False):
            r = Renderer(path, film_size=(32, 32), volume=vol)
            assert r.wave_config().volume_light_mis  # default ON
            ps = dataclasses.replace(
                r.settings.performance_settings, volume_light_mis=mis)
            r.settings = dataclasses.replace(
                r.settings, performance_settings=ps)
            assert r.wave_config().volume_light_mis == mis
            vals = []
            for chunk in range(4):
                r.render_sample(8)
                vals.append(float(np.asarray(
                    r.resolve_radiance()).mean()))
            img = np.asarray(r.resolve_radiance())
            assert np.isfinite(img).all()
            # SE of the 4 cumulative-mean increments (coarse but
            # seed-independent).
            inc = np.diff(np.array([0.0] + vals))
            means.append(np.mean(img))
            errs.append(np.std(inc) / np.sqrt(len(inc)))
        tol = 4.0 * np.hypot(errs[0], errs[1]) + 1e-4
        assert abs(means[0] - means[1]) < tol, (means, errs)
