"""Renderer: the top-level progressive rendering driver.

The analog of the reference's TracerBoy class
(TracerBoy/TracerBoy.h:158-769): owns the compiled scene, the persistent
render state pytree (accumulators, ping-pong history, sample counter — the
buffers of TracerBoy.h:515-518 & RayGenCommon.h:690-728), and the per-frame
jitted step. Progressive semantics match the reference:

- the color accumulator stores (sum of radiance * filter_weight, sum of
  filter_weight) — display divides rgb by alpha;
- a secondary "jittered" accumulator receives each sample with probability
  1/2; comparing the two estimates convergence (VarianceUtil.h:2-31);
- world-position AOVs ping-pong even/odd frames for TAA reprojection.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from tracerboy_tpu.core import rng as tbrng
from tracerboy_tpu.core import tonemap as tm
from tracerboy_tpu.scene.compile import CompiledScene, load_scene
from tracerboy_tpu.trace.wavefront import WaveConfig, render_wave
from tracerboy_tpu.utils.config import (
    OutputSettings,
    RenderMode,
    default_output_settings,
    invalidates_history,
)


@dataclass
class RenderState:
    """Persistent accumulation state (all device arrays)."""

    accum: jnp.ndarray            # (H, W, 4): rgb * weight, weight
    accum_jittered: jnp.ndarray   # (H, W, 4)
    world_pos: list               # two (H, W, 4) ping-pong buffers
    spp: int = 0
    # RealTime-mode history (filled by post/TAA)
    taa_color_history: jnp.ndarray | None = None
    taa_moment_history: jnp.ndarray | None = None
    taa_indirect_history: jnp.ndarray | None = None


def _zeros(h, w, c=4):
    return jnp.zeros((h, w, c), jnp.float32)


def _demod_ratio(rad_d, rad):
    """Per-channel albedo-modulation ratio D/I for composite_albedo.

    Pixels with no indirect light (I == 0) composite to E regardless of
    the ratio; 1.0 keeps the miss-pixel convention (albedo = 0 there)."""
    return jnp.clip(
        jnp.where(rad > 1e-12, rad_d / jnp.maximum(rad, 1e-12), 1.0),
        0.0, 1.0,
    )


class Renderer:
    def __init__(
        self,
        scene,
        settings: OutputSettings | None = None,
        film_size: tuple | None = None,
        seed: int = 0,
        volume=None,
        shard: str | None = None,
        mesh=None,
        n_devices: int | None = None,
    ):
        """shard: multi-chip scaling axis for render_sample —
        None (single device), "tiles" (pixel pool split over the mesh,
        zero-communication waves; SURVEY.md §2.8 primary axis), or
        "spp" (every device traces the full image at different sample
        indices; accumulators psum-merge across the mesh). mesh: an explicit
        jax.sharding.Mesh; default builds a 1-D mesh over n_devices
        (or all) local devices."""
        if isinstance(scene, str):
            scene = load_scene(scene, film_size=film_size)
        assert isinstance(scene, CompiledScene)
        if volume is not None:
            # Attach/override the heterogeneous medium (a VolumeIR —
            # e.g. from scene.volume.load_volume or procedural_cloud).
            import dataclasses as _dc

            scene = _dc.replace(
                scene, vol_density=volume.density, vol_lo=volume.lo,
                vol_hi=volume.hi, vol_sigma_a=volume.sigma_a,
                vol_sigma_s=volume.sigma_s, vol_g=volume.g,
            )
        self.compiled = scene
        self.seed = int(seed)
        self.settings = settings or default_output_settings()
        self.width = scene.film_width
        self.height = scene.film_height
        if film_size is not None:
            self.width, self.height = film_size
        self.traversal = self._pick_traversal(scene)
        self.leaf_size = scene.leaf_size
        self.scene_pytree = scene.as_pytree()
        if shard not in (None, "tiles", "spp"):
            raise ValueError(f"shard must be None|'tiles'|'spp': {shard}")
        self.shard = shard
        self.mesh = mesh
        if shard is not None and mesh is None:
            from tracerboy_tpu.parallel.sharding import make_mesh

            self.mesh = make_mesh(n_devices)
        self.state = self.make_state()
        self._start_time = time.time()
        self._rays_pending = []
        self._rays_total = 0.0

    @property
    def rays_traced(self) -> float:
        """Rays traced over this renderer's lifetime (camera, bounce and
        shadow rays, as counted by the wavefront's rays_traced)."""
        if self._rays_pending:
            self._rays_total += float(sum(
                np.asarray(r, np.float64) for r in self._rays_pending))
            self._rays_pending = []
        return self._rays_total

    def _count_rays(self, rays):
        """Queue a device-side ray count; folded on the host in bulk so
        counting never forces a sync per frame."""
        self._rays_pending.append(rays)
        if len(self._rays_pending) >= 256:
            self.rays_traced  # noqa: B018 (fold)

    @staticmethod
    def _pick_traversal(scene: CompiledScene) -> str:
        """Backend policy: brute force for tiny scenes (no BVH gathers);
        otherwise the lock-step traversal of the 8-wide BVH. The
        2,048-triangle crossover is a bound, not a measured optimum on
        the GPU. Override with TB_TRAVERSAL=brute|jnp."""
        forced = os.environ.get("TB_TRAVERSAL")
        if forced in ("brute", "jnp"):
            return forced
        return "brute" if scene.tri_v0.shape[0] <= 2048 else "jnp"

    # -- state -----------------------------------------------------------
    def make_state(self) -> RenderState:
        h, w = self.height, self.width
        return RenderState(
            accum=_zeros(h, w),
            accum_jittered=_zeros(h, w),
            world_pos=[_zeros(h, w), _zeros(h, w)],
            spp=0,
        )

    def invalidate_history(self):
        """Restart accumulation (TracerBoy::InvalidateHistory,
        TracerBoy.cpp:3569-3575)."""
        self.state = self.make_state()
        self._start_time = time.time()

    def update_settings(self, new_settings: OutputSettings):
        if invalidates_history(self.settings, new_settings):
            self.invalidate_history()
        self.settings = new_settings

    # -- shader hot-reload analog (TracerBoy::RecompileShaders,
    # TracerBoy.cpp:2608-2675): drop all compiled programs and re-import
    # the kernel modules so edited integrator code takes effect live. ----
    def recompile_shaders(self):
        import importlib

        import jax

        from tracerboy_tpu.trace import wavefront as _wf

        jax.clear_caches()
        new_wf = importlib.reload(_wf)
        # Rebind this module's imported names so the single-sample and
        # realtime paths pick up the reloaded integrator too.
        globals()["render_wave"] = new_wf.render_wave
        globals()["WaveConfig"] = new_wf.WaveConfig
        if hasattr(self, "_bn_cache"):
            del self._bn_cache
        if hasattr(self, "_rt_step"):
            del self._rt_step
        self.invalidate_history()

    # -- camera update (TracerBoy::Update, TracerBoy.cpp:3386-3500) ------
    def move_camera(self, forward=0.0, strafe=0.0, upward=0.0,
                    yaw=0.0, pitch=0.0):
        cam = self.compiled.camera
        view = cam.look_at - cam.position
        view = view / np.linalg.norm(view)
        right = cam.right / np.linalg.norm(cam.right)
        up = cam.up / np.linalg.norm(cam.up)

        delta = forward * view + strafe * right + upward * up
        cam.position = (cam.position + delta).astype(np.float32)

        if yaw != 0.0 or pitch != 0.0:
            def rot(axis, ang):
                axis = axis / np.linalg.norm(axis)
                K = np.array([
                    [0, -axis[2], axis[1]],
                    [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0],
                ])
                return (np.eye(3) + np.sin(ang) * K
                        + (1 - np.cos(ang)) * (K @ K))
            R = rot(up, yaw) @ rot(right, pitch)
            view = R @ view
            right = rot(up, yaw) @ right
            up = np.cross(right, view)
            cam.right = right.astype(np.float32)
            cam.up = (up / np.linalg.norm(up)).astype(np.float32)
        cam.look_at = (cam.position + view).astype(np.float32)
        self.scene_pytree["camera"] = cam.as_pytree()
        self.invalidate_history()

    # -- config ----------------------------------------------------------
    def wave_config(self) -> WaveConfig:
        s = self.settings
        perf = s.performance_settings
        return WaveConfig(
            width=self.width,
            height=self.height,
            max_bounces=min(perf.max_bounces, 32),
            leaf_size=self.leaf_size,
            num_lights=self.compiled.num_lights,
            enable_nee=perf.enable_next_event_estimation,
            enable_ris=perf.enable_sampling_importance_resampling,
            filter_type=int(s.camera_settings.filter_type),
            filter_width=s.camera_settings.filter_width,
            filter_splat=bool(
                s.camera_settings.filter_splat
                and s.render_mode != RenderMode.REAL_TIME
            ),
            use_blue_noise=perf.use_blue_noise,
            sampler=perf.sampler,
            decouple_albedo=(s.render_mode == RenderMode.REAL_TIME),
            has_env=self.compiled.has_env,
            env_nee=bool(
                self.compiled.has_env
                and perf.environment_nee != "off"
                and (perf.environment_nee == "on"
                     or (self.compiled.num_lights == 0
                         and perf.enable_next_event_estimation))
            ),
            env_nee_samples=max(1, min(
                8, int(perf.environment_nee_samples))),
            has_mix=bool(
                (np.asarray(self.compiled.materials["flags"]) & 0x8).any()
            ),
            has_textures=bool(
                (np.asarray(self.compiled.materials["albedo_tex"]) >= 0).any()
                | (np.asarray(self.compiled.materials["emissive_tex"]) >= 0).any()
                | (np.asarray(self.compiled.materials["specular_tex"]) >= 0).any()
            ),
            has_emissive_tex=bool(
                (np.asarray(
                    self.compiled.materials["emissive_tex"]) >= 0).any()
            ),
            has_specular_tex=bool(
                (np.asarray(
                    self.compiled.materials["specular_tex"]) >= 0).any()
            ),
            has_image_tex=bool(
                (np.asarray(self.compiled.tex_records["ttype"]) == 0).any()
            ),
            has_scale_tex=bool(
                (np.asarray(self.compiled.tex_records["ttype"]) == 2).any()
            ),
            has_alpha=bool(
                (np.asarray(self.compiled.materials["alpha_tex"]) >= 0).any()
            ),
            has_normal_maps=bool(
                perf.enable_normal_maps
                and (np.asarray(
                    self.compiled.materials["normal_tex"]) >= 0).any()
            ),
            has_volume=self.compiled.has_volume,
            volume_light_mis=perf.volume_light_mis,
            transparent_shadows=perf.transparent_shadows,
            traversal=self.traversal,
        )

    def frame_params(self, fixed_offset=None) -> dict:
        s = self.settings
        # Cache the device scalars instead of rebuilding them each frame.
        # Keyed on the scalar VALUES (not settings identity) so in-place
        # mutation of a settings object can never serve stale params
        # (advisor finding, round 2).
        fp_key = (
            s.camera_settings.dof_focus_distance,
            s.camera_settings.dof_aperture_width,
            s.fireflies_clamp,
            s.performance_settings.use_blue_noise,
            self.seed,
        )
        cache = getattr(self, "_fp_cache", None)
        if (cache is not None and cache[0] == fp_key
                and fixed_offset is None):
            return dict(cache[1])
        p = dict(
            dof_focus=jnp.float32(s.camera_settings.dof_focus_distance),
            dof_aperture=jnp.float32(s.camera_settings.dof_aperture_width),
            firefly_clamp=jnp.float32(s.fireflies_clamp),
            seed=jnp.int32(self.seed),
        )
        if s.performance_settings.use_blue_noise:
            if not hasattr(self, "_bn_cache"):
                from tracerboy_tpu.trace.wavefront import (
                    make_blue_noise_params,
                )

                self._bn_cache = make_blue_noise_params(
                    self.scene_pytree,
                    jnp.arange(self.width * self.height, dtype=jnp.int32),
                    self.width,
                )
            p["bn"] = self._bn_cache
        if fixed_offset is not None:
            p["fixed_pixel_offset"] = jnp.asarray(fixed_offset, jnp.float32)
        else:
            self._fp_cache = (fp_key, dict(p))
        return p

    # -- adaptive sampling (VarianceUtil.h ShouldSkipRay) -----------------
    ADAPTIVE_MIN_SPP = 64  # the reference starts comparing after many spp

    def active_pixel_mask(self) -> jnp.ndarray | None:
        """Per-pixel convergence mask; None when adaptive sampling is off
        or not warmed up. A pixel goes inactive when the two accumulator
        estimates agree within min_convergence (relative luma error)."""
        perf = self.settings.performance_settings
        if (not perf.enable_adaptive_sampling
                or self.state.spp < self.ADAPTIVE_MIN_SPP):
            return None
        a = self.state.accum
        j = self.state.accum_jittered
        la = tm._luma(a[..., :3] / jnp.maximum(a[..., 3:4], 1e-8))[..., 0]
        lj = tm._luma(j[..., :3] / jnp.maximum(j[..., 3:4], 1e-8))[..., 0]
        err = jnp.abs(la - lj) / jnp.maximum(la, 1e-4)
        return (err > perf.min_convergence).reshape(-1)

    # -- stepping --------------------------------------------------------
    def render_sample(self, n: int = 1):
        """Trace n progressive samples, accumulating into state.

        Batches of samples run in a single jitted dispatch; the jittered
        convergence accumulator receives per-sample coin flips only on
        singly-stepped samples (batched steps approximate with whole-batch
        contributions, which keeps the estimator unbiased).
        """
        from tracerboy_tpu.trace.wavefront import render_wave_batch

        if self.shard == "spp":
            return self._render_sample_spp_sharded(n)
        if self.shard == "tiles":
            return self._render_sample_tiled(n)
        cfg = self.wave_config()
        pixel_ids = jnp.arange(self.width * self.height, dtype=jnp.int32)
        params = self.frame_params()
        mask = self.active_pixel_mask()
        if mask is not None:
            params["active_mask"] = mask
            self._live_pixels = mask
        if n > 1:
            from tracerboy_tpu.trace.wavefront import render_wave_merged

            use_merged = (
                cfg.filter_splat and params.get("selected_pixel") is None
            )
            if use_merged:
                # The tent splat needs a pixel's samples in one wave;
                # chunked so the lane count stays under 8,388,608 (a
                # memory bound for the merged wave's per-lane planes).
                k_max = max(1, min(48, 8_388_608 // pixel_ids.shape[0]))
                done = 0
                while done < n:
                    kk = min(n - done, k_max)
                    out = render_wave_merged(
                        self.scene_pytree, params, pixel_ids,
                        jnp.int32(self.state.spp), kk, cfg,
                    )
                    self._accumulate(out, samples=kk)
                    done += kk
                return self.state
            out = render_wave_batch(
                self.scene_pytree, params, pixel_ids,
                jnp.int32(self.state.spp), n, cfg,
            )
            self._accumulate(out, samples=n)
        else:
            if cfg.filter_splat and params.get("selected_pixel") is None:
                from tracerboy_tpu.trace.wavefront import (
                    render_wave_merged,
                )

                out = render_wave_merged(
                    self.scene_pytree, params, pixel_ids,
                    jnp.int32(self.state.spp), 1, cfg,
                )
            else:
                out = render_wave(
                    self.scene_pytree, params, pixel_ids,
                    jnp.int32(self.state.spp), cfg,
                )
            self._accumulate(out)
        return self.state

    def render_sample_adaptive(self, spp: int = 8, pilot: int = 0,
                               exponent: float = 0.5,
                               max_per_pixel: int = 256):
        """Variance-guided redistribution of a FIXED sample budget.

        BASELINE config 4 names 'variance-guided adaptive sampling';
        the reference's VarianceUtil.h machinery only stops converged
        pixels after ~64 spp, which cannot shape an 8-spp budget. This
        burst mode redistributes instead: a uniform pilot (spp//2 by
        default) measures per-pixel tonemapped-luma variance, the
        residual budget is water-filled so total-per-pixel
        n_p ~ var_p**exponent (exponent 0.5 is the L2-optimal
        allocation; 1.0 equalizes residual variance, which suits a
        denoiser), and the residual traces as ONE wave whose lanes
        repeat high-variance pixels — the merged-wave machinery run
        sideways. Unbiased: every (pixel, sample_index) lane is a fresh
        independent estimate and filter weights accumulate per pixel.
        """
        import dataclasses

        from tracerboy_tpu.trace.wavefront import (
            render_wave,
            render_wave_merged,
        )

        if self.shard is not None:
            raise NotImplementedError(
                "adaptive burst is single-chip; shard the spp loop "
                "outside it"
            )
        pilot = pilot or max(1, spp // 2)
        pilot = min(pilot, spp)
        N = self.width * self.height
        h, w = self.height, self.width
        ids = jnp.arange(N, dtype=jnp.int32)
        params = self.frame_params()
        cfg = self.wave_config()
        out = render_wave_merged(
            self.scene_pytree, params, ids, jnp.int32(self.state.spp),
            pilot, cfg, fold_var=True,
        )
        self._count_rays(out["rays_traced"])
        lum = np.asarray(out["lum"], np.float64)
        lum_sq = np.asarray(out["lum_sq"], np.float64)
        self._accumulate(out, samples=pilot)
        budget = (spp - pilot) * N
        if budget <= 0:
            return self.state
        var = np.maximum(lum_sq / pilot - (lum / pilot) ** 2, 0.0)
        # 3x3 box smooth: a pilot-of-4 variance estimate is itself
        # noisy; selecting on raw estimates funnels budget to lucky
        # outliers.
        v = var.reshape(h, w)
        vp = np.pad(v, 1, mode="edge")
        v = sum(
            vp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)
        ) / 9.0
        target = v.reshape(-1) ** exponent
        counts = self._waterfill(target, pilot, budget, max_per_pixel)
        self._last_adaptive_counts = counts
        ids_r = np.repeat(np.arange(N, dtype=np.int32), counts)
        starts = np.concatenate(
            [[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        occ = (np.arange(budget, dtype=np.int64)
               - starts[ids_r]).astype(np.int32)
        ids_dev = jnp.asarray(ids_r)
        sidx = jnp.int32(self.state.spp) + jnp.asarray(occ)
        p2 = dict(params)
        if p2.get("bn") is not None:
            p2["bn"] = tuple(b[ids_dev] for b in p2["bn"])
        cfg_r = dataclasses.replace(cfg, want_aovs=False)
        out_r = render_wave(self.scene_pytree, p2, ids_dev, sidx, cfg_r)
        self._count_rays(out_r["rays_traced"])
        import jax

        def seg(a):
            return jax.ops.segment_sum(a, ids_dev, num_segments=N)

        rad = jnp.stack(
            [seg(out_r["radiance_r"]), seg(out_r["radiance_g"]),
             seg(out_r["radiance_b"])], axis=-1,
        ).reshape(h, w, 3)
        fw = seg(out_r["filter_weight"]).reshape(h, w, 1)
        sample = jnp.concatenate([rad, fw], axis=-1)
        st = self.state
        st.accum = st.accum + sample
        coin = tbrng.uniform(
            jnp.arange(h * w), jnp.int32(st.spp), 0,
            tbrng.STREAM_ACCUM_JITTER,
        ).reshape(h, w, 1)
        take = (st.spp == 0) | (coin[..., 0] < 0.5)
        st.accum_jittered = jnp.where(
            take[..., None], st.accum_jittered + sample,
            st.accum_jittered,
        )
        st.spp += spp - pilot
        return st

    @staticmethod
    def _waterfill(target, pilot, budget, cap):
        """Integer allocation m_p >= 0 with sum m_p == budget such that
        pilot + m_p tracks c*target (water-filling above the pilot
        floor, capped). Bisection on c, largest-remainder rounding."""
        t = np.asarray(target, np.float64)
        N = t.shape[0]
        if not np.isfinite(t).all():
            t = np.nan_to_num(t)
        if t.sum() <= 0.0:
            m = np.full(N, budget // N, np.int64)
            m[: budget - int(m.sum())] += 1
            return m
        alloc = lambda c: np.minimum(np.maximum(c * t - pilot, 0.0), cap)
        lo, hi = 0.0, 1.0
        while alloc(hi).sum() < budget and hi < 1e18:
            hi *= 2.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if alloc(mid).sum() < budget:
                lo = mid
            else:
                hi = mid
        frac = alloc(hi)
        m = np.floor(frac).astype(np.int64)
        short = budget - int(m.sum())
        if short > 0:
            rem = frac - m
            # Deterministic largest-remainder top-up.
            order = np.argsort(-rem, kind="stable")[:short]
            m[order] += 1
        elif short < 0:
            order = np.argsort(frac - m, kind="stable")
            gz = order[m[order] > 0][: -short]
            m[gz] -= 1
        return m

    # -- multi-chip product paths (SURVEY.md §2.8; the reference is
    # single-GPU — TracerBoy.cpp:2906-2908's SIMT dispatch is the axis
    # these shard across chips) ------------------------------------------
    def _render_sample_spp_sharded(self, n: int):
        """n progressive samples sharded over the mesh by sample index:
        every device traces the full pixel pool, accumulators psum-merge
        across the mesh (the data-parallel gradient-accumulation analog).

        n rounds UP to a multiple of the mesh size — each of the D
        devices traces ceil(n/D) samples."""
        from tracerboy_tpu.parallel.sharding import render_spp_sharded

        cfg = self.wave_config()
        ndev = self.mesh.devices.size
        spd = -(-n // ndev)
        params = self.frame_params()
        mask = self.active_pixel_mask()
        if mask is not None:
            params["active_mask"] = mask
            self._live_pixels = mask
        ids = jnp.arange(self.width * self.height, dtype=jnp.int32)
        rad, fw, rays = render_spp_sharded(
            self.mesh, self.scene_pytree, params, ids,
            jnp.int32(self.state.spp), cfg, samples_per_device=spd,
        )
        self._count_rays(rays)
        h, w = self.height, self.width
        sample = jnp.concatenate(
            [rad.reshape(h, w, 3), fw.reshape(h, w, 1)], axis=-1
        )
        st = self.state
        st.accum = st.accum + sample
        # Whole-batch coin for the jittered convergence accumulator —
        # same unbiased coarsening render_wave_batch uses.
        coin = tbrng.uniform(
            jnp.arange(h * w), jnp.int32(st.spp), 0,
            tbrng.STREAM_ACCUM_JITTER,
        ).reshape(h, w, 1)
        take = (st.spp == 0) | (coin[..., 0] < 0.5)
        st.accum_jittered = jnp.where(
            take[..., None], st.accum_jittered + sample, st.accum_jittered
        )
        st.spp += spd * ndev
        return st

    def _render_sample_tiled(self, n: int):
        """n progressive samples with the pixel pool tile-sharded over
        the mesh: the scene replicates, every per-ray array inherits the
        pixel sharding, the wave itself needs zero communication; the
        accumulate gathers shards (the per-frame CopyResource analog)."""
        from tracerboy_tpu.parallel.sharding import (
            render_wave_tiled,
            shard_pixels,
        )

        cfg = self.wave_config()
        h, w = self.height, self.width
        N = w * h
        if not hasattr(self, "_tiled_pixels"):
            self._tiled_pixels = shard_pixels(self.mesh, w, h)
        pixel_ids, pad = self._tiled_pixels
        params = self.frame_params()
        if "bn" in params:
            # The cached blue-noise pre-gather covers W*H lanes; the
            # tiled pool carries `pad` extra lanes.
            if not hasattr(self, "_bn_cache_tiled"):
                from tracerboy_tpu.trace.wavefront import (
                    make_blue_noise_params,
                )

                self._bn_cache_tiled = make_blue_noise_params(
                    self.scene_pytree,
                    jnp.arange(N + pad, dtype=jnp.int32), w,
                )
            params["bn"] = self._bn_cache_tiled
        mask = self.active_pixel_mask()
        if mask is not None:
            self._live_pixels = mask
            params["active_mask"] = jnp.pad(
                mask, (0, pad), constant_values=False
            )
        for _ in range(n):
            out = render_wave_tiled(
                self.mesh, self.scene_pytree, params, pixel_ids,
                jnp.int32(self.state.spp), cfg,
            )
            n_lanes = N + pad
            out = {
                k: (v[:N] if getattr(v, "ndim", 0) >= 1
                    and v.shape[0] == n_lanes else v)
                for k, v in out.items()
            }
            self._accumulate(out)
        return self.state

    def _accumulate(self, out, samples: int = 1):
        h, w = self.height, self.width
        rad = out["radiance"].reshape(h, w, 3)
        fw = out["filter_weight"].reshape(h, w, 1)
        sample = jnp.concatenate([rad, fw], axis=-1)
        st = self.state
        if self.settings.render_mode == RenderMode.REAL_TIME:
            st.accum = sample
        else:
            st.accum = st.accum + sample
            # Jittered secondary accumulator: first sample/batch always,
            # then a per-pixel coin flip (RayGenCommon.h:719-727). The
            # accumulator carries its own weight in alpha, so taking a
            # whole batch under one coin stays unbiased — just coarser
            # granularity for the convergence comparison.
            coin = tbrng.uniform(
                jnp.arange(h * w), jnp.int32(st.spp), 0,
                tbrng.STREAM_ACCUM_JITTER,
            ).reshape(h, w, 1)
            take = (st.spp == 0) | (coin[..., 0] < 0.5)
            st.accum_jittered = jnp.where(
                take[..., None], st.accum_jittered + sample,
                st.accum_jittered,
            )
        wp = jnp.concatenate(
            [out["world_pos"].reshape(h, w, 3),
             out["neighbor_dist"].reshape(h, w, 1)], axis=-1
        )
        st.world_pos[st.spp % 2] = wp
        st.spp += samples
        self._last_aovs = out
        self._count_rays(out["rays_traced"])

    # -- RealTime mode (1 spp + TAA + denoise, TracerBoy.cpp:3062-3160) --
    def render_realtime_frame_fused(self, as_numpy: bool = False):
        """One RealTime frame as a SINGLE device program (trace + TAA +
        denoise + composite + display) — one dispatch per frame, the
        latency-optimal path for interactive use.

        Adaptive dispatch + frame-rate governor (TracerBoy.cpp:2691-2727
        and 2846-2849): when target_frame_rate > 0, a per-pixel mask from
        the TAA moment buffer skips converged pixels (their trace, AOVs
        and raw lighting are reused from history), and the governor's
        ConvergencePercentPad widens the skip threshold whenever the
        measured frame rate lags the target."""
        from tracerboy_tpu.core.rng import halton23
        from tracerboy_tpu.post.realtime import (
            FrameRateGovernor,
            _realtime_frame_jit,
            adaptive_active_mask,
        )
        from tracerboy_tpu.post.pipeline import display_transform
        from tracerboy_tpu.trace.wavefront import render_wave

        h, w = self.height, self.width
        cfg = self.wave_config()
        frame = self.state.spp
        if not hasattr(self, "_rt_hist_fused"):
            z3 = _zeros(h, w, 3)
            self._rt_hist_fused = dict(
                indirect=z3, moments=z3, final=z3,
                prev_world_pos=_zeros(h, w, 4),
                raw=z3,
                aovs=dict(
                    albedo=z3, normal=z3, world_pos=_zeros(h, w, 4),
                    emissive=z3,
                    diffuse_contrib=z3,
                ),
            )
        pending = getattr(self, "_rt_checkpoint_pending", None)
        if pending is not None:
            # Deferred RealTime-history resume: the checkpoint carried a
            # temporal history but the renderer had none yet at load
            # time; restore it now that a same-shaped template exists.
            from tracerboy_tpu.utils.checkpoint import _unflatten_tree
            import numpy as _np

            self._rt_checkpoint_pending = None
            z = _np.load(pending)
            restored = _unflatten_tree("rt_hist", self._rt_hist_fused, z)
            if restored is not None:
                self._rt_hist_fused = restored
        first = frame == 0
        cam_prev = getattr(self, "_cam_prev", None) or self.scene_pytree["camera"]
        s = self.settings
        perf = s.performance_settings
        adaptive = perf.target_frame_rate > 0

        if not hasattr(self, "_rt_step"):
            import functools

            @functools.partial(
                jax.jit,
                static_argnames=("cfg", "den", "tonemap_type", "gamma",
                                 "auto_exp", "first", "adaptive"),
            )
            def step(scene, params, pixel_ids, sample_index, history,
                     cam_prev_, threshold, cfg, den, tonemap_type, gamma,
                     auto_exp, first, adaptive):
                # Per-frame Halton jitter computed in-program (no eager
                # per-op dispatches on the host each frame).
                params = dict(params, fixed_pixel_offset=halton23(
                    sample_index))
                if adaptive and not first:
                    active = adaptive_active_mask(
                        history["moments"], threshold, 0.0, sample_index
                    )
                    params = dict(params, active_mask=active)
                else:
                    active = jnp.ones((h * w,), bool)
                out = render_wave(scene, params, pixel_ids, sample_index,
                                  cfg)
                am = active.reshape(h, w)[..., None]
                raw = jnp.where(
                    am, out["radiance"].reshape(h, w, 3), history["raw"]
                )
                ha = history["aovs"]
                aovs = dict(
                    albedo=jnp.where(
                        am, out["albedo"].reshape(h, w, 3), ha["albedo"]
                    ),
                    normal=jnp.where(
                        am, out["normal"].reshape(h, w, 3), ha["normal"]
                    ),
                    world_pos=jnp.where(
                        am,
                        jnp.concatenate(
                            [out["world_pos"].reshape(h, w, 3),
                             out["neighbor_dist"].reshape(h, w, 1)],
                            axis=-1,
                        ),
                        ha["world_pos"],
                    ),
                    emissive=jnp.where(
                        am, out["emissive"].reshape(h, w, 3),
                        ha["emissive"],
                    ),
                    # Exact per-channel demodulation ratio D/I from the
                    # two-plane trace (not the reference's AlbedoTexture.w
                    # scalar): composite(albedo, D/I, I, E) == plain
                    # radiance per sample.
                    diffuse_contrib=jnp.where(
                        am,
                        _demod_ratio(
                            out["radiance_d"].reshape(h, w, 3),
                            out["radiance"].reshape(h, w, 3),
                        ),
                        ha["diffuse_contrib"],
                    ),
                )
                display, new_hist = _realtime_frame_jit(
                    raw, aovs, history, cam_prev_,
                    scene["camera"]["lens_height"],
                    denoiser_settings=den, history_weight=0.95,
                    ignore_history=first,
                )
                new_hist["raw"] = raw
                new_hist["aovs"] = aovs
                img = display_transform(
                    display, 1.0, tonemap_type, gamma, auto_exp
                )
                # The raw 1-spp sample as the RealTime accumulator (what
                # _accumulate keeps in REAL_TIME mode), so
                # resolve_radiance reads the current frame.
                accum = jnp.concatenate(
                    [raw, jnp.where(am, out["filter_weight"].reshape(
                        h, w, 1), 1.0)], axis=-1)
                return (img, new_hist, jnp.sum(active), out["rays_traced"],
                        accum)

            self._rt_step = step
        step = self._rt_step

        if not hasattr(self, "_governor"):
            self._governor = FrameRateGovernor(
                target_fps=perf.target_frame_rate,
                pad=perf.convergence_percent_pad,
            )
        now = time.time()
        last = getattr(self, "_rt_last_time", None)
        if last is not None:
            self._governor.update(now - last)
        self._rt_last_time = now
        threshold = jnp.float32(perf.min_convergence + self._governor.pad)

        if not hasattr(self, "_rt_pixel_ids"):
            self._rt_pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
        img, self._rt_hist_fused, live, rays, self.state.accum = step(
            self.scene_pytree, self.frame_params(),
            self._rt_pixel_ids, jnp.int32(frame),
            self._rt_hist_fused, cam_prev, threshold, cfg,
            s.denoiser_settings, int(s.post_settings.tonemap_type),
            s.post_settings.enable_gamma_correction,
            s.post_settings.enable_auto_exposure, bool(first),
            bool(adaptive),
        )
        self._rt_live_pixels = live
        self._count_rays(rays)
        self.state.spp += 1
        self._cam_prev = jax.tree_util.tree_map(
            lambda x: x, self.scene_pytree["camera"]
        )
        return np.asarray(img) if as_numpy else img

    def render_realtime_frame(self, as_numpy: bool = True):
        """One RealTime frame: 1-spp demodulated trace -> TAA -> a-trous
        -> albedo composite -> TAA -> display transform.

        as_numpy=False returns the device array (skips the host
        readback)."""
        from tracerboy_tpu.core.rng import halton23
        from tracerboy_tpu.post.pipeline import display_transform
        from tracerboy_tpu.post.realtime import realtime_frame

        h, w = self.height, self.width
        cfg = self.wave_config()
        frame = self.state.spp
        # Fixed per-frame Halton jitter (the reference's FixedPixelOffset
        # path, kernel.glsl:1834-1838).
        offset = halton23(jnp.int32(frame))
        pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
        out = render_wave(
            self.scene_pytree, self.frame_params(fixed_offset=offset),
            pixel_ids, jnp.int32(frame), cfg,
        )
        self._accumulate(out)
        raw = out["radiance"].reshape(h, w, 3)
        aovs = dict(
            albedo=out["albedo"].reshape(h, w, 3),
            normal=out["normal"].reshape(h, w, 3),
            world_pos=jnp.concatenate(
                [out["world_pos"].reshape(h, w, 3),
                 out["neighbor_dist"].reshape(h, w, 1)], axis=-1,
            ),
            emissive=out["emissive"].reshape(h, w, 3),
            diffuse_contrib=_demod_ratio(
                out["radiance_d"].reshape(h, w, 3),
                out["radiance"].reshape(h, w, 3),
            ),
        )
        if not hasattr(self, "_rt_history"):
            self._rt_history = {}
        cam_prev = getattr(self, "_cam_prev", None) or self.scene_pytree["camera"]
        display, self._rt_history = realtime_frame(
            raw, aovs, self._rt_history, cam_prev,
            self.compiled.camera.lens_height, self.settings.denoiser_settings,
        )
        self._cam_prev = jax.tree_util.tree_map(
            lambda x: x, self.scene_pytree["camera"]
        )
        ps = self.settings.post_settings
        img = display_transform(
            display, ps.exposure_multiplier, int(ps.tonemap_type),
            ps.enable_gamma_correction, ps.enable_auto_exposure,
        )
        return np.asarray(img) if as_numpy else img

    # -- readout ---------------------------------------------------------
    def resolve_radiance(self) -> jnp.ndarray:
        """Mean radiance image (H, W, 3) from the weighted accumulator."""
        a = self.state.accum
        return a[..., :3] / jnp.maximum(a[..., 3:4], 1e-8)

    def denoise(self, weights: str | None = None,
                transfer: str = "reinhard") -> np.ndarray:
        """OIDN-denoised linear radiance (H, W, 3).

        weights: a .npz or .tza UNet parameter file; default the
        committed fine-tuned colour-only network (ml/oidn.py
        DEFAULT_WEIGHTS). A 9-channel (albedo + normal guided) network
        is fed the albedo + normal AOVs like TracerBoy.cpp:3305-3322.

        transfer: the pre-denoise LDR encoding. "reinhard" runs the
        network on the invertible x/(1+x) curve and maps back — the
        naive clip(x,0,1) destroys super-white radiance before the
        network sees it. "clip" matches the reference's behavior of
        denoising its tonemapped output."""
        from tracerboy_tpu.ml.oidn import (
            DEFAULT_WEIGHTS,
            denoise_image,
            in_channels,
            load_oidn,
        )

        params = load_oidn(weights or DEFAULT_WEIGHTS)
        lin = np.maximum(np.asarray(self.resolve_radiance()), 0.0)
        if transfer == "reinhard":
            enc = (lin / (1.0 + lin)) ** (1 / 2.2)
        else:
            enc = np.clip(lin, 0.0, 1.0) ** (1 / 2.2)
        kw = {}
        if in_channels(params) >= 9:
            aovs = getattr(self, "_last_aovs", None)
            if aovs is None or "albedo" not in aovs:
                # Zero guides would quietly degrade the aux-guided
                # network: render one AOV sample on demand instead.
                from tracerboy_tpu.trace.wavefront import render_wave
                import dataclasses

                cfg = dataclasses.replace(self.wave_config(),
                                          want_aovs=True)
                pixel_ids = jnp.arange(self.width * self.height,
                                       dtype=jnp.int32)
                aovs = render_wave(self.scene_pytree, self.frame_params(),
                                   pixel_ids, jnp.int32(self.state.spp),
                                   cfg)
            h, w = self.height, self.width
            kw = dict(
                albedo=jnp.clip(jnp.asarray(
                    aovs["albedo"]).reshape(h, w, 3), 0.0, 1.0),
                normal=jnp.asarray(
                    aovs["normal"]).reshape(h, w, 3),
            )
        den = np.asarray(denoise_image(params, jnp.asarray(enc), **kw))
        if transfer == "reinhard":
            y = np.clip(den, 0.0, 0.995) ** 2.2
            return y / (1.0 - y)
        return np.clip(den, 0.0, 1.0) ** 2.2

    def trace_decoupled(self, spp: int = 8,
                        clamp: float | None = None) -> dict:
        """Trace spp DECOUPLED samples (albedo demodulation planes + aux
        AOVs) without touching self.state; returns the accumulator dict
        consumed by render_denoised. Split out so one trace can feed
        several denoiser variants."""
        import dataclasses

        from tracerboy_tpu.trace.wavefront import render_wave_merged

        N = self.width * self.height
        saved = self.settings
        try:
            if clamp:
                self.settings = self.settings.replace(
                    fireflies_clamp=clamp)
            cfg = dataclasses.replace(self.wave_config(),
                                      decouple_albedo=True,
                                      want_aovs=True)
            params = self.frame_params()
            pixel_ids = jnp.arange(N, dtype=jnp.int32)
            # Same 8,388,608-lane bound as render_sample's merged waves.
            k_max = max(1, min(48, 8_388_608 // N))
            acc: dict = {}
            done = 0
            while done < spp:
                kk = min(k_max, spp - done)
                out = render_wave_merged(self.scene_pytree, params,
                                         pixel_ids, jnp.int32(done), kk,
                                         cfg, fold_aovs=True)
                self._count_rays(out["rays_traced"])
                for key in ("radiance", "radiance_d", "albedo",
                            "normal", "emissive"):
                    acc[key] = acc.get(key, 0.0) + out[key]
                acc["fw"] = acc.get("fw", 0.0) + out["filter_weight"]
                acc["wpos"] = out["world_pos"]      # guide: first sample
                acc["nd"] = out["neighbor_dist"]
                done += kk
        finally:
            self.settings = saved
        acc["spp"] = spp
        return acc

    def render_denoised(self, spp: int = 8, weights: str | None = None,
                        transfer: str = "reinhard", demod: bool = True,
                        dc_filter_iters: int = 2,
                        filter_albedo: bool = False,
                        clamp: float | None = None,
                        _acc: dict | None = None) -> np.ndarray:
        """Demodulated low-spp denoise: the reference's RealTime design
        (CompositeAlbedoCS.hlsl:17-26, TracerBoy.cpp:3062-3160) as one
        batch call — trace spp DECOUPLED samples, OIDN the demodulated
        illumination (texture detail never reaches the network, so its
        distortion floor collapses), then re-composite albedo.

        The noisy per-pixel dc ratio would multiply denoised signal by
        noise at composite time, so it is edge-aware-filtered first
        (dc_filter_iters a-trous steps, normal+position guided).
        clamp: optional firefly clamp applied at trace time — the
        reference treats clamping as a DENOISER setting
        (TracerBoy.h:343 m_fireflyClampValue in denoiserSettings).
        _acc: a precomputed trace_decoupled() result to denoise instead
        of tracing fresh (one trace, many denoiser variants).
        Returns linear radiance (H, W, 3); does not touch self.state."""
        from tracerboy_tpu.ml.oidn import (
            DEFAULT_WEIGHTS,
            denoise_image,
            in_channels,
            load_oidn,
        )
        from tracerboy_tpu.post.denoise import denoise as atrous
        from tracerboy_tpu.post.realtime import composite_albedo

        h, w = self.height, self.width
        acc = _acc if _acc is not None else self.trace_decoupled(
            spp, clamp=clamp)
        spp = acc.get("spp", spp)
        fw = jnp.maximum(acc["fw"], 1e-8)[:, None]
        illum = (acc["radiance"] / fw).reshape(h, w, 3)
        dc = _demod_ratio(acc["radiance_d"] / fw,
                          acc["radiance"] / fw).reshape(h, w, 3)
        alb = jnp.clip(acc["albedo"] / spp, 0.0, 1.0).reshape(h, w, 3)
        nrm = (acc["normal"] / spp).reshape(h, w, 3)
        emi = (acc["emissive"] / spp).reshape(h, w, 3)
        if not demod:
            # Plain composite first, then denoise the final image.
            target = composite_albedo(alb, dc, illum, emi)
        else:
            target = illum
        if transfer == "reinhard":
            enc = (jnp.maximum(target, 0.0)
                   / (1.0 + jnp.maximum(target, 0.0))) ** (1 / 2.2)
        else:
            enc = jnp.clip(target, 0.0, 1.0) ** (1 / 2.2)
        params = load_oidn(weights or DEFAULT_WEIGHTS)
        kw = {}
        if in_channels(params) >= 9:
            kw = dict(
                albedo=jnp.ones_like(alb) if demod else alb,
                normal=nrm,
            )
        den = denoise_image(params, enc, **kw)
        if transfer == "reinhard":
            y = jnp.clip(den, 0.0, 0.995) ** 2.2
            den_lin = y / (1.0 - y)
        else:
            den_lin = jnp.clip(den, 0.0, 1.0) ** 2.2
        if not demod:
            return np.asarray(den_lin)
        if dc_filter_iters > 0:
            wpos4 = jnp.concatenate(
                [acc["wpos"].reshape(h, w, 3),
                 acc["nd"].reshape(h, w, 1)], axis=-1)

            def smooth(p, iters):
                x = jnp.concatenate(
                    [p, jnp.zeros((h, w, 1), jnp.float32)], axis=-1)
                return atrous(x, p, nrm, wpos4,
                              iterations=iters)[..., :3]

            dc = jnp.clip(smooth(dc, dc_filter_iters), 0.0, 1.0)
            if filter_albedo:
                alb = jnp.clip(smooth(alb, 1), 0.0, 1.0)
        return np.asarray(composite_albedo(alb, dc, den_lin, emi))

    def current_image(self, tonemapped: bool = True) -> np.ndarray:
        from tracerboy_tpu.post.pipeline import post_process

        aovs = getattr(self, "_last_aovs", None)
        if aovs is not None:
            aovs = dict(aovs)
            lp = getattr(self, "_live_pixels", None)
            if lp is not None:
                aovs["live_pixels"] = lp
            # Variance AOV: |main - jittered| luma (VarianceUtil metric).
            a = self.state.accum
            j = self.state.accum_jittered
            la = tm._luma(a[..., :3] / jnp.maximum(a[..., 3:4], 1e-8))
            lj = tm._luma(j[..., :3] / jnp.maximum(j[..., 3:4], 1e-8))
            aovs["variance"] = jnp.abs(la - lj)[..., 0]
        img = post_process(
            self.state.accum,
            self.settings,
            aovs=aovs,
            width=self.width,
            height=self.height,
        )
        return np.asarray(img)

    def visualize_selected_ray_path(self, x: int, y: int,
                                    spp: int = 1) -> np.ndarray:
        """Render with ray recording for pixel (x, y) and overlay the
        bounce path on the current image (the reference's VisualizeRays
        debug view, TracerBoy.cpp:3201-3244)."""
        from tracerboy_tpu.post.visualize import overlay_ray_path

        cfg = self.wave_config()
        pixel_ids = jnp.arange(self.width * self.height, dtype=jnp.int32)
        params = self.frame_params()
        params["selected_pixel"] = jnp.int32(y * self.width + x)
        out = render_wave(
            self.scene_pytree, params, pixel_ids,
            jnp.int32(self.state.spp), cfg,
        )
        self._accumulate(out)
        base = self.current_image()
        return overlay_ray_path(
            base, out["viz_rays"], self.scene_pytree["camera"],
            self.width, self.height,
        )

    def render(self, spp: int | None = None) -> np.ndarray:
        """Convenience: trace to the sample target and return the image.

        Honors the sample/time limit gates of the reference
        (TracerBoy.cpp:2679-2682).
        """
        target = spp or self.settings.performance_settings.sample_target
        limit = self.settings.debug_settings.time_limit_seconds
        while self.state.spp < target:
            self.render_sample()
            if limit > 0 and (time.time() - self._start_time) > limit:
                break
        return self.current_image()

    # -- convergence (VarianceUtil.h semantics) --------------------------
    def convergence_error(self) -> float:
        """Mean |main - jittered| luminance difference between the two
        accumulator estimates; the adaptive-sampling convergence metric."""
        a = self.resolve_radiance()
        j = self.state.accum_jittered
        jr = j[..., :3] / jnp.maximum(j[..., 3:4], 1e-8)
        la = tm._luma(a)
        lj = tm._luma(jr)
        return float(jnp.mean(jnp.abs(la - lj)))

    # -- pixel inspection (TracerBoy::SelectPixel / GetMaterial ----------
    # round trip, D3D12App.cpp:146-152 + 275-314) ------------------------
    def select_pixel(self, x: int, y: int) -> dict:
        aovs = getattr(self, "_last_aovs", None)
        if aovs is None:
            return {}
        idx = y * self.width + x
        return dict(
            material_id=int(aovs["material"][idx]),
            depth=float(aovs["depth"][idx]),
            albedo=np.asarray(aovs["albedo"][idx]),
            normal=np.asarray(aovs["normal"][idx]),
            world_pos=np.asarray(aovs["world_pos"][idx]),
        )

    def get_material(self, material_id: int) -> dict:
        mats = self.compiled.materials
        return {k: np.asarray(v[material_id]) for k, v in mats.items()}

    # -- animated geometry (on-device rebuild) ---------------------------
    def update_geometry(self, v0, v1, v2, normals=None):
        """Move the scene's triangles and rebuild acceleration ON DEVICE.

        The analog of the reference's per-change GPU LBVH rebuild
        (GpuBVH2Builder.cpp:167-280): vertex tables, flat normals + UV
        tangents, the attribute rows and — on the BVH backend — the
        8-wide LBVH (accel/bvh_device.build_bvh_device) all refresh as
        jnp ops, with no host round-trip. Triangle count, UVs and
        material assignment are fixed (it's a deformation, not a
        topology edit), so after the first post-update render the
        compiled program is reused for every subsequent frame of an
        animation.

        v0/v1/v2: (T, 3) arrays in the compiled scene's triangle order
        (CompiledScene.tri_v0's order — the same for every call).
        normals: optional (T, 3) flat normals; default recomputes
        cross(e1, e2) (the reference's flat-normal generation,
        TracerBoy.cpp:1710-1729).

        On the BVH backend the device build reorders the per-triangle
        tables by its own leaf order (leaf size 8). The host-side
        CompiledScene keeps the load-time geometry (checkpoint/scene
        cache reflect the original scene)."""
        c = self.compiled
        T = c.tri_v0.shape[0]
        v0 = jnp.asarray(v0, jnp.float32)
        v1 = jnp.asarray(v1, jnp.float32)
        v2 = jnp.asarray(v2, jnp.float32)
        if v0.shape != (T, 3):
            raise ValueError(
                f"update_geometry keeps topology: expected ({T}, 3), "
                f"got {v0.shape}"
            )
        uv0, uv1, uv2 = (jnp.asarray(c.tri_uv0), jnp.asarray(c.tri_uv1),
                         jnp.asarray(c.tri_uv2))
        material = jnp.asarray(c.tri_material)
        e1 = v1 - v0
        e2 = v2 - v0
        if normals is None:
            n = jnp.cross(e1, e2)
            n = n / jnp.maximum(
                jnp.linalg.norm(n, axis=1, keepdims=True), 1e-12
            )
        else:
            n = jnp.asarray(normals, jnp.float32)
        # UV-parameterization tangent (same formula as compile-time).
        d1 = uv1 - uv0
        d2 = uv2 - uv0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        bad = jnp.abs(det) < 1e-12
        tan = e1 * d2[:, 1:2] - e2 * d1[:, 1:2]
        tan = jnp.where(
            bad[:, None], e1, tan / jnp.where(bad, 1.0, det)[:, None]
        )
        tan = tan / jnp.maximum(
            jnp.linalg.norm(tan, axis=1, keepdims=True), 1e-12
        )
        per_tri = dict(
            tri_v0=v0, tri_v1=v1, tri_v2=v2,
            tri_n0=n, tri_n1=n, tri_n2=n,
            tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2,
            tri_material=material,
            tri_attr_rows=jnp.concatenate(
                [n, n, n, uv0, uv1, uv2,
                 material[:, None].astype(jnp.float32), tan],
                axis=1,
            ).astype(jnp.float32),                       # (T, 19)
            tri_shadow_opaque=jnp.asarray(
                (c.materials["flags"][c.tri_material] & 0x10) == 0),
        )
        sp = self.scene_pytree
        if "tri_area" in sp:
            per_tri["tri_area"] = jnp.maximum(
                0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=1), 1e-12)
        if self.traversal != "brute":
            from tracerboy_tpu.accel.bvh_device import LEAF, build_bvh_device

            built = build_bvh_device(v0, v1, v2, leaf_size=LEAF)
            order = built["tri_order"]
            per_tri = {k: a[order] for k, a in per_tri.items()}
            sp.update(
                bvh_lo=built["bounds_lo"], bvh_hi=built["bounds_hi"],
                bvh_children=built["children"],
            )
            self.leaf_size = LEAF
        sp.update(
            per_tri,
            tri9=jnp.concatenate(
                [per_tri["tri_v0"], per_tri["tri_v1"], per_tri["tri_v2"]],
                axis=1),
        )
        self.invalidate_history()

    def set_material(self, material_id: int, **fields):
        """Live material editing: O(1) in scene size.

        Updates ONLY the material SoA arrays on device — the analog of
        the reference's single material-buffer update
        (TracerBoy.cpp:2592-2604 + 3931-3939) — never re-packing
        BVH/triangle tables, so edit latency is independent of triangle
        count. The one exception: editing `flags` can change which
        triangles occlude shadow rays, so that rare case also refreshes
        the derived tri_shadow_opaque plane (still no BVH re-pack)."""
        for k, v in fields.items():
            arr = np.asarray(self.compiled.materials[k]).copy()
            arr[material_id] = v
            self.compiled.materials[k] = arr
        self.scene_pytree["materials"] = {
            k: jnp.asarray(v) for k, v in self.compiled.materials.items()
        }
        if "flags" in fields:
            self.scene_pytree["tri_shadow_opaque"] = jnp.asarray(
                (self.compiled.materials["flags"][
                    self.compiled.tri_material] & 0x10) == 0
            )
        self.invalidate_history()
