"""RealTime-mode frame pipeline: TAA -> a-trous -> albedo composite -> TAA.

Reassembles the reference's real-time denoising chain
(TracerBoy.cpp:3062-3160): the 1-spp demodulated indirect lighting is
temporally accumulated (with moments), wavelet-denoised N times, then
recombined with albedo (CompositeAlbedoCS.hlsl:17-26: albedo * indirect *
diffuseContribution + indirect * specularContribution + emissive) and a
final TAA pass stabilizes the composite. Also hosts the frame-rate
governor (TracerBoy.cpp:2691-2727).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracerboy_tpu.post.denoise import denoise
from tracerboy_tpu.post.temporal import temporal_accumulate


def composite_albedo(albedo, diffuse_contribution, indirect, emissive):
    """CompositeAlbedoCS.hlsl:17-26.

    diffuse_contribution may be the reference's per-pixel scalar
    ((H, W), AlbedoTexture.w) or the exact per-channel ratio
    D/I ((H, W, 3)) from the two-plane demodulated trace
    (render_wave's radiance_d output)."""
    dc = diffuse_contribution
    if dc.ndim == indirect.ndim - 1:
        dc = dc[..., None]
    return albedo * indirect * dc + indirect * (1.0 - dc) + emissive


def realtime_frame(
    raw_indirect,      # (H, W, 3) this frame's demodulated lighting
    aovs,              # dict: albedo, normal, world_pos+neighbor_dist,
                       #       emissive, diffuse_contrib (all (H,W,...))
    history,           # dict with keys: indirect, moments, final,
                       #       prev_world_pos (None on first frame)
    cam_prev,
    lens_height,
    denoiser_settings,
    history_weight: float = 0.95,
):
    """One RealTime frame. Returns (display_color, new_history).

    Convenience wrapper around the fused jitted pipeline; first-frame
    (empty history) is handled here so the jitted body stays static.
    """
    H, W = raw_indirect.shape[:2]
    zeros3 = jnp.zeros((H, W, 3), jnp.float32)
    first = history.get("indirect") is None
    hist = dict(
        indirect=history.get("indirect") if not first else zeros3,
        moments=history.get("moments") if not first else zeros3,
        final=history.get("final") if not first else zeros3,
        prev_world_pos=(
            history.get("prev_world_pos")
            if history.get("prev_world_pos") is not None
            else aovs["world_pos"]
        ),
    )
    display, new_history = _realtime_frame_jit(
        raw_indirect, aovs, hist, cam_prev, lens_height,
        denoiser_settings=denoiser_settings,
        history_weight=history_weight, ignore_history=first,
    )
    return display, new_history


@partial(
    jax.jit,
    static_argnames=("denoiser_settings", "history_weight",
                     "ignore_history"),
)
def _realtime_frame_jit(
    raw_indirect,
    aovs,
    history,
    cam_prev,
    lens_height,
    denoiser_settings,
    history_weight: float,
    ignore_history: bool,
):
    """The whole RealTime post chain (TAA -> a-trous xN -> composite ->
    TAA) as ONE program (one dispatch per frame)."""
    H, W = raw_indirect.shape[:2]
    first = ignore_history
    hist_ind = history["indirect"]
    hist_mom = history["moments"]
    hist_fin = history["final"]
    prev_wp = history["prev_world_pos"]

    # TAA #1 on indirect lighting, producing variance in alpha.
    taa_ind, new_moments = temporal_accumulate(
        raw_indirect, aovs["world_pos"], aovs["normal"], prev_wp,
        hist_ind, hist_mom, cam_prev, lens_height,
        history_weight=history_weight, ignore_history=first,
        output_moments=True,
        catmull_rom=bool(getattr(
            denoiser_settings, "taa_catmull_rom", False)),
    )

    # Wavelet denoise the indirect estimate.
    if denoiser_settings.enabled:
        den = denoise(
            taa_ind, raw_indirect, aovs["normal"], aovs["world_pos"],
            iterations=denoiser_settings.wavelet_iterations,
            luma_weight_mult=denoiser_settings.luminance_weight,
            normal_exp=denoiser_settings.normal_weight_exponent,
            position_weight_mult=(
                denoiser_settings.intersection_position_weight_exponent
            ),
        )
        indirect = den[..., :3]
    else:
        indirect = taa_ind[..., :3]

    # Recombine with albedo + emissive.
    final = composite_albedo(
        aovs["albedo"], aovs["diffuse_contrib"], indirect, aovs["emissive"]
    )

    # TAA #2 on the final composite (no moments).
    taa_fin, _ = temporal_accumulate(
        final, aovs["world_pos"], aovs["normal"], prev_wp,
        hist_fin, jnp.zeros((H, W, 3), jnp.float32), cam_prev, lens_height,
        history_weight=history_weight, ignore_history=first,
        output_moments=False,
        catmull_rom=bool(getattr(
            denoiser_settings, "taa_catmull_rom", False)),
    )
    display = taa_fin[..., :3]

    new_history = dict(
        indirect=taa_ind[..., :3],
        moments=new_moments,
        final=display,
        prev_world_pos=aovs["world_pos"],
    )
    return display, new_history


class FrameRateGovernor:
    """Adaptive-sampling throttle, reference semantics
    (TracerBoy.cpp:2691-2727): every FRAMES_PER_INCREMENT frames compare
    the average frame time to the target, flip or accelerate a signed
    increment (capped at 25% of the current pad), and accumulate it into
    ConvergencePercentPad (clamped >= 0). The pad is ADDED to
    MinConvergence (TracerBoy.cpp:2846-2849), raising the
    adaptive-dispatch skip threshold — fewer active pixels — whenever
    the frame rate lags the target."""

    FRAMES_PER_INCREMENT = 5
    DEFAULT_INCREMENT = 0.0001

    def __init__(self, target_fps: float = 30.0, pad: float = 0.1):
        self.target_fps = target_fps
        self.pad = pad
        self.increment = self.DEFAULT_INCREMENT
        self._frames = 0
        self._accum = 0.0

    def update(self, frame_seconds: float) -> float:
        self._frames += 1
        self._accum += frame_seconds
        if self._frames >= self.FRAMES_PER_INCREMENT:
            frame_time = self._accum / self._frames
            target = 1.0 / max(self.target_fps, 1e-6)
            if frame_time < target and self.increment > 0.0:
                # Faster than target: shrink the pad, more active waves.
                self.increment = -self.DEFAULT_INCREMENT
            elif frame_time > target and self.increment < 0.0:
                self.increment = self.DEFAULT_INCREMENT
            else:
                mult = min(
                    1.0 + 0.25 * abs(frame_time - target)
                    / max(frame_time, 1e-9),
                    2.0,
                )
                self.increment *= mult
            cap = max(self.pad * 0.25, self.DEFAULT_INCREMENT)
            if abs(self.increment) > cap:
                self.increment = cap if self.increment > 0 else -cap
            self.pad = max(0.0, self.pad + self.increment)
            self._frames = 0
            self._accum = 0.0
        return self.pad


def adaptive_active_mask(moments, min_convergence, pad, frame_index,
                         warmup: int = 8):
    """Per-pixel RealTime adaptive-dispatch mask from the TAA moment
    buffer: a pixel stays active while its relative luma noise exceeds
    MinConvergence + ConvergencePercentPad (the VarianceUtil.h skip test
    re-expressed on the SVGF moments instead of the dual accumulators).

    moments: (H, W, 3) = (luma mu, luma mu^2, sample count).
    Returns a flat (H*W,) bool mask; everything active during warmup.
    """
    mu = moments[..., 0]
    var = jnp.maximum(moments[..., 1] - mu * mu, 0.0)
    err = jnp.sqrt(var) / jnp.maximum(jnp.abs(mu), 1e-4)
    active = err > (min_convergence + pad)
    active = active | (frame_index < warmup)
    return active.reshape(-1)
