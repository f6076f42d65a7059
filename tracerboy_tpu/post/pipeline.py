"""Display post-processing: resolve -> exposure -> tonemap -> gamma + AOVs.

Rebuilds the reference's PostProcessCS (TracerBoy/PostProcessCS.hlsl:
divide accumulated rgb by the filter-weight alpha (23-27), per-AOV debug
views (86-196)), the auto-exposure chain (GenerateHistogramCS /
CalculateAveragedLuminanceCS: 256-bin log-luma histogram -> weighted
average -> LinearGray/avgLum scale) and the tonemap dispatch (Tonemap.h).
Pure jnp image ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracerboy_tpu.core import tonemap as tm
from tracerboy_tpu.core.mathutil import luminance
from tracerboy_tpu.utils.config import OutputSettings, OutputType

HISTOGRAM_BINS = 256
LINEAR_GRAY = 0.18


def resolve_accumulator(accum: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 4) weighted accumulator -> (H, W, 3) mean radiance."""
    return accum[..., :3] / jnp.maximum(accum[..., 3:4], 1e-8)


def luminance_histogram(color: jnp.ndarray, bins: int = HISTOGRAM_BINS,
                        lum_range: float = 12.0):
    """256-bin log2-luminance histogram (GenerateHistogramCS.hlsl:30-53).

    Bin 0 collects black pixels; the rest span 2^-lum_range/2..2^+lum_range/2.
    """
    luma = luminance(color)
    log_luma = jnp.log2(jnp.maximum(luma, 1e-12))
    t = (log_luma + lum_range / 2.0) / lum_range
    idx = jnp.clip((t * (bins - 2)).astype(jnp.int32) + 1, 1, bins - 1)
    idx = jnp.where(luma < 1e-8, 0, idx)
    # Histogram by sort + bin-edge search (sorting the indices and
    # diffing searchsorted bin edges; exact).
    sorted_idx = jnp.sort(idx.reshape(-1))
    edges = jnp.searchsorted(
        sorted_idx, jnp.arange(bins + 1, dtype=jnp.int32)
    )
    return (edges[1:] - edges[:-1]).astype(jnp.int32)


def average_luminance(hist: jnp.ndarray, lum_range: float = 12.0) -> jnp.ndarray:
    """Weighted average luminance, excluding the black bin
    (CalculateAveragedLuminanceCS.hlsl:13-35)."""
    bins = hist.shape[0]
    counts = hist[1:].astype(jnp.float32)
    t = (jnp.arange(1, bins, dtype=jnp.float32) - 1) / (bins - 2)
    log_luma = t * lum_range - lum_range / 2.0
    lum = jnp.exp2(log_luma)
    total = jnp.maximum(jnp.sum(counts), 1.0)
    return jnp.sum(counts * lum) / total


def auto_exposure_scale(color: jnp.ndarray) -> jnp.ndarray:
    """Exposure scale = LinearGray / averageLuminance
    (PostProcessCS.hlsl:29-43)."""
    hist = luminance_histogram(color)
    avg = average_luminance(hist)
    return LINEAR_GRAY / jnp.maximum(avg, 1e-8)


@partial(jax.jit, static_argnames=("tonemap_type", "enable_gamma",
                                   "enable_auto_exposure"))
def display_transform(
    color: jnp.ndarray,
    exposure_multiplier: float,
    tonemap_type: int,
    enable_gamma: bool = True,
    enable_auto_exposure: bool = True,
):
    if enable_auto_exposure:
        color = color * auto_exposure_scale(color)
    color = color * exposure_multiplier
    color = tm.tonemap(tonemap_type, color)
    if enable_gamma:
        color = tm.gamma_correct(color)
    return jnp.clip(color, 0.0, 1.0)


def post_process(accum, settings: OutputSettings, aovs=None, width=0,
                 height=0):
    """Full display path incl. the debug AOV selector
    (PostProcessCS.hlsl:148-196)."""
    color = resolve_accumulator(accum)
    out_type = settings.output_type

    if out_type == OutputType.LIT or aovs is None:
        ps = settings.post_settings
        return display_transform(
            color,
            ps.exposure_multiplier,
            int(ps.tonemap_type),
            ps.enable_gamma_correction,
            ps.enable_auto_exposure,
        )

    h, w = height, width
    if out_type == OutputType.ALBEDO:
        return jnp.clip(aovs["albedo"].reshape(h, w, 3), 0.0, 1.0)
    if out_type == OutputType.NORMAL:
        return aovs["normal"].reshape(h, w, 3) * 0.5 + 0.5
    if out_type == OutputType.DEPTH:
        d = aovs["depth"].reshape(h, w, 1)
        dmax = jnp.maximum(jnp.max(d), 1e-6)
        return jnp.repeat(1.0 - jnp.clip(d / dmax, 0.0, 1.0), 3, axis=-1)
    if out_type == OutputType.LUMINANCE:
        l = luminance(color)[..., None]
        return jnp.repeat(jnp.clip(l, 0.0, 1.0), 3, axis=-1)
    if out_type == OutputType.VARIANCE:
        # Luma heatmap of |main - jittered| handled by caller providing
        # the jittered accumulator in aovs["variance"].
        v = aovs.get("variance")
        if v is None:
            return jnp.zeros((h, w, 3), jnp.float32)
        return heatmap(v.reshape(h, w))
    if out_type == OutputType.HEATMAP:
        hm = aovs.get("heatmap")
        if hm is None:
            return jnp.zeros((h, w, 3), jnp.float32)
        hm = hm.reshape(h, w)
        return heatmap(hm / jnp.maximum(jnp.max(hm), 1e-6))
    if out_type == OutputType.LIVE_PIXELS:
        lp = aovs.get("live_pixels")
        if lp is None:
            return jnp.ones((h, w, 3), jnp.float32)
        return jnp.repeat(
            lp.reshape(h, w, 1).astype(jnp.float32), 3, axis=-1
        )
    if out_type == OutputType.MOTION_VECTORS:
        mv = aovs.get("motion")
        if mv is None:
            return jnp.zeros((h, w, 3), jnp.float32)
        mv = mv.reshape(h, w, 2)
        return jnp.concatenate(
            [jnp.abs(mv) / 8.0, jnp.zeros((h, w, 1))], axis=-1
        )
    return jnp.clip(color, 0.0, 1.0)


def heatmap(x: jnp.ndarray) -> jnp.ndarray:
    """Green->yellow->red heatmap (PostProcessCS.hlsl:133-146 palette)."""
    x = jnp.clip(x, 0.0, 1.0)
    r = jnp.clip(2.0 * x, 0.0, 1.0)
    g = jnp.clip(2.0 * (1.0 - x), 0.0, 1.0)
    return jnp.stack([r, g, jnp.zeros_like(x)], axis=-1)
