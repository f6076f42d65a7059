"""Temporal accumulation (TAA) with camera reprojection and moments.

Rebuilds TemporalAccumulationCS.hlsl: reprojection through the previous
camera's lens plane (no motion-vector texture needed; lines 113-168),
3x3 neighborhood color bounds + world-position history rejection with
manual bilinear validity weights (123-212), luma moment history
(mu, mu^2, N) producing variance in the output alpha (216-228), and the
exponential history blend (HistoryWeight = 0.95 default; line 233). The
pass runs twice per RealTime frame: once on demodulated indirect lighting
and once on the final composite (TracerBoy.cpp:3062-3087, 3142-3160).

All-gather-free jnp formulation: the 3x3/bilinear taps are jnp.roll /
gather ops over the full image.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracerboy_tpu.core.mathutil import luminance  # noqa: F401 (API re-export)


def _neighborhood_minmax_planes(planes):
    """Per-pixel 3x3 min/max over a list of dense (H, W) planes.

    Taps are pad-once + static slices instead of jnp.roll (each roll is
    a cross-tile shuffle; static slices of one edge-padded buffer fuse
    into the min/max). Edge padding also gives true edge-clamped
    neighborhoods instead of roll's wraparound."""
    H, W = planes[0].shape
    padded = [jnp.pad(p, 1, mode="edge") for p in planes]
    los = list(planes)
    his = list(planes)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            for i, p in enumerate(padded):
                sh = jax.lax.slice(
                    p, (1 + dy, 1 + dx), (1 + dy + H, 1 + dx + W)
                )
                los[i] = jnp.minimum(los[i], sh)
                his[i] = jnp.maximum(his[i], sh)
    return los, his


def project_to_prev_uv(world_pos, cam_prev, lens_height, width, height):
    """World position -> previous frame uv via the lens-plane intersection
    (TemporalAccumulationCS.hlsl:113-135)."""
    aspect = width / height
    lens_w = lens_height * aspect
    prev_pos = cam_prev["position"]
    prev_dir = cam_prev["look_at"] - prev_pos
    prev_dir = prev_dir / jnp.linalg.norm(prev_dir)
    focal = prev_pos - cam_prev["focal_distance"] * prev_dir

    ray = world_pos - focal
    denom = jnp.sum(ray * prev_dir, axis=-1)
    t = jnp.sum((prev_pos - focal) * prev_dir) / jnp.where(
        jnp.abs(denom) > 1e-9, denom, 1e-9
    )
    lens_point = focal + ray * t[..., None]
    off = lens_point - prev_pos
    u = jnp.sum(off * cam_prev["right"], axis=-1) / (lens_w / 2.0)
    v = jnp.sum(off * cam_prev["up"], axis=-1) / (lens_height / 2.0)
    uv = jnp.stack([(u + 1.0) / 2.0, 1.0 - (v + 1.0) / 2.0], axis=-1)
    valid = (t >= 0) & jnp.all((uv >= 0.0) & (uv <= 1.0), axis=-1)
    return uv, valid


def _sample_history_catmull_rom(history, fx, fy, H, W):
    """Catmull-Rom history sampling in 9 bilinear taps — the reference's
    optional quality path (TemporalAccumulationCS.hlsl:24-72, after
    TheRealMJP's 9-tap formulation). Costs 9 quad-row gathers vs the
    default path's single fused gather; off by default
    (DenoiserSettings.taa_catmull_rom)."""
    pos_x = fx + 0.5          # samplePos in texel units
    pos_y = fy + 0.5
    t1x = jnp.floor(pos_x - 0.5) + 0.5
    t1y = jnp.floor(pos_y - 0.5) + 0.5
    f_x = pos_x - t1x
    f_y = pos_y - t1y

    def wgts(f):
        w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
        w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
        w2 = f * (0.5 + f * (2.0 - 1.5 * f))
        w3 = f * f * (-0.5 + 0.5 * f)
        return w0, w1, w2, w3

    w0x, w1x, w2x, w3x = wgts(f_x)
    w0y, w1y, w2y, w3y = wgts(f_y)
    w12x = w1x + w2x
    w12y = w1y + w2y
    off12x = w2x / jnp.maximum(w12x, 1e-8)
    off12y = w2y / jnp.maximum(w12y, 1e-8)

    # history-only quad table for the bilinear sub-taps
    pp = jnp.pad(history, ((0, 1), (0, 1), (0, 0)), mode="edge")
    quad = jnp.concatenate(
        [history, pp[:H, 1:W + 1], pp[1:H + 1, :W],
         pp[1:H + 1, 1:W + 1]], axis=-1,
    ).reshape(H * W, 12)

    def bilinear(px, py):
        qx = jnp.clip(px - 0.5, 0.0, W - 1.001)
        qy = jnp.clip(py - 0.5, 0.0, H - 1.001)
        bx = jnp.floor(qx).astype(jnp.int32)
        by = jnp.floor(qy).astype(jnp.int32)
        rx = qx - bx
        ry = qy - by
        rows = quad[by * W + bx]
        out = []
        for c in range(3):
            out.append(
                rows[..., c] * (1 - rx) * (1 - ry)
                + rows[..., 3 + c] * rx * (1 - ry)
                + rows[..., 6 + c] * (1 - rx) * ry
                + rows[..., 9 + c] * rx * ry
            )
        return out

    xs = [(t1x - 1.0, w0x), (t1x + off12x, w12x), (t1x + 2.0, w3x)]
    ys = [(t1y - 1.0, w0y), (t1y + off12y, w12y), (t1y + 2.0, w3y)]
    acc = [jnp.zeros_like(f_x) for _ in range(3)]
    for py, wy in ys:
        for px, wx in xs:
            tap = bilinear(px, py)
            for c in range(3):
                acc[c] = acc[c] + tap[c] * (wx * wy)
    return acc


@partial(jax.jit, static_argnames=("output_moments", "ignore_history",
                                   "catmull_rom"))
def temporal_accumulate(
    current,          # (H, W, 3) this frame's color
    world_pos,        # (H, W, 4) xyz + neighbor distance
    normals,          # (H, W, 3)
    prev_world_pos,   # (H, W, 4) previous frame's world positions
    history,          # (H, W, 3) color history
    moment_history,   # (H, W, 3) luma mu, mu^2, sample count
    cam_prev,         # previous-frame camera pytree
    lens_height,
    history_weight=0.95,
    ignore_history=False,
    output_moments: bool = True,
    catmull_rom: bool = False,
):
    """Returns (color+variance alpha (H, W, 4), new moments (H, W, 3)).

    Internally everything runs on dense (H, W) channel planes — the
    (H, W, 3) forms only appear at the interface.
    """
    def wdiv0(ws):
        return jnp.maximum(ws, 1e-8)

    H, W = current.shape[:2]
    wp = world_pos[..., :3]
    cur_p = [current[..., c] for c in range(3)]
    wp_p = [wp[..., c] for c in range(3)]
    hit_valid = (
        (normals[..., 0] != 0.0) | (normals[..., 1] != 0.0)
        | (normals[..., 2] != 0.0)
    )

    uv, in_bounds = project_to_prev_uv(wp, cam_prev, lens_height, W, H)

    # Neighborhood bounds for clamping + world-position tolerance.
    nmin_c, nmax_c = _neighborhood_minmax_planes(cur_p)
    nmin_w, nmax_w = _neighborhood_minmax_planes(wp_p)
    dist_tol = jnp.sqrt(sum((hi - lo) ** 2
                            for lo, hi in zip(nmin_w, nmax_w)))

    # Manual bilinear taps with world-position validity weights
    # (TemporalAccumulationCS.hlsl:170-204). The sample position is
    # clamped into the texel grid so the 2x2 tap block never leaves the
    # image (base in [0, W-2] / [0, H-2]).
    fx = jnp.clip(uv[..., 0] * W - 0.5, 0.0, W - 1.001)
    fy = jnp.clip(uv[..., 1] * H - 0.5, 0.0, H - 1.001)
    bx = jnp.floor(fx).astype(jnp.int32)
    by = jnp.floor(fy).astype(jnp.int32)
    frx = fx - bx
    fry = fy - by

    # ALL FOUR bilinear taps ride ONE row gather: the 9 packed channels
    # (history rgb + moments + prev world pos) of the 2x2 neighborhood
    # are precomputed into a 36-wide quad table with static slices
    # (cheap), so the per-frame gather count drops 4x.
    packed = jnp.concatenate(
        [history, moment_history, prev_world_pos[..., :3]], axis=-1
    )
    pp = jnp.pad(packed, ((0, 1), (0, 1), (0, 0)), mode="edge")
    quad = jnp.concatenate(
        [
            packed,                    # (y,     x)
            pp[:H, 1:W + 1],           # (y,     x + 1)
            pp[1:H + 1, :W],           # (y + 1, x)
            pp[1:H + 1, 1:W + 1],      # (y + 1, x + 1)
        ],
        axis=-1,
    ).reshape(H * W, 36)
    rows = quad[by * W + bx]           # (H, W, 36)

    prev_c = [jnp.zeros((H, W), jnp.float32) for _ in range(3)]
    prev_m = [jnp.zeros((H, W), jnp.float32) for _ in range(3)]
    weight_sum = jnp.zeros((H, W), jnp.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            b = (dy * 2 + dx) * 9
            dd = sum(
                (rows[..., b + 6 + c] - wp_p[c]) ** 2 for c in range(3)
            )
            ok = dd < dist_tol * dist_tol
            wx = (1.0 - frx) if dx == 0 else frx
            wy = (1.0 - fry) if dy == 0 else fry
            wgt = jnp.where(ok, wx * wy, 0.0)
            for c in range(3):
                prev_c[c] = prev_c[c] + rows[..., b + c] * wgt
                prev_m[c] = prev_m[c] + rows[..., b + 3 + c] * wgt
            weight_sum = weight_sum + wgt

    if catmull_rom:
        # Optional Catmull-Rom color-history resampling (the reference's
        # TemporalAccumulationCS.hlsl:24-72 path); validity/moments keep
        # the bilinear machinery, and the neighborhood clamp below
        # bounds any ringing.
        cr = _sample_history_catmull_rom(history, fx, fy, H, W)
        for c in range(3):
            prev_c[c] = jnp.where(
                weight_sum > 0.0, cr[c] * wdiv0(weight_sum), prev_c[c]
            )

    valid = in_bounds & hit_valid & (weight_sum > 0.0)
    if ignore_history:
        valid = jnp.zeros_like(valid)
    wdiv = jnp.maximum(weight_sum, 1e-8)
    prev_c = [p / wdiv for p in prev_c]
    prev_m = [p / wdiv for p in prev_m]

    out_alpha = jnp.ones((H, W), jnp.float32)
    new_moments = moment_history
    if output_moments:
        luma = (0.2126 * cur_p[0] + 0.7152 * cur_p[1]
                + 0.0722 * cur_p[2])
        sample_count = jnp.where(valid, prev_m[2], 0.0) + 1.0
        lerp = 1.0 / jnp.minimum(sample_count, 32.0)
        mu = prev_m[0] * (1 - lerp) + luma * lerp
        mu2 = prev_m[1] * (1 - lerp) + luma * luma * lerp
        new_moments = jnp.stack([mu, mu2, sample_count], axis=-1)
        out_alpha = jnp.maximum(mu2 - mu * mu, 0.0)

    blend = jnp.where(valid, history_weight, 0.0)
    out_c = [
        cur_p[c] * (1 - blend)
        + jnp.clip(prev_c[c], nmin_c[c], nmax_c[c]) * blend
        for c in range(3)
    ]
    return (
        jnp.stack(out_c + [out_alpha], axis=-1),
        new_moments,
    )


@jax.jit
def generate_motion_vectors(world_pos, cam_prev, cam_curr, lens_height,
                            width, height):
    """World position -> pixel-space motion vectors for upscalers
    (GenerateMotionVectorsCS.hlsl:25-55)."""
    wp = world_pos[..., :3]
    uv_prev, v_prev = project_to_prev_uv(wp, cam_prev, lens_height,
                                         width, height)
    uv_curr, v_curr = project_to_prev_uv(wp, cam_curr, lens_height,
                                         width, height)
    mv = (uv_prev - uv_curr) * jnp.array([width, height], jnp.float32)
    return jnp.where((v_prev & v_curr)[..., None], mv, 0.0)
