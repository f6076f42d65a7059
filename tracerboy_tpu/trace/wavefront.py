"""Wavefront path-tracing integrator.

The data-parallel redesign of the reference's megakernel `Trace` bounce loop
(TracerBoy/kernel.glsl:1277-1776) plus its PathTrace epilogue
(kernel.glsl:1805-1925): instead of one divergent per-pixel loop, a flat
ray pool advances through uniform, fully-vectorized stages per bounce —
RR -> traverse -> miss/env -> material fetch -> NEE + shadow wave ->
BSDF sample -> throughput update — with lane masks in place of branches.

The reference's nested subsurface random walk (kernel.glsl:1529-1691) is
re-expressed as a per-ray *medium state machine* folded into the same
bounce loop: a ray inside a medium alternates free-flight sampling and
boundary refraction as ordinary wavefront steps, so SSS rays ride the same
traversal waves as everything else (no divergent inner loop). Consequence:
medium scattering events consume bounce budget (the reference allowed 100
dedicated SSS steps); russian roulette bounds the walk instead.

Known deliberate deviations from the reference (all bias-reducing):
- RR survival probability is clamped to <= 1 (the reference divides by
  unclamped p, losing energy when throughput > 1).
- RIS light sampling produces normalized, attenuated directions (the
  reference's RIS branch leaves attenuation at 0 — black NEE).
- Medium phase sampling weights by phase/pdf = 1 exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from tracerboy_tpu.core import rng as tbrng
from tracerboy_tpu.scene.materials import (
    LIGHT_FLAG,
    METALLIC_FLAG,
    NO_SPECULAR_FLAG,
    SINGLE_SIDED_FLAG,
    SUBSURFACE_SCATTER_FLAG,
    HAIR_FLAG,
)
from tracerboy_tpu.shade import bsdf
from tracerboy_tpu.trace.traverse import traverse_wide
from tracerboy_tpu.trace.intersect import BIG

EPSILON = 1e-4
MIN_BOUNCES_BEFORE_RR = 2  # kernel.glsl:1276-1277


ALPHA_CUTOFF = 0.9  # SharedHitGroup.h:163


def _alpha_at_hit(scene, tri, u, v):
    """Cutout alpha at a hit; 1.0 where opaque / no alpha texture / miss.

    The reference's IsValidHit (SharedHitGroup.h:157-179): sample the
    material's alpha texture (or the albedo texture's alpha channel,
    bound as a companion record at scene load) at the hit UV.
    """
    from tracerboy_tpu.shade.surface import eval_texture

    tbl = scene["tri_attr_rows"]
    T = tbl.shape[0]
    tric = jnp.clip(tri, 0, T - 1)
    r = tbl[tric]                                # one row gather
    w_b = 1.0 - u - v
    uv_u = r[:, 9] * w_b + r[:, 11] * u + r[:, 13] * v
    uv_v = r[:, 10] * w_b + r[:, 12] * u + r[:, 14] * v
    mid = jnp.round(r[:, 15]).astype(jnp.int32)
    mats = scene["materials"]
    M = mats["alpha_tex"].shape[0]
    atex = mats["alpha_tex"][jnp.clip(mid, 0, M - 1)]
    uv = jnp.stack([uv_u, uv_v], axis=-1)
    a = eval_texture(
        scene["tex_records"], scene["tex_images"], scene["tex_sizes"],
        jnp.maximum(atex, 0), uv,
    )[..., 0]
    return jnp.where((tri >= 0) & (atex >= 0), a, 1.0)


def _closest_once(scene, o_v3, d_v3, t_max, cfg):
    """One closest-hit traversal on the selected backend (flat outputs):
    exhaustive brute force for small scenes, the lock-step wide-BVH
    loop otherwise. Returns (t, tri, u, v, per-ray traversal cost)."""
    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.trace.intersect import brute_force_closest_soa

    if cfg.use_brute_force:
        t, tri, u, v = brute_force_closest_soa(
            o_v3, d_v3, scene["tri9"], t_max
        )
        cost = jnp.full_like(t_max, float(scene["tri9"].shape[0]))
        return t, tri, u, v, cost
    return traverse_wide(
        v3.to_rows(o_v3), v3.to_rows(d_v3), t_max,
        scene["bvh_lo"], scene["bvh_hi"], scene["bvh_children"],
        scene["tri_v0"], scene["tri_v1"], scene["tri_v2"],
        leaf_size=cfg.leaf_size,
    )


def _closest_dispatch(scene, o_v3, d_v3, t_max, cfg):
    """Closest-hit with alpha-tested transparency.

    Wavefront any-hit: instead of an in-traversal callback (the
    reference's AnyHit.hlsl IgnoreHit), alpha-rejected hits re-fire the
    whole wave from just past the hit — up to cfg.alpha_rounds times, a
    static unroll. Scenes without cutout materials compile the single
    traversal only (cfg.has_alpha gates at trace time).
    """
    from tracerboy_tpu.core import vec3 as v3

    t, tri, u, v, cost = _closest_once(scene, o_v3, d_v3, t_max, cfg)
    if not cfg.has_alpha:
        return t, tri, u, v, cost
    o_cur = o_v3
    t_base = jnp.zeros_like(t_max)
    for _ in range(cfg.alpha_rounds):
        a = _alpha_at_hit(scene, tri, u, v)
        reject = (tri >= 0) & (a < ALPHA_CUTOFF)
        step = t + 1e-4 + 1e-4 * jnp.abs(t)
        o_cur = v3.where(reject, o_cur + d_v3 * step, o_cur)
        t_base = jnp.where(reject, t_base + step, t_base)
        tm2 = jnp.where(reject, jnp.maximum(t_max - t_base, 0.0), 0.0)
        t2, tri2, u2, v2, c2 = _closest_once(scene, o_cur, d_v3, tm2, cfg)
        t = jnp.where(reject, t2, t)
        tri = jnp.where(reject, tri2, tri)
        u = jnp.where(reject, u2, u)
        v = jnp.where(reject, v2, v)
        cost = cost + jnp.where(reject, c2, 0.0)
    return t + t_base, tri, u, v, cost


def _occluded_dispatch(scene, o_v3, d_v3, t_max, cfg):
    """Shadow-ray occlusion with alpha-tested transparency.

    Without cutout materials this is a pure any-hit (early-exit
    traversal / masked brute force). With them, occlusion needs hit
    points to sample alpha, so it runs the closest-hit + re-fire loop
    and only opaque hits occlude (reference AnyHit.hlsl semantics).
    Light geometry never occludes (tri_shadow_opaque, the IsLight
    pass-through of the reference's shadow feelers).
    """
    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.trace.intersect import brute_force_anyhit_soa

    shadow_opaque = scene.get("tri_shadow_opaque")
    if not cfg.has_alpha:
        if cfg.use_brute_force:
            return brute_force_anyhit_soa(
                o_v3, d_v3, scene["tri9"], t_max, tri_opaque=shadow_opaque,
            )
        return traverse_wide(
            v3.to_rows(o_v3), v3.to_rows(d_v3), t_max,
            scene["bvh_lo"], scene["bvh_hi"], scene["bvh_children"],
            scene["tri_v0"], scene["tri_v1"], scene["tri_v2"],
            leaf_size=cfg.leaf_size, any_hit=True, tri_mask=shadow_opaque,
        )

    # Alpha path: opaque-hit search; non-shadow-opaque triangles are
    # pass-through (the IsLight skip).
    occluded = t_max < 0  # all-False
    o_cur = o_v3
    t_base = jnp.zeros_like(t_max)
    budget = t_max
    for _ in range(cfg.alpha_rounds + 1):
        t, tri, u, v, _ = _closest_once(scene, o_cur, d_v3, budget, cfg)
        hit = tri >= 0
        a = _alpha_at_hit(scene, tri, u, v)
        solid = a >= ALPHA_CUTOFF
        if shadow_opaque is not None:
            T = shadow_opaque.shape[0]
            solid = solid & shadow_opaque[jnp.clip(tri, 0, T - 1)]
        occluded = occluded | (hit & solid)
        reject = hit & ~solid & ~occluded
        step = t + 1e-4 + 1e-4 * jnp.abs(t)
        o_cur = v3.where(reject, o_cur + d_v3 * step, o_cur)
        t_base = jnp.where(reject, t_base + step, t_base)
        budget = jnp.where(reject, jnp.maximum(t_max - t_base, 0.0), 0.0)
    return occluded


def _shadow_transmittance(scene, o_v3, d_v3, t_max, cfg):
    """Shadow-ray TRANSMITTANCE: glass passes light with a Fresnel
    transmission factor instead of hard-occluding.

    The reference designed exactly this march — a SHADOW_BOUNCES loop
    whose subsurface branch advances the feeler through the interface
    with Fresnel in/out factors (kernel.glsl:1447-1512) — and shipped it
    disabled (`else if(false)`, kernel.glsl:1479), so glass hard-shadows
    there. This is the working wavefront version, opt-in
    (cfg.transparent_shadows): a straight-line closest-hit march where
    zero-scatter SSS surfaces (glass) multiply (1 - Schlick(cos)) per
    interface and the ray continues; alpha cutouts pass below the
    cutoff like the any-hit path; anything else terminates at zero.
    Straight-line transmission ignores refraction bending — the same
    approximation the reference's parked code makes.

    Returns (transmittance f32 in [0, 1], per lane).
    """
    from tracerboy_tpu.core import vec3 as v3

    shadow_opaque = scene.get("tri_shadow_opaque")
    mats = scene["materials"]
    n_mat = mats["flags"].shape[0]
    T = jnp.ones_like(t_max)
    o_cur = o_v3
    t_base = jnp.zeros_like(t_max)
    budget = t_max
    for _ in range(cfg.shadow_glass_rounds + 1):
        t, tri, u, v, _ = _closest_once(scene, o_cur, d_v3, budget, cfg)
        hit = tri >= 0
        tbl = scene["tri_attr_rows"]
        rows = tbl[jnp.clip(tri, 0, tbl.shape[0] - 1)]
        mid = jnp.clip(rows[:, 15].astype(jnp.int32), 0, n_mat - 1)
        flags = mats["flags"][mid]
        scat = jnp.max(mats["scattering"][mid], axis=-1)
        is_glass = ((flags & 0x2) != 0) & (scat < 1e-6)
        is_light = (flags & 0x10) != 0
        if shadow_opaque is not None:
            # Lights are pass-through (the IsLight skip).
            Ttris = shadow_opaque.shape[0]
            is_light = is_light | ~shadow_opaque[
                jnp.clip(tri, 0, Ttris - 1)]
        if cfg.has_alpha:
            a = _alpha_at_hit(scene, tri, u, v)
            cutout = a < ALPHA_CUTOFF
        else:
            cutout = hit & False
        # Fresnel transmission at the interface (Schlick from the
        # material IOR; cos against the flat shading normal row).
        ior = mats["ior"][mid]
        nrm = v3.V3(rows[:, 0], rows[:, 1], rows[:, 2])
        cos_i = jnp.abs(v3.dot(d_v3, nrm))
        r0 = jnp.square((ior - 1.0) / jnp.maximum(ior + 1.0, 1e-6))
        fres = r0 + (1.0 - r0) * jnp.power(1.0 - cos_i, 5.0)
        passes = hit & (is_glass | is_light | cutout)
        T = jnp.where(
            hit & is_glass & ~is_light, T * (1.0 - fres), T)
        T = jnp.where(hit & ~passes, 0.0, T)
        step = t + 1e-4 + 1e-4 * jnp.abs(t)
        cont = passes & (T > 1e-4)
        o_cur = v3.where(cont, o_cur + d_v3 * step, o_cur)
        t_base = jnp.where(cont, t_base + step, t_base)
        budget = jnp.where(
            cont, jnp.maximum(t_max - t_base, 0.0), 0.0)
    # A surviving pass at the round limit is treated as occluded
    # (conservative, like the alpha loop's bounded re-fires).
    return jnp.where(budget > 0.0, 0.0, T)


@dataclass(frozen=True)
class WaveConfig:
    """Static integrator configuration (specializes the jit)."""

    width: int
    height: int
    max_bounces: int = 6
    leaf_size: int = 4
    num_lights: int = 0
    enable_nee: bool = True
    enable_ris: bool = False
    use_russian_roulette: bool = True
    filter_type: int = 0
    # Cross-pixel tent splat (CameraSettings.filter_splat): in-pixel
    # filter weights are bypassed (fw = 1) and render_wave emits the
    # jitter planes so the merged fold can splat into the 2x2
    # neighborhood (splat_fold_tent).
    filter_splat: bool = False
    filter_width: float = 1.0
    use_blue_noise: bool = True
    # "pcg" = independent counter-based randoms (+ blue-noise/Halton CP
    # for the primary streams, the reference's scheme). "sobol" =
    # padded Owen-scrambled Sobol (0,2) pairs on EVERY decision stream
    # (core/rng.py sobol2_soa) — the sampler the bundled scenes declare
    # (`Sampler "sobol"`, Scenes/*/scene.pbrt:1-6) and the low-spp
    # variance lever; overrides blue noise when set.
    sampler: str = "pcg"
    decouple_albedo: bool = False   # RealTime mode: first-hit albedo out
    has_env: bool = True
    # Environment NEE with balance-heuristic MIS. The reference reaches
    # its environment ONLY through BSDF-sampled rays that escape
    # (kernel.glsl:1327-1343); for env-lit scenes (vw-van renders under
    # the fallback dome — zero light records) every path is a binary
    # escape test, which is the dominant 8-spp variance. When enabled,
    # each diffuse-capable vertex additionally samples a cosine
    # direction toward the dome, traces an occlusion ray, and adds the
    # full-BSDF-weighted env radiance; the BSDF-escape contribution
    # recorded at miss time is MIS-downweighted by p/(p+q) so the
    # estimator stays unbiased (goldens unchanged in expectation).
    env_nee: bool = False
    # Env-NEE sample count M per diffuse-capable vertex. Interiors under
    # env light see v(1-v)/M binary-visibility variance in their direct
    # term (v = unoccluded cosine-hemisphere fraction — a few percent
    # inside vw-van), and occlusion rays are the cheapest wave traced
    # (any-hit, early out), so M > 1 buys direct-light variance at
    # ~linear shadow-ray cost. All M directions trace in ONE
    # concatenated any-hit wave; multi-sample balance heuristic
    # (Veach 9.2.2: w_i = n_i p_i / sum n_k p_k) keeps the env + escape
    # estimator pair unbiased for any M. Streams bound M to 8
    # (core/rng.py STREAM_ENV_NEE_X).
    env_nee_samples: int = 1
    # Contribution-depth split: when >= 0, the wave ALSO emits
    # radiance_early_{r,g,b} planes holding only the contributions
    # recorded at bounce iterations i <= split_early (primary
    # emissive/background at i=0, first-vertex NEE/env-NEE and
    # first-bounce escapes at i=1, ...). The late plane is exactly
    # radiance - radiance_early on the same samples, so callers get an
    # unbiased two-plane decomposition of ONE trace at a few selects'
    # cost — used for split-plane denoising experiments and as a
    # light-path AOV (the near/far light split other renderers expose
    # as LPE 'L.{0,1}' vs deeper). -1 disables (no state, no cost).
    split_early: int = -1
    # Compile-time scene facts: scenes without mix materials / textures
    # skip those fetch paths entirely.
    has_mix: bool = True
    has_textures: bool = True
    # Finer texture facts: each gathers-heavy texture path compiles only
    # if some material in the scene can reach it.
    has_emissive_tex: bool = True
    has_specular_tex: bool = True
    has_image_tex: bool = True     # any TEX_IMAGE record (bilinear fetch)
    has_scale_tex: bool = True     # any TEX_SCALE record (nesting level)
    # Alpha-tested transparency (cutout materials): rejected hits re-fire
    # the wave from just past the hit, up to alpha_rounds times
    # (SharedHitGroup.h:157-179 / AnyHit.hlsl as a wavefront re-trace).
    has_alpha: bool = False
    alpha_rounds: int = 3
    # Transmissive shadow rays (_shadow_transmittance): glass multiplies
    # a Fresnel transmission factor per interface instead of
    # hard-occluding — the reference's parked SHADOW_BOUNCES design
    # (kernel.glsl:1447-1512, disabled at 1479) made to work. Opt-in:
    # straight-line transmission is an approximation (no refraction
    # bending), so it slightly shifts the converged image.
    transparent_shadows: bool = False
    shadow_glass_rounds: int = 3
    # Normal mapping (GetDetailNormal, RayGenCommon.h:273-295).
    has_normal_maps: bool = False
    # Heterogeneous volume (scene-level density grid; the reference's
    # openvdb path, TracerBoy.cpp:1096-1184, plus the shading it lacks).
    has_volume: bool = False
    volume_steps: int = 64          # delta-tracking iteration cap (the
                                    # while_loop exits when all lanes
                                    # finish; this only bounds the RNG
                                    # stream space)
    volume_shadow_steps: int = 8    # ratio-marching samples per NEE ray
    # Phase<->light MIS at volume vertices: NEE is balance-weighted
    # against the HG-sampled continuation hitting the same light, and
    # phase-sampled light hits are added with the complementary weight
    # (exact per-tri solid-angle pdf; see the emissive-hit block).
    # False = the NEE-only estimator (rounds 1-4) for A/B tests.
    volume_light_mis: bool = True
    # Fresnel-weighted lobe selection (the reference's
    # bUseSpecularRayImportanceSampling A/B, kernel.glsl:1397-1414 and
    # 1708): pick the specular lobe with probability SpecularCoef
    # instead of 0.5 and mix the one-sample-MIS pdf with the same
    # weights. Unbiased for ANY selection probability (the pdf mix
    # compensates), so goldens are unchanged in expectation; measured on
    # vw-van's uber ground the 50/50 estimator is bimodal
    # ({~0.05, ~1.25} per sample, ~25:1 lobe contributions) and this cuts
    # raw 8-spp RMSE dramatically. The reference ships the code path but
    # leaves it compiled to false.
    spec_importance: bool = True
    # AOV production (first-hit albedo/normal/world-pos/...): required for
    # RealTime mode, denoisers and debugging; pure progressive
    # accumulation can skip the writes + padded output traffic.
    want_aovs: bool = True
    # Traversal backend:
    #  "jnp"    — lock-step masked traversal of the 8-wide BVH
    #  "brute"  — exhaustive ray x tri tests; no BVH, used for scenes up
    #             to a few thousand triangles
    traversal: str = "jnp"

    @property
    def use_brute_force(self):
        return self.traversal == "brute"


def make_blue_noise_params(scene, pixel_ids, width: int):
    """Pre-gather the 6 static per-pixel blue-noise values (the textures
    never change; only the Cranley-Patterson rotation is per-sample).
    Pass the result as params['bn'] to skip all in-wave gathers."""
    px = pixel_ids % width
    py = pixel_ids // width
    idx = (py % 256) * 256 + (px % 256)
    b0 = scene["blue0_t"]
    b1 = scene["blue1_t"]
    return (b0[0][idx], b0[1][idx], b0[2][idx], b0[3][idx],
            b1[2][idx], b1[3][idx])


ATTR_GATHER_CHUNK = 2_097_152


def _gather_rows_chunked(table, idx):
    """Row-gather `table[idx]` transposed to (width, N) with a bounded
    intermediate: lax.map over ATTR_GATHER_CHUNK-lane chunks, so very
    large merged waves never hold the whole (N, width) gather and its
    transpose at once."""
    n = idx.shape[0]
    pad = (-n) % ATTR_GATHER_CHUNK
    tp = jnp.concatenate(
        [idx, jnp.zeros((pad,), idx.dtype)]
    ).reshape(-1, ATTR_GATHER_CHUNK)

    def chunk(ix):
        rows = table[ix]
        rows = jax.lax.optimization_barrier(rows)
        return rows.T                                # (w, CHUNK)

    planes = jax.lax.map(chunk, tp)                  # (nc, w, CHUNK)
    w_tab = planes.shape[1]
    return jnp.swapaxes(planes, 0, 1).reshape(w_tab, -1)


@partial(jax.jit, static_argnames=("cfg",))
def render_wave(scene, params, pixel_ids, sample_index, cfg: WaveConfig):
    """Trace one sample for each pixel id; returns radiance + AOVs.

    scene: CompiledScene.as_pytree() dict.
    params: dict(dof_focus, dof_aperture, firefly_clamp, seed) traced.
    pixel_ids: (N,) int32 flat pixel indices.
    sample_index: traced int32 (global sample/frame counter).

    Internally everything runs in structure-of-arrays form (core/vec3.py):
    vectors are V3 tuples of dense (N,) components, so every per-ray
    plane is a contiguous array; (N, 3) appears only at the output
    boundary.
    """
    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.core.vec3 import V3
    from tracerboy_tpu.shade.bsdf import (
        diffuse_brdf_soa,
        ggx_reflection_pdf_soa,
        half_vector_safe_soa,
        refract_or_reflect_soa,
        sample_cosine_hemisphere_soa,
        sample_ggx_reflection_soa,
        sample_uniform_sphere_soa,
        specular_weight_soa,
    )
    from tracerboy_tpu.shade.env import sample_environment_soa
    from tracerboy_tpu.shade.nee import sample_one_light_soa
    from tracerboy_tpu.shade.surface import fetch_material_soa
    from tracerboy_tpu.trace.camera import generate_primary_rays_soa

    if cfg.has_volume and (cfg.volume_steps > 128):
        # vrng2 packs the walk iteration as (i << 7) + k: more than 128
        # steps would alias bounce i's RNG streams into bounce i+1's,
        # correlating delta-tracking samples (advisor finding, round 2).
        raise ValueError(
            f"volume_steps={cfg.volume_steps} > 128 would alias "
            "per-bounce volume RNG streams"
        )

    N = pixel_ids.shape[0]
    lane = pixel_ids
    seed = params.get("seed", 0)
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width
    vz = (
        pixel_ids.astype(jnp.float32)
        + jnp.asarray(sample_index, jnp.float32)
    ) * 0.0
    zero = vz
    one = vz + 1.0
    vzero3 = V3(zero, zero, zero)

    # --- sample streams --------------------------------------------------
    # Every decision draws through these two, so cfg.sampler swaps the
    # whole integrator between independent PCG randoms and padded
    # Owen-scrambled Sobol (core/rng.py) in one place.
    def hash2(bounce, stream):
        return tbrng.uniform2_soa(lane, sample_index, bounce, stream,
                                  seed, cfg.sampler)

    def hash1(bounce, stream):
        return tbrng.uniform(lane, sample_index, bounce, stream, seed,
                             cfg.sampler)

    if cfg.use_blue_noise and cfg.sampler != "sobol":
        # Static per-pixel blue-noise values: pre-gathered once by the
        # caller (make_blue_noise_params) — only the Cranley-Patterson
        # rotation depends on the sample index.
        bn = params.get("bn")
        if bn is None:
            bn_idx = (py % 256) * 256 + (px % 256)
            bn = tuple(
                scene[t][c][bn_idx]
                for t, cs in (("blue0_t", (0, 1, 2, 3)),
                              ("blue1_t", (2, 3)))
                for c in cs
            )
        shift = tbrng.halton23(jnp.asarray(sample_index))

        def rot(u, k):
            # shift is (2,) for a scalar sample_index, (N, 2) when the
            # wave merges samples (per-lane sample ids).
            return jnp.mod(u + shift[..., k], 1.0)

        jit_u, jit_v = rot(bn[0], 0), rot(bn[1], 1)
        blue_dir = (rot(bn[2], 0), rot(bn[3], 1))
        dof_u, dof_v = rot(bn[4], 0), rot(bn[5], 1)
    else:
        jit_u, jit_v = hash2(0, tbrng.STREAM_PRIMARY_JITTER)
        dof_u, dof_v = hash2(0, tbrng.STREAM_DOF)
        blue_dir = hash2(0, tbrng.STREAM_SECONDARY_DIR)

    fixed = params.get("fixed_pixel_offset")
    if fixed is not None:
        jit_u = jnp.broadcast_to(fixed[0], jit_u.shape)
        jit_v = jnp.broadcast_to(fixed[1], jit_v.shape)

    # Pixel filter weight (kernel.glsl:1843-1868).
    off_u = (jit_u - 0.5) * cfg.filter_width
    off_v = (jit_v - 0.5) * cfg.filter_width
    if cfg.filter_splat:          # weights applied at the splat fold
        fw = one
    elif cfg.filter_type == 1:    # triangle
        fw = jnp.maximum(
            jnp.maximum(0.5 - jnp.abs(off_u), 0.5 - jnp.abs(off_v)), 0.0
        )
    elif cfg.filter_type == 2:    # gaussian
        sigma = 0.8
        edge = jnp.exp(-0.5 / (sigma * sigma))
        gu = jnp.maximum(0.0, jnp.exp(-0.5 * (2 * off_u / sigma) ** 2) - edge)
        gv = jnp.maximum(0.0, jnp.exp(-0.5 * (2 * off_v / sigma) ** 2) - edge)
        fw = gu * gv
    else:
        fw = one

    origin, direction = generate_primary_rays_soa(
        scene["camera"], cfg.width, cfg.height, pixel_ids, jit_u, jit_v,
        dof_focus_distance=params.get("dof_focus", 0.0),
        dof_aperture_width=params.get("dof_aperture", 0.0),
        dof_u=dof_u, dof_v=dof_v,
        filter_width=cfg.filter_width,
    )
    if cfg.want_aovs:
        n_origin, n_direction = generate_primary_rays_soa(
            scene["camera"], cfg.width, cfg.height, pixel_ids + 1,
            jit_u, jit_v, filter_width=cfg.filter_width,
        )

    env_h, env_w = scene["env_map"].shape[0], scene["env_map"].shape[1]
    T_padded = scene["tri_attr_rows"].shape[0]

    def tri_attrs(tric):
        """Per-hit triangle attributes (normals, uvs, material id,
        tangent): one row gather from the (T, 19) row table, then one
        transpose into per-attribute planes."""
        n_rows = 19 if cfg.has_normal_maps else 16
        N_l = tric.shape[0]
        if N_l > 8 * ATTR_GATHER_CHUNK:
            planes = _gather_rows_chunked(scene["tri_attr_rows"], tric)
            return tuple(planes[j, :N_l] for j in range(n_rows))
        rows_t = scene["tri_attr_rows"][tric].T      # (19, N)
        return tuple(rows_t[j] for j in range(n_rows))

    state = dict(
        origin=origin,
        direction=direction,
        throughput=V3(one, one, one),
        radiance=vzero3,
        alive=(vz == 0.0) if params.get("active_mask") is None
        else (params["active_mask"] & (vz == 0.0)),
        prev_perfect_specular=vz != 0.0,
        inside=vz != 0.0,
        med_absorption=vzero3,
        med_scattering=vzero3,
        med_ior=one,
        rays_traced=jnp.sum(vz),
        live_end=jnp.sum(vz),
    )
    if cfg.split_early >= 0:
        state["rad_early"] = vzero3
        if cfg.has_env:
            state["miss_early"] = vz != 0.0
    if cfg.has_volume:
        # Phase pdf of the PREVIOUS vertex's HG continuation (0 = the
        # previous vertex was not a volume scatter). Carried for the
        # phase<->light MIS pair at emissive hits: NEE at a volume
        # vertex is balance-weighted against the phase-sampled
        # continuation hitting the same light, and vice versa.
        state["prev_phase_pdf"] = zero
    if cfg.has_env:
        # Lazy environment: each lane misses at most once, so the miss
        # just RECORDS (throughput, direction stays in state) and ONE
        # env fetch runs after the bounce loop — instead of a per-bounce
        # (N, 12) quad-row gather for every lane.
        state["env_throughput"] = vzero3
        if cfg.env_nee:
            state["env_mis_w"] = one
        if cfg.want_aovs or cfg.decouple_albedo:
            state["first_miss"] = vz != 0.0
    if cfg.want_aovs:
        state.update(
            aov_albedo=vzero3,
            aov_normal=vzero3,
            aov_world_pos=vzero3,
            aov_emissive=vzero3,
            aov_depth=zero,
            aov_material=jnp.full((N,), -1, jnp.int32)
            + vz.astype(jnp.int32),
            aov_diffuse_contrib=one,
            aov_neighbor_dist=zero,
            aov_heatmap=zero,
            viz_rays=jnp.zeros((cfg.max_bounces, 8), jnp.float32)
            + jnp.sum(vz),
        )
    if cfg.decouple_albedo:
        # Two-plane demodulation: rad_d accumulates the share of each
        # radiance contribution that the first-hit albedo modulates,
        # and dc_w carries that lane's first-vertex diffuse fraction
        # phi (plastic: dm/(dm+fs); metal/lambert: 1; SSS/never-shaded:
        # 0). composite = albedo*D + (I-D) + E is then EXACT per
        # sample — unlike the reference's single scalar in
        # AlbedoTexture.w (kernel.glsl:1762), which cannot represent
        # contributions with different diffuse fractions (NEE/env-NEE
        # directions vs the continuation lobe).
        state["rad_d"] = vzero3
        state["dc_w"] = zero

    def bounce(i, s):
        alive = s["alive"]

        # --- russian roulette (kernel.glsl:1288-1301) -------------------
        if cfg.use_russian_roulette:
            p = jnp.clip(v3.max_c(s["throughput"]), EPSILON, 1.0)
            r = hash1(i, tbrng.STREAM_RUSSIAN_ROULETTE)
            do_rr = alive & (i >= MIN_BOUNCES_BEFORE_RR)
            killed = do_rr & (r >= p)
            alive = alive & ~killed
            scale = jnp.where(do_rr & ~killed, 1.0 / p, 1.0)
            s["throughput"] = s["throughput"] * scale

        alive = alive & v3.any_gt(s["throughput"], EPSILON)
        s["rays_traced"] = s["rays_traced"] + jnp.sum(
            alive.astype(jnp.float32)
        )

        # --- traversal (+ alpha-tested transparency re-fire) -------------
        t_max = jnp.where(alive, BIG, 0.0)
        t, tri, u, v, trav_cost = _closest_dispatch(
            scene, s["origin"], s["direction"], t_max, cfg,
        )

        # --- heterogeneous volume: delta-tracked medium interaction -----
        # (the reference loads the grid, TracerBoy.cpp:1096-1184, but
        # never shades it; shade/volumetric.py supplies the walk). A
        # real collision preempts both the surface hit and the env miss.
        if cfg.has_volume:
            from tracerboy_tpu.shade.volumetric import (
                delta_track,
                sample_hg,
            )

            def vrng2(k):
                ub = (i << 7) + k  # cap 128 walk iters per bounce
                return (
                    hash1(ub, tbrng.STREAM_VOLUME),
                    hash1(ub, tbrng.STREAM_VOLUME + 1),
                )

            t_seg = jnp.where(tri >= 0, t, jnp.float32(BIG))
            vol_scatter, t_vsc, vol_w = delta_track(
                scene, s["origin"], s["direction"], t_seg,
                alive & ~s["inside"], vrng2, cfg.volume_steps,
            )
            s["throughput"] = s["throughput"] * vol_w
            vol_point = s["origin"] + s["direction"] * t_vsc
            vh_u, vh_v = hash2(i, tbrng.STREAM_VOLUME + 2)
            vol_dir = sample_hg(
                s["direction"], scene["vol_g"], vh_u, vh_v
            )
        else:
            vol_scatter = alive & False

        hit = alive & (tri >= 0) & ~vol_scatter
        miss = alive & (tri < 0) & ~vol_scatter

        # --- miss: environment (kernel.glsl:1327-1343), lazily ----------
        # Record the throughput at the miss; the direction is already
        # preserved in state (dead lanes stop updating it). The single
        # env fetch happens after the bounce loop.
        if cfg.has_env:
            rec = s["throughput"]
            if cfg.env_nee:
                # MIS: the BSDF-escape estimator is balance-weighted
                # against the env-NEE estimator taken at the PREVIOUS
                # vertex (w = pdf_bsdf/(pdf_bsdf + pdf_cos), carried in
                # env_mis_w; 1.0 for primary/specular/volume lanes).
                rec = rec * s["env_mis_w"]
            s["env_throughput"] = v3.where(
                miss, rec, s["env_throughput"]
            )
            if cfg.split_early >= 0:
                s["miss_early"] = s["miss_early"] | (
                    miss & (i <= cfg.split_early))
            if cfg.want_aovs or cfg.decouple_albedo:
                s["first_miss"] = s["first_miss"] | (miss & (i == 0))
        alive = alive & ~miss

        # --- hit attributes --------------------------------------------
        tric = jnp.clip(tri, 0, T_padded - 1)
        attrs = tri_attrs(tric)
        w_b = 1.0 - u - v
        sh_normal = v3.normalize(V3(
            attrs[0] * w_b + attrs[3] * u + attrs[6] * v,
            attrs[1] * w_b + attrs[4] * u + attrs[7] * v,
            attrs[2] * w_b + attrs[5] * u + attrs[8] * v,
        ))
        uv_u = attrs[9] * w_b + attrs[11] * u + attrs[13] * v
        uv_v = attrs[10] * w_b + attrs[12] * u + attrs[14] * v
        mat_id = jnp.round(attrs[15]).astype(jnp.int32)

        hit_point = s["origin"] + s["direction"] * t

        ray_dot_n = v3.dot(sh_normal, s["direction"])
        backside = ray_dot_n > 0.0
        mat = fetch_material_soa(
            scene, mat_id, uv_u, uv_v, backside, lane, sample_index, i,
            seed, has_mix=cfg.has_mix, has_textures=cfg.has_textures,
            has_emissive_tex=cfg.has_emissive_tex,
            has_specular_tex=cfg.has_specular_tex,
            has_image_tex=cfg.has_image_tex,
            has_scale_tex=cfg.has_scale_tex,
        )
        flags = mat["flags"]
        normal = v3.where(backside, -sh_normal, sh_normal)
        if cfg.has_normal_maps:
            from tracerboy_tpu.shade.surface import apply_normal_map

            tangent = V3(attrs[16], attrs[17], attrs[18])
            detail_normal = apply_normal_map(
                scene, mat["normal_tex"], normal, tangent, uv_u, uv_v
            )
        else:
            detail_normal = normal
        ray_dot_n = jnp.where(backside, -ray_dot_n, ray_dot_n)

        cur_ior = jnp.where(backside, mat["ior"], bsdf.AIR_IOR)
        new_ior = jnp.where(backside, bsdf.AIR_IOR, mat["ior"])

        # ===== medium transport (kernel.glsl:1591-1691, wavefront form) =
        in_medium = alive & s["inside"]
        mean_scat = v3.mean_c(s["med_scattering"])
        no_scatter = mean_scat < EPSILON
        dist_per_scatter = 1.0 / jnp.maximum(mean_scat, 1e-12)
        r_fly = hash1(i, tbrng.STREAM_SSS)
        travel = jnp.maximum(
            -jnp.log(jnp.maximum(r_fly, 1e-12)), 0.1
        ) * dist_per_scatter
        travel = jnp.where(no_scatter, BIG, travel)
        scatter_event = in_medium & (travel < t) & ~no_scatter
        seg = jnp.minimum(travel, t)
        beer = v3.exp(-1.0 * s["med_absorption"] * seg)
        s["throughput"] = v3.where(
            in_medium, s["throughput"] * beer, s["throughput"]
        )
        med_escaped = s["inside"] & miss
        s["throughput"] = v3.where(med_escaped, vzero3, s["throughput"])

        r_s0, r_s1 = hash2(i, tbrng.STREAM_SSS + 1)
        scat_dir = sample_uniform_sphere_soa(r_s0, r_s1)
        exit_dir, tir = refract_or_reflect_soa(
            s["direction"], normal,
            cur_ior / jnp.maximum(new_ior, 1e-6), ray_dot_n,
        )
        # Rough refraction: perturb the exit/refraction direction with a
        # pow lobe when the boundary is rough (kernel.glsl:1649-1664 via
        # GenerateImportanceSampledDirection; matched-lobe weight = 1,
        # degenerate-pdf samples are killed like the reference).
        r_l0, r_l1 = hash2(i, tbrng.STREAM_ROUGH_REFRACT)
        lobe_dir, lobe_pdf = bsdf.sample_pow_lobe_soa(
            exit_dir, mat["roughness"], r_l0, r_l1
        )
        rough_boundary = mat["roughness"] >= 0.05
        exit_dir = v3.where(rough_boundary, lobe_dir, exit_dir)
        med_exit = in_medium & ~scatter_event
        s["throughput"] = v3.where(
            med_exit & rough_boundary & (lobe_pdf < EPSILON),
            vzero3, s["throughput"],
        )
        new_inside = jnp.where(
            scatter_event, True,
            jnp.where(med_exit & ~tir, False, s["inside"]),
        )
        med_dir = v3.where(scatter_event, scat_dir, exit_dir)
        med_org = v3.where(
            scatter_event,
            s["origin"] + s["direction"] * seg,
            hit_point + v3.where(tir, normal * EPSILON, normal * -EPSILON),
        )

        # ===== surface shading =========================================
        shading = alive & ~s["inside"]
        if cfg.has_volume:
            shading = shading & ~vol_scatter
        is_light = (flags & LIGHT_FLAG) != 0
        allows_spec = (flags & NO_SPECULAR_FLAG) == 0
        is_metal = ((flags & METALLIC_FLAG) != 0) | ((flags & HAIR_FLAG) != 0)
        is_sss = (flags & SUBSURFACE_SCATTER_FLAG) != 0
        single_sided = (flags & SINGLE_SIDED_FLAG) != 0

        r_spec = hash1(i, tbrng.STREAM_SPECULAR_SELECT)
        if cfg.spec_importance:
            # Lobe probability ∝ each lobe's expected energy at THIS
            # incidence. The reference's disabled A/B (kernel.glsl:1410)
            # uses the normal-incidence coefficient alone, which
            # under-samples the specular lobe at grazing angles where
            # Schlick Fresnel → 1 (measured: rare 25x fireflies on the
            # far ground more than undo the win). Balancing incident
            # Fresnel against the diffuse albedo fixes both ends; any
            # p in (0,1) is unbiased (the MIS pdf mix compensates).
            refl0 = mat["specular_coef"]
            cos_i = jnp.abs(ray_dot_n)
            f_i = refl0 + (1.0 - refl0) * jnp.power(1.0 - cos_i, 5.0)
            alb_avg = (mat["albedo"].x + mat["albedo"].y
                       + mat["albedo"].z) * (1.0 / 3.0)
            p_spec = jnp.clip(
                f_i / jnp.maximum(f_i + (1.0 - f_i) * alb_avg, 1e-6),
                0.05, 0.95,
            )
            # Dielectric/SSS media keep the reference's 50/50: their
            # reflect-vs-refract split is an UNCOMPENSATED branch weight
            # (the refraction branch applies no pdf or 1/(1-p) factor,
            # kernel.glsl:1640-1691), so the probability there is part
            # of the material model, not a free importance choice.
            p_spec = jnp.where(is_sss, 0.5, p_spec)
        else:
            p_spec = 0.5 * one
        spec_ray = allows_spec & (is_metal | (r_spec < p_spec))
        perfect_spec = spec_ray & (mat["roughness"] < 0.05)

        take_emissive = (
            s["prev_perfect_specular"] | (i == 0) | ~is_light
            | (not cfg.enable_nee)
        )
        add_emissive = shading & take_emissive
        if cfg.decouple_albedo:
            # First-hit emissive rides the E AOV plane EXCLUSIVELY so
            # the composite (albedo*D + (I-D) + E) does not count it
            # twice; later-bounce emissive is a throughput-modulated
            # contribution like any other.
            add_emissive = add_emissive & (i > 0)
            s["rad_d"] = v3.where(
                add_emissive,
                s["rad_d"] + s["throughput"] * mat["emissive"]
                * s["dc_w"],
                s["rad_d"],
            )
        s["radiance"] = v3.where(
            add_emissive,
            s["radiance"] + s["throughput"] * mat["emissive"],
            s["radiance"],
        )
        if cfg.split_early >= 0:
            s["rad_early"] = v3.where(
                add_emissive & (i <= cfg.split_early),
                s["rad_early"] + s["throughput"] * mat["emissive"],
                s["rad_early"],
            )
        if (cfg.has_volume and cfg.volume_light_mis and cfg.enable_nee
                and cfg.num_lights > 0):
            # Phase<->light MIS, phase side: a lane whose previous
            # vertex was a volume scatter hit a light the NEE-only
            # convention would drop. Add it balance-weighted against
            # the solid-angle pdf NEE had for this exact light point:
            # p_L = t^2 / (num_lights * tri_area * cos) — exact because
            # light records are per-triangle (scene/compile.py
            # add_light_records). Front side only (ray_dot_n < 0),
            # matching NEE's `facing` test.
            T_area = scene["tri_area"].shape[0]
            tri_a = jnp.clip(tric, 0, T_area - 1)
            a_hit = scene["tri_area"][tri_a]
            p_ph = s["prev_phase_pdf"]
            p_lw_hit = (t * t) / jnp.maximum(
                cfg.num_lights * a_hit * jnp.abs(ray_dot_n), 1e-9)
            w_ph = p_ph / jnp.maximum(p_ph + p_lw_hit, 1e-12)
            vol_emis = (
                shading & is_light & ~take_emissive & (p_ph > 0.0)
                & (ray_dot_n < 0.0) & (tri_a == tric)
            )
            s["radiance"] = v3.where(
                vol_emis,
                s["radiance"] + s["throughput"] * mat["emissive"] * w_ph,
                s["radiance"],
            )
            if cfg.split_early >= 0:
                s["rad_early"] = v3.where(
                    vol_emis & (i <= cfg.split_early),
                    s["rad_early"]
                    + s["throughput"] * mat["emissive"] * w_ph,
                    s["rad_early"],
                )
            if cfg.decouple_albedo:
                s["rad_d"] = v3.where(
                    vol_emis,
                    s["rad_d"] + s["throughput"] * mat["emissive"]
                    * w_ph * s["dc_w"],
                    s["rad_d"],
                )

        # --- first-hit AOVs (RayGenCommon.h:524-654) --------------------
        first = (i == 0) & shading
        if cfg.want_aovs:
            s["aov_world_pos"] = v3.where(first, hit_point,
                                          s["aov_world_pos"])
            s["aov_normal"] = v3.where(first, detail_normal,
                                       s["aov_normal"])
            s["aov_depth"] = jnp.where(first, t, s["aov_depth"])
            s["aov_material"] = jnp.where(first, mat_id, s["aov_material"])
            s["aov_albedo"] = v3.where(first, mat["albedo"],
                                       s["aov_albedo"])
            s["aov_emissive"] = v3.where(first, mat["emissive"],
                                         s["aov_emissive"])
            n_hit = n_origin + n_direction * t
            s["aov_neighbor_dist"] = jnp.where(
                first, v3.length(n_hit - hit_point), s["aov_neighbor_dist"]
            )
            s["aov_heatmap"] = jnp.where(i == 0, trav_cost,
                                         s["aov_heatmap"])

        # Ray-path visualization for the selected pixel.
        sel = params.get("selected_pixel")
        if sel is not None and cfg.want_aovs:
            is_sel = ((lane == sel) & alive).astype(jnp.float32)
            def selsum(a):
                return jnp.sum(a * is_sel)
            seg_row = jnp.stack([
                selsum(s["origin"].x), selsum(s["origin"].y),
                selsum(s["origin"].z), selsum(hit_point.x),
                selsum(hit_point.y), selsum(hit_point.z),
                selsum(t), jnp.sum(is_sel),
            ])
            s["viz_rays"] = s["viz_rays"].at[i].set(seg_row)

        # --- NEE (kernel.glsl:1435-1517) --------------------------------
        if cfg.enable_nee and cfg.num_lights > 0:
            nee_org = hit_point
            if cfg.has_volume:
                nee_org = v3.where(vol_scatter, vol_point, nee_org)
            ls = sample_one_light_soa(
                scene["lights"], cfg.num_lights, nee_org, lane,
                sample_index, i, use_ris=cfg.enable_ris, seed=seed,
                sampler=cfg.sampler,
            )
            facing = v3.dot(ls["direction"], ls["normal"]) < 0.0
            do_nee = (
                shading & ~perfect_spec & ~is_light
                & (ls["pdf"] > EPSILON) & facing
            )
            if cfg.has_volume:
                # Volume scatter vertices also draw a light sample,
                # weighted by the HG phase instead of a BRDF.
                do_nee = do_nee | (
                    vol_scatter & (ls["pdf"] > EPSILON) & facing
                )
            s["rays_traced"] = s["rays_traced"] + jnp.sum(
                do_nee.astype(jnp.float32)
            )
            sh_org = hit_point + normal * EPSILON
            if cfg.has_volume:
                sh_org = v3.where(vol_scatter, vol_point, sh_org)
            sh_tmax = jnp.where(do_nee, ls["distance"] * (1.0 - 1e-3), 0.0)
            if cfg.transparent_shadows:
                sh_T = _shadow_transmittance(
                    scene, sh_org, ls["direction"], sh_tmax, cfg
                )
                occluded = sh_T <= 1e-4
            else:
                sh_T = None
                occluded = _occluded_dispatch(
                    scene, sh_org, ls["direction"], sh_tmax, cfg
                )
            surf_w = diffuse_brdf_soa(ls["direction"], detail_normal)
            if cfg.has_volume:
                # Henyey-Greenstein phase value at the volume vertex —
                # also the pdf of the phase-sampled competitor
                # (sample_hg draws proportional to the phase), so the
                # balance weight against it is exact. p_L is converted
                # to solid angle (pdf_area * d^2 / cos); directional
                # lights (distance 1e9) drive the weight to 1, matching
                # their delta pdf (phase sampling cannot hit them).
                from tracerboy_tpu.shade.volumetric import hg_pdf

                g = scene["vol_g"]
                cos_lv = v3.dot(s["direction"], ls["direction"])
                phase_val = hg_pdf(cos_lv, g)
                cos_light = jnp.abs(
                    v3.dot(ls["normal"], ls["direction"]))
                p_lw = (ls["pdf"] * ls["distance"] ** 2
                        / jnp.maximum(cos_light, 1e-6))
                if cfg.volume_light_mis:
                    w_vol_nee = p_lw / jnp.maximum(
                        p_lw + phase_val, 1e-12)
                else:
                    w_vol_nee = 1.0
                surf_w = jnp.where(
                    vol_scatter, phase_val * w_vol_nee, surf_w)
            light_mult = (
                ls["attenuation"]
                * surf_w
                * jnp.abs(v3.dot(ls["normal"], ls["direction"]))
                / jnp.maximum(ls["pdf"], 1e-12)
            )
            if sh_T is not None:
                light_mult = light_mult * sh_T
            add = do_nee & ~occluded
            nee_albedo = mat["albedo"]
            if cfg.decouple_albedo:
                # Demodulate the first vertex's direct light: NEE is
                # diffuse-weighted (kernel.glsl:1515), so its albedo
                # factor is exactly what the composite re-applies.
                nee_albedo = v3.where(
                    (i == 0) & shading, V3(one, one, one), nee_albedo
                )
            if cfg.has_volume:
                from tracerboy_tpu.shade.volumetric import transmittance

                nee_albedo = v3.where(
                    vol_scatter, V3(one, one, one), nee_albedo
                )
                # Attenuate every shadow segment through the volume
                # (ratio marching, jittered).
                sh_jit = hash1(i, tbrng.STREAM_VOLUME_SHADOW)
                t_vol = transmittance(
                    scene, sh_org, ls["direction"], sh_tmax, do_nee,
                    sh_jit, cfg.volume_shadow_steps,
                )
            else:
                t_vol = V3(one, one, one)
            contrib = s["throughput"] * nee_albedo * ls["color"] * t_vol
            s["radiance"] = v3.where(
                add, s["radiance"] + contrib * light_mult, s["radiance"]
            )
            if cfg.split_early >= 0:
                s["rad_early"] = v3.where(
                    add & (i <= cfg.split_early),
                    s["rad_early"] + contrib * light_mult,
                    s["rad_early"],
                )
            if cfg.decouple_albedo:
                # Diffuse NEE at the first SURFACE vertex is fully
                # albedo-modulated (w=1); a first-bounce VOLUME vertex
                # never writes the albedo AOV, so its weight stays the
                # lane's dc_w (0 unless it shaded at i==0).
                w_nee = jnp.where((i == 0) & shading, 1.0, s["dc_w"])
                s["rad_d"] = v3.where(
                    add, s["rad_d"] + contrib * light_mult * w_nee,
                    s["rad_d"],
                )

        died_on_light = shading & is_light

        # --- BSDF sampling ----------------------------------------------
        rh_u, rh_v = hash2(i, tbrng.STREAM_SECONDARY_DIR)
        r_u = jnp.where(i == 0, blue_dir[0], rh_u)
        r_v = jnp.where(i == 0, blue_dir[1], rh_v)

        spec_dir = sample_ggx_reflection_soa(
            s["direction"], detail_normal, mat["roughness"], r_u, r_v
        )
        diff_dir, _ = sample_cosine_hemisphere_soa(detail_normal, r_u, r_v)
        sss_dir, sss_tir = refract_or_reflect_soa(
            s["direction"], normal,
            cur_ior / jnp.maximum(new_ior, 1e-6), ray_dot_n,
        )
        # Rough refraction on medium ENTRY too (kernel.glsl:1535-1556).
        entry_lobe, entry_pdf = bsdf.sample_pow_lobe_soa(
            sss_dir, mat["roughness"], r_l0, r_l1
        )
        sss_dir = v3.where(rough_boundary, entry_lobe, sss_dir)

        surf_sss = shading & is_sss & ~spec_ray
        s["throughput"] = v3.where(
            surf_sss & rough_boundary & (entry_pdf < EPSILON),
            vzero3, s["throughput"],
        )
        new_dir = v3.where(
            spec_ray, spec_dir, v3.where(is_sss, sss_dir, diff_dir)
        )

        entering = surf_sss & ~single_sided & ~sss_tir
        new_inside2 = jnp.where(shading, entering, new_inside)
        s["med_absorption"] = v3.where(
            entering, mat["absorption"], s["med_absorption"]
        )
        s["med_scattering"] = v3.where(
            entering, mat["scattering"], s["med_scattering"]
        )
        s["med_ior"] = jnp.where(entering, mat["ior"], s["med_ior"])

        # --- throughput update (kernel.glsl:1699-1772) ------------------
        prev_dir = s["direction"]
        diffuse_pdf = v3.dot(new_dir, detail_normal) / jnp.pi
        half = half_vector_safe_soa(-prev_dir, new_dir, detail_normal)
        spec_pdf = ggx_reflection_pdf_soa(detail_normal, new_dir, half,
                                          mat["roughness"])
        # One-sample MIS over the two lobes: mix(SpecularPDF, DiffusePDF,
        # 1 - p_spec) (kernel.glsl:1708-1710; p_spec = 0.5 in the
        # reference default, ReflectionCoefficient when importance
        # sampling is on).
        pdf = jnp.where(
            allows_spec,
            jnp.where(is_metal, spec_pdf,
                      p_spec * spec_pdf + (1.0 - p_spec) * diffuse_pdf),
            diffuse_pdf,
        )
        inv_pdf = 1.0 / jnp.maximum(pdf, 1e-8)

        albedo = mat["albedo"]
        if cfg.decouple_albedo:
            albedo = v3.where(i == 0, V3(one, one, one), albedo)

        spec_w = specular_weight_soa(
            prev_dir, new_dir, normal, detail_normal, mat["roughness"]
        )
        cos_sat = jnp.clip(v3.dot(new_dir, normal), 0.0, 1.0)
        metal_mult = albedo * (spec_w * cos_sat)

        refl_coef = mat["specular_coef"]
        fresnel = refl_coef + (1.0 - refl_coef) * jnp.power(
            jnp.abs(1.0 - v3.dot(-prev_dir, half)), 5.0
        )
        diffuse_multiplier = (
            (28.0 / (23.0 * jnp.pi))
            * (1.0 - refl_coef)
            * (1.0 - jnp.power(1.0 - 0.5 * v3.dot(-prev_dir, normal), 5.0))
            * (1.0 - jnp.power(1.0 - 0.5 * v3.dot(new_dir, normal), 5.0))
        )
        plastic_mult = V3(
            (albedo.x * diffuse_multiplier + fresnel * spec_w) * cos_sat,
            (albedo.y * diffuse_multiplier + fresnel * spec_w) * cos_sat,
            (albedo.z * diffuse_multiplier + fresnel * spec_w) * cos_sat,
        )
        # Demodulation blend ratio (CompositeAlbedoCS.hlsl:22-25). The
        # reference divides by saturate(cos) unguarded (kernel.glsl:1762),
        # which inflates the ratio at grazing angles and emits inf when
        # the sampled lobe falls below the surface. The EXACT identity —
        # composite(white-albedo trace) == plain trace per sample — is
        # cos-free: plastic_mult = (albedo*dm + fs)*cos, so the
        # albedo-modulated fraction is dm/(dm + fs). Clamped to [0,1]
        # (it is a convex blend weight).
        diffuse_contrib = jnp.clip(
            (albedo.x * diffuse_multiplier) / jnp.maximum(
                diffuse_multiplier + fresnel * spec_w, 1e-8
            ),
            0.0, 1.0,
        )
        lambert_mult = albedo * diffuse_brdf_soa(new_dir, detail_normal)

        surface_mult = v3.where(
            is_metal, metal_mult,
            v3.where(allows_spec, plastic_mult, lambert_mult),
        )
        surface_mult = v3.where(surf_sss, V3(one, one, one), surface_mult)
        surface_scale = jnp.where(surf_sss, 1.0, inv_pdf)

        if cfg.decouple_albedo:
            # First-vertex diffuse fraction phi: the share of this
            # vertex's continuation multiplier that the (white-
            # substituted) albedo modulates. SSS/dielectric boundaries
            # apply no albedo (tint lives in the medium) -> 0.
            phi = jnp.where(
                surf_sss, 0.0,
                jnp.where(is_metal | ~allows_spec, 1.0, diffuse_contrib),
            )
            s["dc_w"] = jnp.where(first, phi, s["dc_w"])

        # --- environment NEE with MIS ------------------------------------
        # No reference analog: kernel.glsl reaches the environment ONLY
        # via BSDF-sampled rays that escape (kernel.glsl:1327-1343), so
        # env-lit scenes (vw-van renders under the fallback dome — zero
        # light records) see every path as a binary escape test. Here
        # each diffuse-capable vertex additionally draws a cosine sample
        # toward the dome, traces an occlusion ray, and adds the
        # full-BSDF-weighted env radiance; both estimators are combined
        # with the balance heuristic so the sum stays unbiased.
        if cfg.has_env and cfg.env_nee:
            # M cosine-hemisphere samples toward the dome
            # (cfg.env_nee_samples). Multi-sample balance heuristic
            # (Veach 9.2.2, n_env = M vs n_escape = 1): each env sample
            # is weighted M*p_env/(M*p_env + p_bsdf) and averaged; the
            # escape estimator below divides by (p + M*q). Furnace
            # closure for diffuse/white-dome: sum_j w_j/M = M/(M+1),
            # escape 1/(M+1).
            M = max(1, int(cfg.env_nee_samples))
            assert M <= 8, "env_nee_samples > 8 exceeds STREAM_ENV_NEE_X"
            e_dirs, e_pdfs = [], []
            for j in range(M):
                stream = (tbrng.STREAM_ENV_NEE if j == 0
                          else tbrng.STREAM_ENV_NEE_X + 2 * (j - 1))
                r_e0, r_e1 = hash2(i, stream)
                d_j, p_j = sample_cosine_hemisphere_soa(
                    detail_normal, r_e0, r_e1
                )
                e_dirs.append(d_j)
                e_pdfs.append(p_j)
            env_base = shading & ~perfect_spec & ~is_light & ~surf_sss
            do_envs = [env_base & (p_j > EPSILON) for p_j in e_pdfs]
            do_env = do_envs[0]
            for d_j in do_envs[1:]:
                do_env = do_env | d_j
            s["rays_traced"] = s["rays_traced"] + sum(
                jnp.sum(d_j.astype(jnp.float32)) for d_j in do_envs
            )
            e_org = hit_point + normal * EPSILON
            e_tmaxs = [jnp.where(d_j, BIG, 0.0) for d_j in do_envs]
            # ONE concatenated any-hit wave for all M directions: one
            # traversal loop instead of M.
            if M == 1:
                dir_cat, org_cat, tmax_cat = e_dirs[0], e_org, e_tmaxs[0]
            else:
                cat = jnp.concatenate
                dir_cat = V3(cat([d.x for d in e_dirs]),
                             cat([d.y for d in e_dirs]),
                             cat([d.z for d in e_dirs]))
                org_cat = V3(jnp.tile(e_org.x, M), jnp.tile(e_org.y, M),
                             jnp.tile(e_org.z, M))
                tmax_cat = cat(e_tmaxs)

            def _split(a):
                return [a[j * N_lanes:(j + 1) * N_lanes] for j in range(M)]

            N_lanes = hit_point.x.shape[0]
            if cfg.transparent_shadows:
                e_T_cat = _shadow_transmittance(
                    scene, org_cat, dir_cat, tmax_cat, cfg
                )
                e_Ts = _split(e_T_cat) if M > 1 else [e_T_cat]
                e_occs = [t_j <= 1e-4 for t_j in e_Ts]
            else:
                e_Ts = None
                occ_cat = _occluded_dispatch(
                    scene, org_cat, dir_cat, tmax_cat, cfg)
                e_occs = _split(occ_cat) if M > 1 else [occ_cat]

            e_contrib_sum = V3(zero, zero, zero)
            e_contrib_d_sum = V3(zero, zero, zero)
            e_add_any = do_env & False
            invM = 1.0 / M
            for j in range(M):
                env_dir, env_pdf = e_dirs[j], e_pdfs[j]
                # BSDF pdf of the env direction under the same
                # mixed-lobe model as the throughput update below
                # (balance denominator must mirror the escape
                # estimator's pdf).
                e_half = half_vector_safe_soa(
                    -prev_dir, env_dir, detail_normal)
                e_dpdf = jnp.maximum(
                    v3.dot(env_dir, detail_normal), 0.0) / jnp.pi
                e_spdf = ggx_reflection_pdf_soa(
                    detail_normal, env_dir, e_half, mat["roughness"]
                )
                e_bsdf_pdf = jnp.where(
                    allows_spec,
                    jnp.where(is_metal, e_spdf,
                              p_spec * e_spdf + (1.0 - p_spec) * e_dpdf),
                    e_dpdf,
                )
                w_env = (M * env_pdf) / jnp.maximum(
                    M * env_pdf + e_bsdf_pdf, 1e-12)
                # Full BSDF at env_dir (metal / plastic / lambert, the
                # same model the throughput update applies).
                e_spec_w = specular_weight_soa(
                    prev_dir, env_dir, normal, detail_normal,
                    mat["roughness"]
                )
                e_cos = jnp.clip(v3.dot(env_dir, normal), 0.0, 1.0)
                e_fres = refl_coef + (1.0 - refl_coef) * jnp.power(
                    jnp.abs(1.0 - v3.dot(-prev_dir, e_half)), 5.0
                )
                e_dm = (
                    (28.0 / (23.0 * jnp.pi))
                    * (1.0 - refl_coef)
                    * (1.0 - jnp.power(
                        1.0 - 0.5 * v3.dot(-prev_dir, normal), 5.0))
                    * (1.0 - jnp.power(
                        1.0 - 0.5 * v3.dot(env_dir, normal), 5.0))
                )
                e_mult = v3.where(
                    is_metal, albedo * (e_spec_w * e_cos),
                    v3.where(
                        allows_spec,
                        V3((albedo.x * e_dm + e_fres * e_spec_w) * e_cos,
                           (albedo.y * e_dm + e_fres * e_spec_w) * e_cos,
                           (albedo.z * e_dm + e_fres * e_spec_w) * e_cos),
                        albedo * e_dpdf,
                    ),
                )
                e_add = do_envs[j] & ~e_occs[j]
                e_add_any = e_add_any | e_add
                if "env_quad" in scene:
                    from tracerboy_tpu.shade.env import (
                        sample_environment_quad_soa,
                    )

                    e_env = sample_environment_quad_soa(
                        env_dir, scene["env_quad"], env_h, env_w,
                        scene["env_transform"], scene["env_color_scale"],
                        gather_mask=e_add,
                    )
                else:
                    e_env = sample_environment_soa(
                        env_dir, scene["env_r"], scene["env_g"],
                        scene["env_b"], env_h, env_w,
                        scene["env_transform"], scene["env_color_scale"],
                    )
                e_gain = (w_env * invM) / jnp.maximum(env_pdf, 1e-12)
                if e_Ts is not None:
                    e_gain = e_gain * e_Ts[j]
                if cfg.has_volume:
                    # The opaque-BVH occlusion test alone would add FULL
                    # env radiance through the medium — biased bright
                    # (advisor, round 3). Attenuate the env shadow
                    # segment with the same ratio-marched transmittance
                    # regular NEE applies.
                    from tracerboy_tpu.shade.volumetric import (
                        transmittance,
                    )

                    e_jit = hash1(i, tbrng.STREAM_ENV_NEE_SHADOW)
                    e_tvol = transmittance(
                        scene, e_org, env_dir, e_tmaxs[j], do_envs[j],
                        e_jit, cfg.volume_shadow_steps,
                    )
                else:
                    e_tvol = V3(one, one, one)
                e_contrib = (s["throughput"] * e_mult * e_env * e_gain
                             * e_tvol)
                e_contrib = v3.where(e_add, e_contrib,
                                     V3(zero, zero, zero))
                e_contrib_sum = e_contrib_sum + e_contrib
                if cfg.decouple_albedo:
                    # The env-NEE direction has its OWN diffuse fraction
                    # (e_dm vs e_fres*e_spec_w), distinct from the
                    # continuation lobe's phi — the one-scalar reference
                    # scheme cannot represent this; the two-plane one
                    # can.
                    e_phi = jnp.where(
                        is_metal | ~allows_spec, 1.0,
                        jnp.clip(e_dm / jnp.maximum(
                            e_dm + e_fres * e_spec_w, 1e-8), 0.0, 1.0),
                    )
                    w_ed = jnp.where((i == 0) & shading, e_phi, s["dc_w"])
                    e_contrib_d_sum = e_contrib_d_sum + e_contrib * w_ed
            s["radiance"] = v3.where(
                e_add_any, s["radiance"] + e_contrib_sum, s["radiance"]
            )
            if cfg.split_early >= 0:
                s["rad_early"] = v3.where(
                    e_add_any & (i <= cfg.split_early),
                    s["rad_early"] + e_contrib_sum,
                    s["rad_early"],
                )
            if cfg.decouple_albedo:
                s["rad_d"] = v3.where(
                    e_add_any, s["rad_d"] + e_contrib_d_sum, s["rad_d"]
                )
            # Carry the escape-side balance weight for THIS vertex's
            # sampled lobe: applied if the continuation ray misses.
            # M env samples -> the env technique's density is M*q.
            w_escape = pdf / jnp.maximum(
                pdf + M * jnp.maximum(diffuse_pdf, 0.0), 1e-12
            )
            s["env_mis_w"] = jnp.where(
                do_env, w_escape,
                jnp.where(shading | vol_scatter | in_medium, 1.0,
                          s["env_mis_w"]),
            )

        if cfg.want_aovs:
            s["aov_diffuse_contrib"] = jnp.where(
                first & allows_spec & ~is_metal, diffuse_contrib,
                s["aov_diffuse_contrib"],
            )

        apply_surface = shading & ~died_on_light
        s["throughput"] = v3.where(
            apply_surface,
            s["throughput"] * surface_mult * surface_scale,
            s["throughput"],
        )

        # --- commit new ray state --------------------------------------
        new_origin = v3.where(
            surf_sss,
            hit_point + v3.where(sss_tir, normal * EPSILON,
                                 normal * -EPSILON),
            hit_point + normal * EPSILON,
        )
        s["origin"] = v3.where(
            in_medium, med_org, v3.where(shading, new_origin, s["origin"])
        )
        s["direction"] = v3.where(
            in_medium, med_dir, v3.where(shading, new_dir, s["direction"])
        )
        s["inside"] = jnp.where(
            in_medium, new_inside,
            jnp.where(shading, new_inside2, s["inside"]),
        )
        s["prev_perfect_specular"] = jnp.where(
            shading, perfect_spec, s["prev_perfect_specular"]
        )
        if cfg.has_volume:
            # Volume scatter: continue from the collision point along the
            # HG-sampled direction (pdf == phase, weight 1; the albedo
            # was folded into the delta-tracking weight). Record the
            # continuation's phase pdf (s["direction"] still holds the
            # INCOMING direction for vol lanes here) so the next bounce
            # can MIS-weight an emissive hit against volume NEE.
            from tracerboy_tpu.shade.volumetric import hg_pdf

            s["prev_phase_pdf"] = jnp.where(
                vol_scatter,
                hg_pdf(v3.dot(s["direction"], vol_dir), scene["vol_g"]),
                0.0,
            )
            s["origin"] = v3.where(vol_scatter, vol_point, s["origin"])
            s["direction"] = v3.where(vol_scatter, vol_dir, s["direction"])
            s["prev_perfect_specular"] = jnp.where(
                vol_scatter, False, s["prev_perfect_specular"]
            )
        s["alive"] = alive & ~died_on_light & ~med_escaped
        s["live_end"] = jnp.sum(s["alive"].astype(jnp.float32))
        return s

    # Bounce 0 is PEELED out of the fori_loop: its i is a python int, so
    # the i == 0-only code (AOVs, primary blue-noise directions) folds
    # away statically in both copies of the bounce body.
    if cfg.max_bounces > 0:
        state = bounce(0, state)
    if cfg.max_bounces > 1:
        state = jax.lax.fori_loop(1, cfg.max_bounces, bounce, state)

    radiance = state["radiance"]
    if cfg.has_env:
        # Deferred environment fetch: one quad-row gather for the whole
        # wave. env_throughput is zero for lanes that never missed.
        missed = v3.any_gt(state["env_throughput"], 0.0)
        if "env_quad" in scene:
            from tracerboy_tpu.shade.env import sample_environment_quad_soa

            env = sample_environment_quad_soa(
                state["direction"], scene["env_quad"], env_h, env_w,
                scene["env_transform"], scene["env_color_scale"],
                gather_mask=missed,
            )
        else:
            env = sample_environment_soa(
                state["direction"], scene["env_r"], scene["env_g"],
                scene["env_b"], env_h, env_w,
                scene["env_transform"], scene["env_color_scale"],
            )
        env_contrib = state["env_throughput"] * env
        if cfg.decouple_albedo:
            # Primary-miss env rides the E plane exclusively (the
            # composite adds it back); indirect escapes carry the
            # lane's first-vertex diffuse fraction into D.
            live_env = v3.where(state["first_miss"], vzero3, env_contrib)
            radiance = radiance + live_env
            state["rad_d"] = state["rad_d"] + live_env * state["dc_w"]
        else:
            radiance = radiance + env_contrib
        if cfg.split_early >= 0:
            state["rad_early"] = state["rad_early"] + v3.where(
                state["miss_early"], env_contrib, vzero3
            )
        if cfg.want_aovs:
            state["aov_emissive"] = v3.where(
                state["first_miss"], env_contrib, state["aov_emissive"]
            )
    clamp = params.get("firefly_clamp", 0.0)
    do_clamp = clamp >= EPSILON
    radiance = V3(
        jnp.where(do_clamp, jnp.minimum(radiance.x, clamp), radiance.x),
        jnp.where(do_clamp, jnp.minimum(radiance.y, clamp), radiance.y),
        jnp.where(do_clamp, jnp.minimum(radiance.z, clamp), radiance.z),
    )
    radiance = v3.where(v3.isnan_any(radiance), vzero3, radiance)

    if params.get("active_mask") is not None:
        fw = jnp.where(params["active_mask"], fw, 0.0)

    rad = radiance * fw
    out = dict(
        # Dense channel planes (accumulated per plane).
        radiance_r=rad.x, radiance_g=rad.y, radiance_b=rad.z,
        filter_weight=fw,
        rays_traced=state["rays_traced"],
        live_end=state["live_end"],
    )
    if cfg.filter_splat:
        out["jit_u"] = jit_u
        out["jit_v"] = jit_v
    if cfg.split_early >= 0:
        # Same clamp/NaN policy as the total so early + late (= total -
        # early) stays an exact partition under the default clamp-off
        # gate config; a nonzero firefly clamp bounds each plane
        # independently (the partition then holds only approximately).
        rad_e = state["rad_early"]
        rad_e = V3(
            jnp.where(do_clamp, jnp.minimum(rad_e.x, clamp), rad_e.x),
            jnp.where(do_clamp, jnp.minimum(rad_e.y, clamp), rad_e.y),
            jnp.where(do_clamp, jnp.minimum(rad_e.z, clamp), rad_e.z),
        )
        rad_e = v3.where(v3.isnan_any(rad_e), vzero3, rad_e) * fw
        out["radiance_early_r"] = rad_e.x
        out["radiance_early_g"] = rad_e.y
        out["radiance_early_b"] = rad_e.z
    if cfg.decouple_albedo:
        rad_d = v3.where(
            v3.isnan_any(state["rad_d"]), vzero3, state["rad_d"]
        )
        out["radiance_d"] = v3.to_rows(rad_d * fw)
    if cfg.want_aovs:
        out.update(
            radiance=v3.to_rows(rad),
            albedo=v3.to_rows(state["aov_albedo"]),
            normal=v3.to_rows(state["aov_normal"]),
            world_pos=v3.to_rows(state["aov_world_pos"]),
            depth=state["aov_depth"],
            emissive=v3.to_rows(state["aov_emissive"]),
            material=state["aov_material"],
            diffuse_contrib=state["aov_diffuse_contrib"],
            neighbor_dist=state["aov_neighbor_dist"],
            heatmap=state["aov_heatmap"],
            viz_rays=state["viz_rays"],
        )
    return out


def splat_fold_tent(rad_r, rad_g, rad_b, jit_u, jit_v, W: int, H: int,
                    k: int):
    """Fold a k-merged full-film wave into per-pixel sums through a
    partition-of-unity TENT reconstruction splat (pbrt's triangle
    filter at radius 1): the sample at film position (x + ju, y + jv)
    contributes weight (1-|dx+0.5-ju|)+ * (1-|dy+0.5-jv|)+ to pixel
    (x+dx, y+dy) — exactly the 2x2 nearest pixel centers, weights
    summing to 1 (so total energy matches the box fold away from film
    borders; border losses normalize out through the accumulated
    filter weight at resolve).

    Why: each pixel's estimate then averages ~4k samples with tent
    weights, n_eff/n = (E w)^2/(E w^2) = 1.5 per axis -> ~2.25x
    effective samples for smooth content, at a tent's worth of
    reconstruction blur. Converged goldens must use the same filter.
    Implemented as 9 shifted adds of (k, H, W) planes — pure VPU work,
    noise-level next to traversal.
    """
    def img(a):
        return a.reshape(k, H, W)

    ju, jv = img(jit_u), img(jit_v)
    planes = [img(rad_r), img(rad_g), img(rad_b)]
    acc = [jnp.zeros((H, W), jnp.float32) for _ in range(4)]
    for dy in (-1, 0, 1):
        wy = jnp.maximum(1.0 - jnp.abs(dy + 0.5 - jv), 0.0)
        for dx in (-1, 0, 1):
            w = wy * jnp.maximum(1.0 - jnp.abs(dx + 0.5 - ju), 0.0)
            srcs = [(w * p).sum(0) for p in planes] + [w.sum(0)]
            for i, src in enumerate(srcs):
                pad = jnp.pad(src, 1)
                acc[i] = acc[i] + jax.lax.dynamic_slice(
                    pad, (1 - dy, 1 - dx), (H, W))
    return tuple(a.reshape(-1) for a in acc)


@partial(jax.jit, static_argnames=("cfg", "k", "fold_aovs", "fold_var"))
def render_wave_merged(scene, params, pixel_ids, base_sample, k: int,
                       cfg: WaveConfig, fold_aovs: bool = False,
                       fold_var: bool = False):
    """Trace k samples per pixel in ONE wave of k*N lanes.

    Cross-sample regeneration: the k samples of a pixel ride one wide
    wave instead of k dispatches; the tent-splat reconstruction
    (cfg.filter_splat) and the adaptive pilot's variance fold need all
    k samples of a pixel in one program. The reference has no analog
    (its SIMT megakernel regenerates per pixel,
    TracerBoy.cpp:2898-2931).

    Returns per-PIXEL summed radiance/filter_weight/rays_traced plus the
    first sample's AOVs (matching render_wave_batch's contract).
    Not compatible with params['selected_pixel'] ray recording (the
    selected lane would be recorded k times) — callers keep the looped
    batch for viewer-driven waves.
    """
    N = pixel_ids.shape[0]
    tiled = jnp.tile(pixel_ids, k)
    sidx = (jnp.asarray(base_sample, jnp.int32)
            + jnp.repeat(jnp.arange(k, dtype=jnp.int32), N))
    p2 = dict(params)
    assert p2.get("selected_pixel") is None, (
        "merged waves cannot record the selected pixel's ray path"
    )
    if p2.get("bn") is not None:
        p2["bn"] = tuple(jnp.tile(b, k) for b in p2["bn"])
    if p2.get("active_mask") is not None:
        p2["active_mask"] = jnp.tile(p2["active_mask"], k)
    out = render_wave(scene, p2, tiled, sidx, cfg)

    def fold(a):
        return a.reshape((k,) + (N,) + a.shape[1:]).sum(0)

    if cfg.filter_splat:
        assert N == cfg.width * cfg.height, (
            "filter_splat needs a full-film wave (pixel_ids = arange)"
        )
        assert not cfg.decouple_albedo, (
            "filter_splat + demodulated planes unsupported"
        )
        rr, gg, bb, fw = splat_fold_tent(
            out["radiance_r"], out["radiance_g"], out["radiance_b"],
            out["jit_u"], out["jit_v"], cfg.width, cfg.height, k,
        )
        result = dict(
            radiance_r=rr, radiance_g=gg, radiance_b=bb,
            filter_weight=fw,
            rays_traced=out["rays_traced"],
            live_end=out["live_end"],
        )
    else:
        result = dict(
            radiance_r=fold(out["radiance_r"]),
            radiance_g=fold(out["radiance_g"]),
            radiance_b=fold(out["radiance_b"]),
            filter_weight=fold(out["filter_weight"]),
            rays_traced=out["rays_traced"],
            live_end=out["live_end"],
        )
    if cfg.split_early >= 0:
        for c in ("r", "g", "b"):
            result["radiance_early_" + c] = fold(
                out["radiance_early_" + c])
    if fold_var:
        # Per-pixel first/second moments of the per-sample TONEMAPPED
        # luma — the pilot statistic for variance-guided sample
        # redistribution (Renderer.render_sample_adaptive; BASELINE
        # config 4 names the capability). Tonemapped domain because the
        # fidelity gates score there.
        fw1 = jnp.maximum(out["filter_weight"], 1e-8)
        lin = (0.2126 * out["radiance_r"] + 0.7152 * out["radiance_g"]
               + 0.0722 * out["radiance_b"]) / fw1
        tl = jnp.power(jnp.clip(lin, 0.0, 1.0), 1.0 / 2.2)
        result["lum"] = fold(tl)
        result["lum_sq"] = fold(tl * tl)
    if cfg.decouple_albedo:
        result["radiance_d"] = fold(out["radiance_d"])
    if cfg.want_aovs:
        result["radiance"] = fold(out["radiance"])
        for key in ("albedo", "normal", "world_pos", "depth", "emissive",
                    "material", "diffuse_contrib", "neighbor_dist",
                    "heatmap"):
            # fold_aovs: SUM the geometric planes over the k samples
            # (callers divide by spp for the anti-aliased mean — used
            # by the golden-aux regen); default keeps the first-sample
            # contract (the RealTime path wants one crisp G-buffer).
            if fold_aovs and key in ("albedo", "normal", "emissive",
                                     "diffuse_contrib"):
                result[key] = fold(out[key])
            else:
                result[key] = out[key][:N]
        result["viz_rays"] = out["viz_rays"]
    return result


def render_wave_batch(scene, params, pixel_ids, base_sample, k: int,
                      cfg: WaveConfig):
    """Trace k samples per pixel in ONE dispatch (a fori_loop over
    render_wave, so the lane count stays N). Returns summed
    radiance planes (radiance_r/g/b), filter_weight, and rays_traced;
    when cfg.want_aovs, also the summed (N,3) `radiance` stack and the
    LAST sample's AOV planes.

    Contract note: render_wave only returns the stacked `radiance`/AOV
    keys when cfg.want_aovs=True — this wrapper must honor that, since
    bench.py drives it with want_aovs=False. tests/test_integrator.py::TestDispatchContracts
    pins every dispatch shape the harness uses."""
    N = pixel_ids.shape[0]
    aov_keys = ("albedo", "normal", "world_pos", "depth", "emissive",
                "material", "diffuse_contrib", "neighbor_dist", "heatmap")

    def body(i, carry):
        acc = dict(carry)
        out = render_wave(scene, params, pixel_ids, base_sample + i, cfg)
        for key in ("radiance_r", "radiance_g", "radiance_b",
                    "filter_weight", "rays_traced"):
            acc[key] = acc[key] + out[key]
        if cfg.decouple_albedo:
            acc["radiance_d"] = acc["radiance_d"] + out["radiance_d"]
        if cfg.want_aovs:
            acc["radiance"] = acc["radiance"] + out["radiance"]
            for key in aov_keys:
                acc[key] = out[key]
        acc["live_end"] = out["live_end"]
        return acc

    zero = dict(
        radiance_r=jnp.zeros((N,), jnp.float32),
        radiance_g=jnp.zeros((N,), jnp.float32),
        radiance_b=jnp.zeros((N,), jnp.float32),
        filter_weight=jnp.zeros((N,), jnp.float32),
        rays_traced=jnp.float32(0.0),
        live_end=jnp.float32(0.0),
    )
    if cfg.decouple_albedo:
        zero["radiance_d"] = jnp.zeros((N, 3), jnp.float32)
    if cfg.want_aovs:
        zero.update(
            radiance=jnp.zeros((N, 3), jnp.float32),
            albedo=jnp.zeros((N, 3), jnp.float32),
            normal=jnp.zeros((N, 3), jnp.float32),
            world_pos=jnp.zeros((N, 3), jnp.float32),
            depth=jnp.zeros((N,), jnp.float32),
            emissive=jnp.zeros((N, 3), jnp.float32),
            material=jnp.zeros((N,), jnp.int32),
            diffuse_contrib=jnp.zeros((N,), jnp.float32),
            neighbor_dist=jnp.zeros((N,), jnp.float32),
            heatmap=jnp.zeros((N,), jnp.float32),
        )
    return jax.lax.fori_loop(0, k, body, zero)
