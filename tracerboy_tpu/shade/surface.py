"""Surface attribute fetch: textures and materials for a wave of hits.

Rebuilds the reference's GetMaterial/GetTextureData pair
(TracerBoy/RayGenCommon.h:298-341 GetMaterialInternal with stochastic mix
resolution and map overrides; TracerBoy/SharedRaytracing.h:67-137 texture
dispatch with image/checker/scale types, one nesting level, and gamma
decode; TracerBoy/kernel.glsl:1236-1247 SSS artist-albedo conversion). All
fetches are gathers across flat ray pools.
"""

from __future__ import annotations

import jax.numpy as jnp

from tracerboy_tpu.core import rng as tbrng
from tracerboy_tpu.core.tonemap import gamma_to_linear
from tracerboy_tpu.shade.bsdf import artist_albedo_to_absorption
from tracerboy_tpu.scene.materials import (
    METALLIC_FLAG,
    MIX_FLAG,
    SUBSURFACE_SCATTER_FLAG,
)
from tracerboy_tpu.scene.textures import (
    TEX_IMAGE,
    TEX_CHECKER,
    TEX_SCALE,
    GAMMA_FLAG,
)


def _sample_image(tex_images, tex_sizes, image_idx, u, v):
    """Bilinear wrap sample from the padded image array."""
    img_i = jnp.clip(image_idx, 0, tex_images.shape[0] - 1)
    h = tex_sizes[img_i, 0].astype(jnp.float32)
    w = tex_sizes[img_i, 1].astype(jnp.float32)
    uu = jnp.mod(u, 1.0)
    vv = jnp.mod(v, 1.0)
    fx = uu * w - 0.5
    fy = vv * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    wi = tex_sizes[img_i, 1]
    hi = tex_sizes[img_i, 0]
    x0w = jnp.mod(x0, wi)
    x1w = jnp.mod(x0 + 1, wi)
    y0w = jnp.mod(y0, hi)
    y1w = jnp.mod(y0 + 1, hi)
    c00 = tex_images[img_i, y0w, x0w]
    c01 = tex_images[img_i, y0w, x1w]
    c10 = tex_images[img_i, y1w, x0w]
    c11 = tex_images[img_i, y1w, x1w]
    return (
        c00 * (1 - tx) * (1 - ty)
        + c01 * tx * (1 - ty)
        + c10 * (1 - tx) * ty
        + c11 * tx * ty
    )


def _rec_rows(recs):
    """Fused (n_tex, 13) texture-record row table. One wide-row gather
    per lookup replaces 9 per-plane gathers. Columns: 0 ttype, 1 flags, 2 uscale,
    3 vscale, 4 image_idx, 5 sub1, 6 sub2, 7:10 color1, 10:13 color2.
    Scene-constant: XLA hoists the concat out of the bounce loop."""
    f = jnp.float32
    return jnp.concatenate(
        [
            recs["ttype"].astype(f)[:, None],
            recs["flags"].astype(f)[:, None],
            recs["uscale"][:, None],
            recs["vscale"][:, None],
            recs["image_idx"].astype(f)[:, None],
            recs["sub1"].astype(f)[:, None],
            recs["sub2"].astype(f)[:, None],
            recs["color1"],
            recs["color2"],
        ],
        axis=1,
    )


def _eval_texture_row(row, tex_images, tex_sizes, uv, has_image=True):
    """Single-level texture evaluation from a gathered (N, 13) rec row.

    has_image=False (static scene fact: no TEX_IMAGE records) compiles
    out the bilinear image fetch — 12 gathers per call on scenes that
    only use procedural checker/scale/constant textures.
    """
    ttype = jnp.round(row[:, 0]).astype(jnp.int32)
    u = uv[..., 0] * row[:, 2]
    v = uv[..., 1] * row[:, 3]
    color1 = row[:, 7:10]
    color2 = row[:, 10:13]

    # Checker (SharedRaytracing.h checker branch): integer parity of
    # floor(u*uscale) + floor(v*vscale).
    parity = (
        jnp.floor(u).astype(jnp.int32) + jnp.floor(v).astype(jnp.int32)
    ) % 2
    checker = jnp.where((parity == 0)[..., None], color1, color2)

    out = color1
    if has_image:
        flags = jnp.round(row[:, 1]).astype(jnp.int32)
        image_idx = jnp.round(row[:, 4]).astype(jnp.int32)
        img = _sample_image(tex_images, tex_sizes, image_idx, u, v)
        img = jnp.where(
            (flags & GAMMA_FLAG)[..., None] != 0, gamma_to_linear(img), img
        )
        out = jnp.where((ttype == TEX_IMAGE)[..., None], img, out)
    out = jnp.where((ttype == TEX_CHECKER)[..., None], checker, out)
    return out


def _eval_texture_flat(recs, tex_images, tex_sizes, tex_id, uv):
    """Single-level texture evaluation (no scale-nesting)."""
    rid = jnp.clip(tex_id, 0, recs["ttype"].shape[0] - 1)
    return _eval_texture_row(_rec_rows(recs)[rid], tex_images, tex_sizes, uv)


def eval_texture(recs, tex_images, tex_sizes, tex_id, uv,
                 has_image=True, has_scale=True):
    """Texture evaluation with one level of scale-texture nesting
    (the reference allows exactly one recursion, SharedRaytracing.h:99-118).
    tex_id: (N,) int32 (callers mask invalid ids). has_image/has_scale
    are static scene facts gating the image fetch / nesting level."""
    table = _rec_rows(recs)
    n = table.shape[0]
    rid = jnp.clip(tex_id, 0, n - 1)
    row = table[rid]
    base = _eval_texture_row(row, tex_images, tex_sizes, uv,
                             has_image=has_image)
    if not has_scale:
        return base
    ttype = jnp.round(row[:, 0]).astype(jnp.int32)

    sub1 = jnp.round(row[:, 5]).astype(jnp.int32)
    sub2 = jnp.round(row[:, 6]).astype(jnp.int32)
    row1 = table[jnp.clip(sub1, 0, n - 1)]
    row2 = table[jnp.clip(sub2, 0, n - 1)]
    t1 = jnp.where(
        (sub1 >= 0)[..., None],
        _eval_texture_row(row1, tex_images, tex_sizes, uv,
                          has_image=has_image),
        row[:, 7:10],
    )
    t2 = jnp.where(
        (sub2 >= 0)[..., None],
        _eval_texture_row(row2, tex_images, tex_sizes, uv,
                          has_image=has_image),
        row[:, 10:13],
    )
    scale = t1 * t2
    return jnp.where((ttype == TEX_SCALE)[..., None], scale, base)


def _take_cols(table_t, idx):
    """Column lookup: (k, M) table x (N,) idx -> (k, N), a plain gather
    (exact for every column, the integer-valued ones included).

    Keeps the result's minor dim = N; each row slices out as a clean
    (N,) component.
    """
    return table_t[:, idx]


def _mat_table_t(mats) -> jnp.ndarray:
    """(21, M) fused material table (columns documented in fetch_material)."""
    return jnp.concatenate(
        [
            mats["albedo"].T,                      # 0:3
            mats["emissive"].T,                    # 3:6
            mats["ior"][None, :],                  # 6
            mats["roughness"][None, :],            # 7
            mats["absorption"].T,                  # 8:11
            mats["scattering"].T,                  # 11:14
            mats["specular_coef"][None, :],        # 14
            mats["flags"][None, :].astype(jnp.float32),        # 15
            mats["albedo_tex"][None, :].astype(jnp.float32),   # 16
            mats["emissive_tex"][None, :].astype(jnp.float32), # 17
            mats["specular_tex"][None, :].astype(jnp.float32), # 18
            mats["normal_tex"][None, :].astype(jnp.float32),   # 19
            mats["alpha_tex"][None, :].astype(jnp.float32),    # 20
        ],
        axis=0,
    )


def fetch_material_soa(
    scene,
    mat_id,
    uv_u,
    uv_v,
    backside,
    lane_id,
    sample_index,
    bounce,
    seed=0,
    has_mix: bool = True,
    has_textures: bool = True,
    has_emissive_tex: bool = True,
    has_specular_tex: bool = True,
    has_image_tex: bool = True,
    has_scale_tex: bool = True,
):
    """SoA material fetch: V3 fields + (N,) scalars, dense layouts.

    Same semantics as fetch_material (mix resolution, texture overrides,
    SSS conversion); the whole record comes from one column gather of
    the fused (21, M) table.
    """
    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.shade.bsdf import artist_albedo_to_absorption_soa

    mats = scene["materials"]
    M = mats["flags"].shape[0]
    mid = jnp.clip(mat_id, 0, M - 1)
    table_t = _mat_table_t(mats)

    if has_mix:
        row0 = _take_cols(table_t, mid)
        flags0 = jnp.round(row0[15]).astype(jnp.int32)
        is_mix = (flags0 & MIX_FLAG) != 0
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_MIX, seed)
        mix_id = jnp.where(r < row0[2], row0[0], row0[1]).astype(jnp.int32)
        mid = jnp.where(is_mix, jnp.clip(mix_id, 0, M - 1), mid)

    row = _take_cols(table_t, mid)
    albedo = v3.V3(row[0], row[1], row[2])
    emissive = v3.V3(row[3], row[4], row[5])
    ior = row[6]
    roughness = row[7]
    absorption = v3.V3(row[8], row[9], row[10])
    scattering = v3.V3(row[11], row[12], row[13])
    specular_coef = row[14]
    flags = jnp.round(row[15]).astype(jnp.int32)
    albedo_tex = jnp.round(row[16]).astype(jnp.int32)
    emissive_tex = jnp.round(row[17]).astype(jnp.int32)
    spec_tex = jnp.round(row[18]).astype(jnp.int32)
    normal_tex = jnp.round(row[19]).astype(jnp.int32)

    zero = jnp.zeros_like(ior)
    emissive = v3.where(backside, v3.V3(zero, zero, zero), emissive)

    if has_textures:
        recs = scene["tex_records"]
        imgs = scene["tex_images"]
        sizes = scene["tex_sizes"]
        uv = jnp.stack([uv_u, uv_v], axis=-1)
        tex_kw = dict(has_image=has_image_tex, has_scale=has_scale_tex)
        alb_t = eval_texture(recs, imgs, sizes, albedo_tex, uv, **tex_kw)
        albedo = v3.where(
            albedo_tex >= 0,
            v3.V3(alb_t[..., 0], alb_t[..., 1], alb_t[..., 2]), albedo,
        )
        if has_emissive_tex:
            emi_t = eval_texture(recs, imgs, sizes, emissive_tex, uv,
                                 **tex_kw)
            emissive = v3.where(
                (emissive_tex >= 0) & ~backside,
                v3.V3(emi_t[..., 0], emi_t[..., 1], emi_t[..., 2]),
                emissive,
            )
        if has_specular_tex:
            spec_data = eval_texture(recs, imgs, sizes, spec_tex, uv,
                                     **tex_kw)
            has_spec = spec_tex >= 0
            roughness = jnp.where(has_spec, spec_data[..., 1], roughness)
            flags = jnp.where(
                has_spec & (spec_data[..., 2] > 0.5),
                flags | METALLIC_FLAG, flags,
            )

    is_sss = (flags & SUBSURFACE_SCATTER_FLAG) != 0
    has_albedo = (albedo.x > 0) | (albedo.y > 0) | (albedo.z > 0)
    conv = is_sss & has_albedo
    mfp = v3.V3(
        1.0 / jnp.maximum(scattering.x, 1e-8),
        1.0 / jnp.maximum(scattering.y, 1e-8),
        1.0 / jnp.maximum(scattering.z, 1e-8),
    )
    conv_abs, conv_scat = artist_albedo_to_absorption_soa(albedo, mfp)
    absorption = v3.where(conv, conv_abs, absorption)
    scattering = v3.where(conv, conv_scat, scattering)
    albedo = v3.where(conv, v3.V3(zero, zero, zero), albedo)

    return dict(
        albedo=albedo, emissive=emissive, ior=ior, roughness=roughness,
        absorption=absorption, scattering=scattering,
        specular_coef=specular_coef, flags=flags, normal_tex=normal_tex,
    )


def apply_normal_map(scene, normal_tex, normal, tangent, uv_u, uv_v):
    """Tangent-space normal-map perturbation (GetDetailNormal,
    RayGenCommon.h:273-295): tbn = ((0.5-x)*2, (0.5-y)*2, sqrt(1-x2-y2)),
    z clamped to 0.02 so reflections never go parallel to the surface.

    normal/tangent: V3 SoA. Returns the detail normal (V3)."""
    from tracerboy_tpu.core import vec3 as v3

    # Gram-Schmidt: flat per-triangle tangents aren't exactly
    # perpendicular to the interpolated shading normal.
    t = v3.normalize(tangent - normal * v3.dot(tangent, normal))
    b = v3.cross(t, normal)
    uv = jnp.stack([uv_u, uv_v], axis=-1)
    data = eval_texture(
        scene["tex_records"], scene["tex_images"], scene["tex_sizes"],
        jnp.maximum(normal_tex, 0), uv,
    )
    tx = (0.5 - data[..., 0]) * 2.0
    ty = (0.5 - data[..., 1]) * 2.0
    tz = jnp.sqrt(jnp.maximum(1.0 - tx * tx - ty * ty, 0.0))
    detail = v3.normalize(
        t * tx + b * ty + normal * jnp.maximum(tz, 0.02)
    )
    return v3.where(normal_tex >= 0, detail, normal)


def fetch_material(
    scene,
    mat_id,
    uv,
    backside,
    lane_id,
    sample_index,
    bounce,
    seed=0,
    has_mix: bool = True,
    has_textures: bool = True,
):
    """Reference (array-of-structs) material fetch.

    The hot path uses fetch_material_soa above; this variant is kept as
    the readable cross-check implementation used by unit tests.

    Returns a dict of per-lane arrays: albedo, emissive, ior, roughness,
    absorption, scattering, specular_coef, flags. Handles: backside
    emissive suppression, stochastic mix resolution, albedo/emissive/
    specular map overrides, and the SSS artist-albedo conversion.

    `has_mix` / `has_textures` are static flags letting scenes without
    those features skip the work entirely (set by the caller from
    compile-time scene facts).
    """
    mats = scene["materials"]
    M = mats["flags"].shape[0]
    mid = jnp.clip(mat_id, 0, M - 1)

    # Fuse all material columns into one (M, k) table so the whole fetch
    # is a single row gather.
    table = jnp.concatenate(
        [
            mats["albedo"],                       # 0:3
            mats["emissive"],                     # 3:6
            mats["ior"][:, None],                 # 6
            mats["roughness"][:, None],           # 7
            mats["absorption"],                   # 8:11
            mats["scattering"],                   # 11:14
            mats["specular_coef"][:, None],       # 14
            mats["flags"][:, None].astype(jnp.float32),       # 15
            mats["albedo_tex"][:, None].astype(jnp.float32),  # 16
            mats["emissive_tex"][:, None].astype(jnp.float32),# 17
            mats["specular_tex"][:, None].astype(jnp.float32),# 18
            mats["normal_tex"][:, None].astype(jnp.float32),  # 19
            mats["alpha_tex"][:, None].astype(jnp.float32),   # 20
        ],
        axis=1,
    )

    if has_mix:
        # Stochastic mix resolution (RayGenCommon.h:308-319): albedo
        # packs (mat0, mat1, amount); one level like the reference.
        row0 = table[mid]
        flags0 = jnp.round(row0[..., 15]).astype(jnp.int32)
        is_mix = (flags0 & MIX_FLAG) != 0
        amount = row0[..., 2]
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_MIX, seed)
        mix_id = jnp.where(r < amount, row0[..., 0], row0[..., 1]).astype(
            jnp.int32
        )
        mid = jnp.where(is_mix, jnp.clip(mix_id, 0, M - 1), mid)

    row = table[mid]
    albedo = row[..., 0:3]
    emissive = row[..., 3:6]
    ior = row[..., 6]
    roughness = row[..., 7]
    absorption = row[..., 8:11]
    scattering = row[..., 11:14]
    specular_coef = row[..., 14]
    flags = jnp.round(row[..., 15]).astype(jnp.int32)
    albedo_tex = jnp.round(row[..., 16]).astype(jnp.int32)
    emissive_tex = jnp.round(row[..., 17]).astype(jnp.int32)
    spec_tex = jnp.round(row[..., 18]).astype(jnp.int32)
    normal_tex = jnp.round(row[..., 19]).astype(jnp.int32)
    alpha_tex = jnp.round(row[..., 20]).astype(jnp.int32)

    # Emissive is one-sided (PBRT convention; RayGenCommon.h:301-306).
    emissive = jnp.where(backside[..., None], 0.0, emissive)

    if has_textures:
        recs = scene["tex_records"]
        imgs = scene["tex_images"]
        sizes = scene["tex_sizes"]

        albedo = jnp.where(
            (albedo_tex >= 0)[..., None],
            eval_texture(recs, imgs, sizes, albedo_tex, uv),
            albedo,
        )
        emissive = jnp.where(
            ((emissive_tex >= 0) & ~backside)[..., None],
            eval_texture(recs, imgs, sizes, emissive_tex, uv),
            emissive,
        )
        # Specular map: g = roughness, b > 0.5 marks metallic
        # (RayGenCommon.h:330-339).
        spec_data = eval_texture(recs, imgs, sizes, spec_tex, uv)
        has_spec = spec_tex >= 0
        roughness = jnp.where(has_spec, spec_data[..., 1], roughness)
        flags = jnp.where(
            has_spec & (spec_data[..., 2] > 0.5),
            flags | METALLIC_FLAG, flags,
        )

    # SSS artist albedo -> absorption/scattering (kernel.glsl:1236-1247).
    is_sss = (flags & SUBSURFACE_SCATTER_FLAG) != 0
    has_albedo = jnp.any(albedo > 0.0, axis=-1)
    conv = is_sss & has_albedo
    mfp = 1.0 / jnp.maximum(scattering, 1e-8)
    conv_abs, conv_scat = artist_albedo_to_absorption(albedo, mfp)
    absorption = jnp.where(conv[..., None], conv_abs, absorption)
    scattering = jnp.where(conv[..., None], conv_scat, scattering)
    albedo = jnp.where(conv[..., None], 0.0, albedo)

    return dict(
        albedo=albedo,
        emissive=emissive,
        ior=ior,
        roughness=roughness,
        absorption=absorption,
        scattering=scattering,
        specular_coef=specular_coef,
        flags=flags,
        normal_tex=normal_tex,
        alpha_tex=alpha_tex,
    )
