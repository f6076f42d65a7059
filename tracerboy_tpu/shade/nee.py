"""Next-event estimation: light sampling with optional RIS.

Rebuilds the reference's GetOneLightSample (TracerBoy/RayGenCommon.h:170-261)
for flat ray pools:

- Uniform path: pick one light uniformly, sample a barycentric point, pdf =
  1 / (light_count * area) for area lights (1/light_count directional),
  attenuation = 1/d^2.
- RIS path (EnableSamplingImportanceResampling): 16 candidate samples with
  target pdf ~ area * luma(L) / d^2, combined by weighted reservoir
  sampling. Implemented as a categorical draw proportional to candidate
  weight — distributionally identical to the reference's streaming
  reservoir (RayGenCommon.h:141-166) but vectorizable. (The reference's
  shipped RIS branch leaves LightAttenuation = 0 and the light direction
  unnormalized — a bug that blacks out NEE when enabled; here the RIS
  branch produces correctly normalized, attenuated samples.)
"""

from __future__ import annotations

import jax.numpy as jnp

from tracerboy_tpu.core.mathutil import dot, luminance
from tracerboy_tpu.core import rng as tbrng

RIS_CANDIDATES = 16


def _light_table_t(lights) -> jnp.ndarray:
    """(26, L) fused light table."""
    return jnp.concatenate(
        [
            lights["p0"].T, lights["p1"].T, lights["p2"].T,      # 0:9
            lights["n0"].T, lights["n1"].T, lights["n2"].T,      # 9:18
            lights["color"].T,                                   # 18:21
            lights["area"][None, :],                             # 21
            lights["ltype"][None, :].astype(jnp.float32),        # 22
            lights["direction"].T,                               # 23:26
        ],
        axis=0,
    )


def sample_one_light_soa(
    lights,
    num_lights: int,
    position,          # V3 shading points
    lane_id,
    sample_index,
    bounce,
    use_ris: bool = False,
    seed=0,
    sampler="pcg",
):
    """SoA light sampling: V3 fields, dense (N,) layouts, column gathers
    from the fused light table. Semantics identical to
    sample_one_light."""
    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.shade.surface import _take_cols

    N = position.x.shape[0]
    zero = jnp.zeros((N,), jnp.float32)
    if num_lights == 0:
        z3 = v3.V3(zero, zero, zero)
        return dict(direction=z3, color=z3, pdf=zero, normal=z3,
                    attenuation=zero, distance=zero)

    table_t = _light_table_t(lights)

    def rows_of(idx):
        return _take_cols(table_t, idx)

    def point_of(row, bu, bv, bw):
        p = v3.V3(
            row[0] * bu + row[3] * bv + row[6] * bw,
            row[1] * bu + row[4] * bv + row[7] * bw,
            row[2] * bu + row[5] * bv + row[8] * bw,
        )
        n = v3.V3(
            row[9] * bu + row[12] * bv + row[15] * bw,
            row[10] * bu + row[13] * bv + row[16] * bw,
            row[11] * bu + row[14] * bv + row[17] * bw,
        )
        return p, n

    def finalize(row, bu, bv, bw, pdf):
        lp, ln = point_of(row, bu, bv, bw)
        ltype = jnp.round(row[22]).astype(jnp.int32)
        to_light = lp - position
        dist = jnp.sqrt(jnp.maximum(v3.dot(to_light, to_light), 1e-12))
        direction = to_light * (1.0 / dist)
        atten = 1.0 / jnp.maximum(dist * dist, 1e-12)
        ldir = v3.V3(row[23], row[24], row[25])
        is_dir = ltype == 1
        direction = v3.where(is_dir, -ldir, direction)
        ln = v3.where(is_dir, ldir, ln)
        atten = jnp.where(is_dir, 1.0, atten)
        dist = jnp.where(is_dir, 1e9, dist)
        return dict(
            direction=direction, color=v3.V3(row[18], row[19], row[20]),
            pdf=pdf, normal=ln, attenuation=atten, distance=dist,
        )

    def bary(r0, r1):
        flip = (r0 + r1) > 1.0
        u = jnp.where(flip, 1.0 - r0, r0)
        v = jnp.where(flip, 1.0 - r1, r1)
        return u, v, 1.0 - u - v

    if not use_ris:
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_LIGHT_SELECT, seed, sampler)
        idx = jnp.minimum((r * num_lights).astype(jnp.int32), num_lights - 1)
        b0, b1 = tbrng.uniform2_soa(lane_id, sample_index, bounce,
                                    tbrng.STREAM_AREA_LIGHT, seed, sampler)
        bu, bv, bw = bary(b0, b1)
        row = rows_of(idx)
        ltype = jnp.round(row[22]).astype(jnp.int32)
        pdf = 1.0 / num_lights
        pdf = jnp.where(
            ltype == 0, pdf / jnp.maximum(row[21], 1e-12), pdf
        )
        return finalize(row, bu, bv, bw, pdf)

    # RIS with SoA candidates.
    cand = []
    wsum = zero
    for c in range(RIS_CANDIDATES):
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_RIS + 2 * c, seed, sampler)
        idx = jnp.minimum((r * num_lights).astype(jnp.int32), num_lights - 1)
        b0, b1 = tbrng.uniform2_soa(lane_id, sample_index, bounce,
                                    tbrng.STREAM_RIS + 2 * c + 1, seed, sampler)
        bu, bv, bw = bary(b0, b1)
        row = rows_of(idx)
        lp, _ = point_of(row, bu, bv, bw)
        dd = lp - position
        d2 = jnp.maximum(v3.dot(dd, dd), 1e-6)
        luma = 0.2126 * row[18] + 0.7152 * row[19] + 0.0722 * row[20]
        target = row[21] * luma / d2
        w = target * num_lights / RIS_CANDIDATES
        cand.append((idx, bu, bv, bw, w, target))
        wsum = wsum + w

    # Streaming reservoir selection (equivalent to the categorical draw).
    u = tbrng.uniform(lane_id, sample_index, bounce,
                      tbrng.STREAM_RIS + 2 * RIS_CANDIDATES, seed, sampler)
    thresh = u * wsum
    run = zero
    sel_idx = jnp.zeros((N,), jnp.int32)
    sel = [zero, zero, zero, zero]  # bu, bv, bw, target
    chosen = jnp.zeros((N,), jnp.bool_)
    for idx, bu, bv, bw, w, target in cand:
        run = run + w
        take = (~chosen) & (run >= thresh)
        sel_idx = jnp.where(take, idx, sel_idx)
        sel[0] = jnp.where(take, bu, sel[0])
        sel[1] = jnp.where(take, bv, sel[1])
        sel[2] = jnp.where(take, bw, sel[2])
        sel[3] = jnp.where(take, target, sel[3])
        chosen = chosen | take

    row = rows_of(sel_idx)
    area = jnp.maximum(row[21], 1e-12)
    ris_pdf = sel[3] / jnp.maximum(wsum, 1e-12) / area
    out = finalize(row, sel[0], sel[1], sel[2], ris_pdf)
    out["pdf"] = jnp.where(wsum <= 0.0, 0.0, out["pdf"])
    return out


def _random_barycentric(r0, r1):
    """Uniform triangle barycentrics via reflection (RayGenCommon.h:124-135)."""
    flip = (r0 + r1) > 1.0
    u = jnp.where(flip, 1.0 - r0, r0)
    v = jnp.where(flip, 1.0 - r1, r1)
    return jnp.stack([u, v, 1.0 - u - v], axis=-1)


def _light_rows(lights, idx):
    """All light columns for `idx` via one row gather."""
    import jax.numpy as _jnp

    table = _jnp.concatenate(
        [
            lights["p0"], lights["p1"], lights["p2"],        # 0:9
            lights["n0"], lights["n1"], lights["n2"],        # 9:18
            lights["color"],                                 # 18:21
            lights["area"][:, None],                         # 21
            lights["ltype"][:, None].astype(_jnp.float32),   # 22
            lights["direction"],                             # 23:26
        ],
        axis=1,
    )
    row = table[idx]
    return dict(
        p0=row[..., 0:3], p1=row[..., 3:6], p2=row[..., 6:9],
        n0=row[..., 9:12], n1=row[..., 12:15], n2=row[..., 15:18],
        color=row[..., 18:21], area=row[..., 21],
        ltype=jnp.round(row[..., 22]).astype(jnp.int32),
        direction=row[..., 23:26],
    )


def _light_point(rows, bary):
    p = (
        rows["p0"] * bary[..., 0:1]
        + rows["p1"] * bary[..., 1:2]
        + rows["p2"] * bary[..., 2:3]
    )
    n = (
        rows["n0"] * bary[..., 0:1]
        + rows["n1"] * bary[..., 1:2]
        + rows["n2"] * bary[..., 2:3]
    )
    return p, n


def sample_one_light(
    lights,
    num_lights: int,
    position,        # (N, 3) shading points
    lane_id,
    sample_index,
    bounce,
    use_ris: bool = False,
    seed=0,
    sampler="pcg",
):
    """Reference (array-of-structs) light sampler; the hot path uses
    sample_one_light_soa. Kept as the readable cross-check used by tests.

    Returns dict(direction, color, pdf, normal, attenuation, distance):
    direction normalized; pdf in the reference's area-measure convention so
    the caller's weight is atten * brdf * |dot(light_n, dir)| / pdf.
    """
    N = position.shape[0]
    if num_lights == 0:
        z3 = jnp.zeros((N, 3), jnp.float32)
        z = jnp.zeros((N,), jnp.float32)
        return dict(direction=z3, color=z3, pdf=z, normal=z3,
                    attenuation=z, distance=z)

    def finalize(rows, bary, pdf):
        lp, ln = _light_point(rows, bary)
        ltype = rows["ltype"]
        to_light = lp - position
        dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-12))
        direction = to_light / dist[..., None]
        atten = 1.0 / jnp.maximum(dist * dist, 1e-12)
        # Directional lights (LIGHT_TYPE_DIRECTIONAL): fixed direction,
        # unit attenuation, pdf has no area factor.
        direction = jnp.where(
            (ltype == 1)[..., None], -rows["direction"], direction
        )
        ln = jnp.where((ltype == 1)[..., None], rows["direction"], ln)
        atten = jnp.where(ltype == 1, 1.0, atten)
        dist = jnp.where(ltype == 1, 1e9, dist)
        return dict(
            direction=direction,
            color=rows["color"],
            pdf=pdf,
            normal=ln,
            attenuation=atten,
            distance=dist,
        )

    if not use_ris:
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_LIGHT_SELECT, seed, sampler)
        idx = jnp.minimum((r * num_lights).astype(jnp.int32), num_lights - 1)
        b = tbrng.uniform2(lane_id, sample_index, bounce,
                           tbrng.STREAM_AREA_LIGHT, seed, sampler)
        bary = _random_barycentric(b[..., 0], b[..., 1])
        rows = _light_rows(lights, idx)
        pdf = 1.0 / num_lights
        pdf = jnp.where(
            rows["ltype"] == 0,
            pdf / jnp.maximum(rows["area"], 1e-12), pdf,
        )
        return finalize(rows, bary, pdf)

    # --- RIS: 16 candidates, categorical-by-weight selection -------------
    cand_idx = []
    cand_bary = []
    cand_w = []
    cand_tpdf = []
    for c in range(RIS_CANDIDATES):
        r = tbrng.uniform(lane_id, sample_index, bounce,
                          tbrng.STREAM_RIS + 2 * c, seed, sampler)
        idx = jnp.minimum((r * num_lights).astype(jnp.int32), num_lights - 1)
        b = tbrng.uniform2(lane_id, sample_index, bounce,
                           tbrng.STREAM_RIS + 2 * c + 1, seed, sampler)
        bary = _random_barycentric(b[..., 0], b[..., 1])
        rows_c = _light_rows(lights, idx)
        lp, _ = _light_point(rows_c, bary)
        d2 = jnp.maximum(
            jnp.sum((lp - position) ** 2, axis=-1), 1e-6
        )
        target = rows_c["area"] * luminance(rows_c["color"]) / d2
        proposal = 1.0 / num_lights
        w = target / (proposal * RIS_CANDIDATES)
        cand_idx.append(idx)
        cand_bary.append(bary)
        cand_w.append(w)
        cand_tpdf.append(target)

    W = jnp.stack(cand_w, axis=1)          # (N, C)
    Tpdf = jnp.stack(cand_tpdf, axis=1)
    idxs = jnp.stack(cand_idx, axis=1)
    barys = jnp.stack(cand_bary, axis=1)   # (N, C, 3)

    wsum = jnp.sum(W, axis=1)
    cdf = jnp.cumsum(W, axis=1)
    u = tbrng.uniform(lane_id, sample_index, bounce,
                      tbrng.STREAM_RIS + 2 * RIS_CANDIDATES, seed, sampler)
    pick = jnp.sum((cdf < (u * wsum)[:, None]).astype(jnp.int32), axis=1)
    pick = jnp.minimum(pick, RIS_CANDIDATES - 1)
    rowsN = jnp.arange(N)
    sel_idx = idxs[rowsN, pick]
    sel_bary = barys[rowsN, pick]
    sel_target = Tpdf[rowsN, pick]
    sel_rows = _light_rows(lights, sel_idx)
    area = jnp.maximum(sel_rows["area"], 1e-12)
    ris_pdf = sel_target / jnp.maximum(wsum, 1e-12) / area
    out = finalize(sel_rows, sel_bary, ris_pdf)
    # Guard degenerate reservoirs (all-zero weights).
    bad = wsum <= 0.0
    out["pdf"] = jnp.where(bad, 0.0, out["pdf"])
    return out
