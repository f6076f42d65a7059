"""Random number and low-discrepancy sequence generation.

The reference shader uses a per-thread `rand()` LCG plus Halton and blue-noise
streams with Cranley-Patterson rotation (TracerBoy/RayGenCommon.h:49-122).
Here randoms are stateless and counter-based, so every lane of a flat ray
pool computes its numbers with pure elementwise ops, no carried state.

We use the PCG3D/PCG4D hash family (Jarzynski & Olano, JCGT 2020 — public
domain construction) keyed by (lane_id, sample_index, bounce, stream). Each
`uniform*` call is deterministic given those coordinates, which makes renders
reproducible and lets compaction permute lanes freely.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Stream ids: every random decision in the integrator draws from its own
# stream so streams stay decorrelated across bounces. Mirrors the 4
# blue-noise stream pairs of the reference (RayGenCommon.h:71-122).
STREAM_PRIMARY_JITTER = 0      # 2 dims: pixel AA jitter
STREAM_SECONDARY_DIR = 2       # 2 dims: BSDF direction sample
STREAM_AREA_LIGHT = 4          # 2 dims: light surface sample
STREAM_DOF = 6                 # 2 dims: aperture sample
STREAM_RUSSIAN_ROULETTE = 8
STREAM_SPECULAR_SELECT = 9
STREAM_LIGHT_SELECT = 10
STREAM_RIS = 11                # 2*16 dims reserved for reservoir sampling
STREAM_SSS = 48                # scattering walk (uses 48-49)
STREAM_MIX = 50                # mix-material resolution coin
STREAM_ROUGH_REFRACT = 51      # pow-lobe rough refraction sample
STREAM_VOLUME = 52             # delta-tracking walk (52..55: distance,
                               # acceptance, phase u/v)
STREAM_VOLUME_SHADOW = 56      # ratio-marching jitter for NEE
STREAM_ENV_NEE = 58            # 2 dims: environment NEE direction
STREAM_ENV_NEE_SHADOW = 60     # ratio-marching jitter for env NEE
STREAM_ACCUM_JITTER = 64       # jittered-accumulator coin flip
STREAM_ENV_NEE_X = 65          # 2*(M-1) dims: extra env-NEE directions
                               # (WaveConfig.env_nee_samples > 1);
                               # 65..79 bounds M at 8
NUM_STREAMS = 80


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def pcg3d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG3D hash: uint32[..., 3] -> uint32[..., 3]."""
    v = v.astype(jnp.uint32)
    v = v * np.uint32(1664525) + np.uint32(1013904223)
    x = v[..., 0] + v[..., 1] * v[..., 2]
    y = v[..., 1] + v[..., 2] * x
    z = v[..., 2] + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return jnp.stack([x, y, z], axis=-1)


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG4D hash: uint32[..., 4] -> uint32[..., 4]."""
    v = v.astype(jnp.uint32)
    v = v * np.uint32(1664525) + np.uint32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def u32_to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    """Map uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (u >> 8).astype(jnp.float32) * np.float32(1.0 / 16777216.0)


def uniform(lane_id, sample_index, bounce, stream, seed=0, sampler="pcg"):
    """One uniform float in [0,1) per lane.

    lane_id: int32[N] (usually pixel index in the flat pool)
    sample_index / bounce / stream / seed: scalars or int32[N].
    sampler: "pcg" (independent hash randoms) or "sobol" (per-stream
    Owen-scrambled Sobol (0,2)-pairs padded across streams — far lower
    variance at small per-pixel sample counts).
    """
    return uniform2_soa(lane_id, sample_index, bounce, stream, seed,
                        sampler)[0]


def uniform2(lane_id, sample_index, bounce, stream, seed=0, sampler="pcg"):
    """Two decorrelated uniforms per lane, shape (N, 2)."""
    u, v = uniform2_soa(lane_id, sample_index, bounce, stream, seed,
                        sampler)
    return jnp.stack([u, v], axis=-1)


def _pcg3d_soa(x, y, z):
    """PCG3D on separate component arrays (dense (N,) layout, see
    core/vec3.py)."""
    c1 = np.uint32(1664525)
    c2 = np.uint32(1013904223)
    x = x * c1 + c2
    y = y * c1 + c2
    z = z * c1 + c2
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def uniform2_soa(lane_id, sample_index, bounce, stream, seed=0,
                 sampler="pcg"):
    """Two decorrelated uniforms per lane as separate (N,) arrays."""
    if sampler == "sobol":
        return sobol2_soa(lane_id, sample_index, bounce, stream, seed)
    lane_id = _u32(lane_id)
    mixed = _u32(sample_index) * np.uint32(9781) + _u32(seed) * np.uint32(6271)
    key = jnp.broadcast_to(mixed, lane_id.shape).astype(jnp.uint32)
    sb = _u32(bounce) * np.uint32(NUM_STREAMS) + _u32(stream)
    sb = jnp.broadcast_to(sb, lane_id.shape).astype(jnp.uint32)
    hx, hy, _ = _pcg3d_soa(lane_id, key, sb)
    return u32_to_unit_float(hx), u32_to_unit_float(hy)


# ----------------------------------------------------------------------------
# Owen-scrambled Sobol (0,2)-sequences, padded across streams.
#
# The reference samples with blue-noise + Halton Cranley-Patterson
# rotation (RayGenCommon.h:49-122); its bundled scenes all DECLARE
# `Sampler "sobol"` (Scenes/*/scene.pbrt) which the reference ignores.
# This is that sampler, built the modern way: every 2D decision stream
# draws from the first two Sobol dimensions with
#   - a per-(pixel, bounce, stream) Owen shuffle of the sample index
#     (decorrelates the pad across streams and pixels), and
#   - per-dimension hash-based Owen scrambling of the output bits,
# following Burley, "Practical Hash-based Owen Scrambling", JCGT 2020
# (the construction pbrt-v4 uses). At 8 spp each stream sees a
# perfectly stratified scrambled (0,2) prefix instead of 8 independent
# randoms — the variance lever for the low-spp denoised fidelity gate.


def _reverse_bits_u32(b):
    b = ((b & np.uint32(0x55555555)) << 1) | ((b & np.uint32(0xAAAAAAAA)) >> 1)
    b = ((b & np.uint32(0x33333333)) << 2) | ((b & np.uint32(0xCCCCCCCC)) >> 2)
    b = ((b & np.uint32(0x0F0F0F0F)) << 4) | ((b & np.uint32(0xF0F0F0F0)) >> 4)
    b = ((b & np.uint32(0x00FF00FF)) << 8) | ((b & np.uint32(0xFF00FF00)) >> 8)
    return (b << 16) | (b >> 16)


def _laine_karras(x, lk_seed):
    """Laine-Karras hash permutation: a random-ish Owen tree on the
    LOW-bits-first representation (bit k only influenced by bits < k)."""
    x = x + lk_seed
    x = x ^ (x * np.uint32(0x6C50B47C))
    x = x ^ (x * np.uint32(0xB82F1E52))
    x = x ^ (x * np.uint32(0xC7AFE638))
    x = x ^ (x * np.uint32(0x8D22F6E6))
    return x


def _owen_scramble(x, owen_seed):
    """Nested uniform (Owen) scramble of a u32 whose fraction MSB is bit
    31: reverse so the tree root sits at bit 0, permute, reverse back."""
    return _reverse_bits_u32(
        _laine_karras(_reverse_bits_u32(x), owen_seed))


def _sobol_dim1_columns():
    """Direction numbers (u32 columns) for Sobol dimension 1: primitive
    polynomial x^2 + x + 1 (Joe-Kuo: s=2, a=1, m=[1,3])."""
    m = [1, 3]
    for k in range(2, 32):
        m.append((2 * m[-1]) ^ (4 * m[-2]) ^ m[-2])
    return np.array([mk << (31 - k) for k, mk in enumerate(m)],
                    dtype=np.uint32)


_SOBOL_DIM1 = _sobol_dim1_columns()


def _sobol2_point(index):
    """The (dim0, dim1) Sobol point for u32 `index`, as u32 fractions."""
    x = _reverse_bits_u32(index)           # dim 0: van der Corput
    y = jnp.zeros_like(index)
    for k in range(32):                    # dim 1: XOR matrix product
        bit = (index >> np.uint32(k)) & np.uint32(1)
        y = y ^ (bit * _SOBOL_DIM1[k])
    return x, y


def sobol2_soa(lane_id, sample_index, bounce, stream, seed=0):
    """Owen-scrambled Sobol (0,2) pair per lane as separate (N,) arrays.

    Same signature/contract as uniform2_soa: deterministic in
    (lane, sample, bounce, stream, seed), so compaction may permute
    lanes and merged waves may pass per-lane sample indices.
    """
    lane_id = _u32(lane_id)
    sb = _u32(bounce) * np.uint32(NUM_STREAMS) + _u32(stream)
    sb = jnp.broadcast_to(sb, lane_id.shape).astype(jnp.uint32)
    sd = jnp.broadcast_to(_u32(seed), lane_id.shape).astype(jnp.uint32)
    # Three independent per-(lane, bounce, stream, seed) seeds: the
    # index shuffle and one Owen tree per output dimension.
    s_shuf, s_x, s_y = _pcg3d_soa(lane_id, sb, sd)
    idx = jnp.broadcast_to(_u32(sample_index), lane_id.shape)
    idx = idx.astype(jnp.uint32)
    shuffled = _owen_scramble(idx, s_shuf)
    x, y = _sobol2_point(shuffled)
    x = _owen_scramble(x, s_x)
    y = _owen_scramble(y, s_y)
    return u32_to_unit_float(x), u32_to_unit_float(y)


# ----------------------------------------------------------------------------
# Halton low-discrepancy sequences (RayGenCommon.h:49-69 semantics).


def radical_inverse_base2(i: jnp.ndarray) -> jnp.ndarray:
    """Van der Corput sequence base 2 via bit reversal."""
    b = _u32(i)
    b = ((b & np.uint32(0x55555555)) << 1) | ((b & np.uint32(0xAAAAAAAA)) >> 1)
    b = ((b & np.uint32(0x33333333)) << 2) | ((b & np.uint32(0xCCCCCCCC)) >> 2)
    b = ((b & np.uint32(0x0F0F0F0F)) << 4) | ((b & np.uint32(0xF0F0F0F0)) >> 4)
    b = ((b & np.uint32(0x00FF00FF)) << 8) | ((b & np.uint32(0xFF00FF00)) >> 8)
    b = (b << 16) | (b >> 16)
    return b.astype(jnp.float32) * np.float32(2.3283064365386963e-10)


def halton(base: int, i: jnp.ndarray, iters: int = 20) -> jnp.ndarray:
    """Halton radical inverse in integer `base`, vectorized, fixed iterations.

    20 base-3 digits cover indices up to 3^20 ~ 3.5e9, far beyond any frame
    count we will see.
    """
    if base == 2:
        return radical_inverse_base2(i)
    i = jnp.asarray(i).astype(jnp.int32)
    r = jnp.zeros(i.shape, jnp.float32)
    f = jnp.ones(i.shape, jnp.float32)
    for _ in range(iters):
        f = f / base
        r = r + f * (i % base).astype(jnp.float32)
        i = i // base
    return r


def halton23(i: jnp.ndarray) -> jnp.ndarray:
    """(Halton base 2, Halton base 3) pair, shape (..., 2)."""
    return jnp.stack([halton(2, i), halton(3, i)], axis=-1)


def apply_lds_rotation(noise: jnp.ndarray, frame_index) -> jnp.ndarray:
    """Cranley-Patterson rotation: frac(noise + Halton23(frame)).

    This is how the reference turns static blue-noise textures into a
    progressive sequence (RayGenCommon.h:77-80).
    """
    shift = halton23(jnp.asarray(frame_index))
    return jnp.mod(noise + shift, 1.0)


# ----------------------------------------------------------------------------
# Blue-noise texture sampling (RayGenCommon.h:102-122).


def blue_noise_streams(blue0, blue1, px, py, frame_index):
    """Fetch the 4 blue-noise 2D streams for pixel (px, py) at `frame_index`.

    blue0/blue1: float32[256, 256, 4] arrays in [0,1) (the reference's
    LDR_RGBA_0/1 textures, G5 in SURVEY.md). Returns dict of (N,2) arrays.
    """
    ix = (px % 256).astype(jnp.int32)
    iy = (py % 256).astype(jnp.int32)
    t0 = blue0[iy, ix]
    t1 = blue1[iy, ix]
    return {
        "primary_jitter": apply_lds_rotation(t0[..., 0:2], frame_index),
        "secondary_dir": apply_lds_rotation(t0[..., 2:4], frame_index),
        "area_light": apply_lds_rotation(t1[..., 0:2], frame_index),
        "dof": apply_lds_rotation(t1[..., 2:4], frame_index),
    }
