"""OIDN-style UNet denoiser as pure JAX functions.

The rebuild of the reference's from-scratch DirectML port of Open Image
Denoise (TracerBoy/OpenImageDenoise.cpp:855-1000: the enc_conv0..enc_conv5b
/ dec_conv4a..dec_conv0 topology of 16 conv + 4 maxpool + 4
nearest-upsample + 4 concat joins, ReLU, NHWC). Parameters are a plain
`{layer: {"kernel": (3, 3, in, out) HWIO, "bias": (out,)}}` dict; the
convolutions are `lax.conv_general_dilated` calls that XLA hands to the
GPU's convolution library. Production runs take bf16 operands with f32
accumulation; `precision`/`dtype` select an f32 reference run of the
same graph.

Weights: the committed fine-tuned colour-only network
(`ml/weights/rt_ldr_ft.npz`, DEFAULT_WEIGHTS) or any of the reference's
`.tza` archives given by path (ml/tza.py).

Inputs: color (+ albedo + normal for a 9-channel network), HWC in [0,1]
after tonemapping; spatial dims must be multiples of 16 (the reference
enforces the same, WinMain.cpp:212-214) — `denoise_image` pads
reflectively and crops back.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

ALIGNMENT = 16
DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "weights", "rt_ldr_ft.npz"
)

# (layer, output channels) in graph order; input channels follow from
# the graph (skip joins concatenate the pooled encoder features).
LAYERS = (
    ("enc_conv0", 32), ("enc_conv1", 32), ("enc_conv2", 48),
    ("enc_conv3", 64), ("enc_conv4", 80), ("enc_conv5a", 96),
    ("enc_conv5b", 96), ("dec_conv4a", 112), ("dec_conv4b", 112),
    ("dec_conv3a", 96), ("dec_conv3b", 96), ("dec_conv2a", 64),
    ("dec_conv2b", 64), ("dec_conv1a", 64), ("dec_conv1b", 32),
    ("dec_conv0", 3),
)


def in_channels(params) -> int:
    """Input feature count of a parameter set (3 colour-only, 9 aux)."""
    return int(params["enc_conv0"]["kernel"].shape[2])


def _layer_inputs(in_ch: int) -> dict:
    """Input channels per layer; decoder inputs are (upsampled, skip)."""
    return dict(
        enc_conv0=in_ch, enc_conv1=32, enc_conv2=32, enc_conv3=48,
        enc_conv4=64, enc_conv5a=80, enc_conv5b=96,
        dec_conv4a=96 + 64, dec_conv4b=112, dec_conv3a=112 + 48,
        dec_conv3b=96, dec_conv2a=96 + 32, dec_conv2b=64,
        dec_conv1a=64 + in_ch, dec_conv1b=64, dec_conv0=32,
    )


def init_params(key, in_ch: int = 3) -> dict:
    """Random parameters (LeCun-normal kernels, zero biases)."""
    ins = _layer_inputs(in_ch)
    params = {}
    for name, out_ch in LAYERS:
        key, sub = jax.random.split(key)
        fan_in = 9 * ins[name]
        params[name] = {
            "kernel": jax.random.normal(
                sub, (3, 3, ins[name], out_ch), jnp.float32)
            * np.float32(np.sqrt(1.0 / fan_in)),
            "bias": jnp.zeros((out_ch,), jnp.float32),
        }
    return params


def unet_apply(params, x, dtype=jnp.bfloat16, precision=None):
    """The OIDN `rt` UNet on a (B, H, W, C) batch -> (B, H, W, 3) f32.

    Convolution operands are cast to `dtype` and accumulate in f32
    (bias and ReLU in f32, activations stored in `dtype`). dtype=f32
    with precision=lax.Precision.HIGHEST is the full-precision
    reference of the same graph; training differentiates the f32 graph
    (the mixed bf16-operand/f32-result convolution has no transpose
    rule)."""

    def conv(name, y, relu=True):
        p = params[name]
        out = jax.lax.conv_general_dilated(
            y.astype(dtype), p["kernel"].astype(dtype),
            window_strides=(1, 1), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=precision, preferred_element_type=jnp.float32,
        ) + p["bias"].astype(jnp.float32)
        return (jax.nn.relu(out) if relu else out).astype(
            dtype if relu else jnp.float32)

    def pool(y):
        return jax.lax.reduce_window(
            y, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID",
        )

    def up(y):
        return jnp.repeat(jnp.repeat(y, 2, axis=1), 2, axis=2)

    inp = x.astype(dtype)
    x1 = conv("enc_conv1", conv("enc_conv0", inp))
    p1 = pool(x1)
    p2 = pool(conv("enc_conv2", p1))
    p3 = pool(conv("enc_conv3", p2))
    p4 = pool(conv("enc_conv4", p3))
    x5 = conv("enc_conv5b", conv("enc_conv5a", p4))

    d4 = conv("dec_conv4b", conv(
        "dec_conv4a", jnp.concatenate([up(x5), p3], axis=-1)))
    d3 = conv("dec_conv3b", conv(
        "dec_conv3a", jnp.concatenate([up(d4), p2], axis=-1)))
    d2 = conv("dec_conv2b", conv(
        "dec_conv2a", jnp.concatenate([up(d3), p1], axis=-1)))
    d1 = conv("dec_conv1b", conv(
        "dec_conv1a", jnp.concatenate([up(d2), inp], axis=-1)))
    return conv("dec_conv0", d1, relu=False)


def params_from_tza(tza: dict) -> dict:
    """Map tza tensors {name.weight oihw, name.bias} to HWIO params,
    mirroring the reference's oihw->NHWC conversion
    (OpenImageDenoise.cpp:2072-2120)."""
    params = {}
    names = sorted({k.rsplit(".", 1)[0] for k in tza})
    for name in names:
        w, layout = tza[f"{name}.weight"]
        assert layout == "oihw", layout
        kernel = np.transpose(w, (2, 3, 1, 0))  # oihw -> hwio
        bias = tza[f"{name}.bias"][0]
        params[name] = {"kernel": jnp.asarray(kernel, jnp.float32),
                        "bias": jnp.asarray(bias, jnp.float32)}
    return params


def load_oidn(path: str = DEFAULT_WEIGHTS) -> dict:
    """Parameters from a .tza archive or a flat .npz
    (ml/finetune.save_params_npz)."""
    if path.endswith(".npz"):
        from tracerboy_tpu.ml.finetune import load_params_npz

        return load_params_npz(path)
    from tracerboy_tpu.ml.tza import read_tza

    return params_from_tza(read_tza(path))


@jax.jit
def _denoise_padded(params, x):
    return unet_apply(params, x[None])[0]


def denoise_image(params, color, albedo=None, normal=None):
    """Denoise an (H, W, 3) LDR color image (+ optional aux features).

    Pads H/W up to multiples of 16 with reflection and crops the result
    (the reference instead constrains the window size).
    """
    feats = [color]
    if in_channels(params) >= 9:
        feats.append(
            albedo if albedo is not None else jnp.zeros_like(color)
        )
        feats.append(
            normal if normal is not None else jnp.zeros_like(color)
        )
    x = jnp.concatenate(feats, axis=-1)
    H, W = x.shape[:2]
    ph = (-H) % ALIGNMENT
    pw = (-W) % ALIGNMENT
    x = jnp.pad(x, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    out = _denoise_padded(params, x)
    return jnp.clip(out[:H, :W], 0.0, None)
