"""The pure-function OIDN UNet (ml/oidn.py) against a plain numpy f64
evaluation of the same graph, on the committed weights."""

import numpy as np
import jax
import pytest

from tracerboy_tpu.ml.oidn import (
    DEFAULT_WEIGHTS,
    LAYERS,
    in_channels,
    load_oidn,
    unet_apply,
)


def _conv_np(x, kernel, bias):
    """3x3 SAME convolution, NHWC x HWIO, in f64."""
    k = np.asarray(kernel, np.float64)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    H, W = x.shape[1:3]
    out = np.zeros(x.shape[:3] + (k.shape[3],))
    for dy in range(3):
        for dx in range(3):
            out += np.einsum("bhwc,co->bhwo",
                             xp[:, dy:dy + H, dx:dx + W], k[dy, dx])
    return out + np.asarray(bias, np.float64)


def _unet_np(params, x):
    def conv(name, y, relu=True):
        out = _conv_np(y, params[name]["kernel"], params[name]["bias"])
        return np.maximum(out, 0.0) if relu else out

    def pool(y):
        b, h, w, c = y.shape
        return y.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))

    def up(y):
        return y.repeat(2, axis=1).repeat(2, axis=2)

    cat = lambda a, b: np.concatenate([a, b], axis=-1)
    p1 = pool(conv("enc_conv1", conv("enc_conv0", x)))
    p2 = pool(conv("enc_conv2", p1))
    p3 = pool(conv("enc_conv3", p2))
    p4 = pool(conv("enc_conv4", p3))
    x5 = conv("enc_conv5b", conv("enc_conv5a", p4))
    d4 = conv("dec_conv4b", conv("dec_conv4a", cat(up(x5), p3)))
    d3 = conv("dec_conv3b", conv("dec_conv3a", cat(up(d4), p2)))
    d2 = conv("dec_conv2b", conv("dec_conv2a", cat(up(d3), p1)))
    d1 = conv("dec_conv1b", conv("dec_conv1a", cat(up(d2), x)))
    return conv("dec_conv0", d1, relu=False)


@pytest.fixture(scope="module")
def committed():
    return load_oidn(DEFAULT_WEIGHTS)


def _image(seed=0, h=32, w=48):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([xx, yy, 0.5 * (xx + yy)], axis=-1)
    return np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)[None]


def test_npz_loader_layout(committed):
    assert set(committed) == {name for name, _ in LAYERS}
    assert in_channels(committed) == 3
    for name, out_ch in LAYERS:
        k = committed[name]["kernel"]
        assert k.shape[:2] == (3, 3) and k.shape[3] == out_ch
        assert committed[name]["bias"].shape == (out_ch,)
        assert k.dtype == np.float32


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 5e-3)])
def test_unet_matches_numpy(committed, dtype, tol):
    x = _image()
    ref = _unet_np(committed, x)
    if dtype == "f32":
        got = unet_apply(committed, x, dtype=np.float32,
                         precision=jax.lax.Precision.HIGHEST)
    else:
        got = unet_apply(committed, x)
    got = np.asarray(got)
    assert got.shape == ref.shape == (1, 32, 48, 3)
    assert got.dtype == np.float32
    assert np.abs(got - ref).mean() < tol
