"""Denoiser fine-tune machinery (ml/finetune.py): transfer round-trip,
save/load, and a tiny CPU training smoke on random data."""

import numpy as np
import pytest


def test_reinhard_roundtrip():
    from tracerboy_tpu.ml.finetune import reinhard_fwd, reinhard_inv

    x = np.array([0.0, 0.1, 1.0, 10.0, 50.0], np.float32)
    y = reinhard_inv(reinhard_fwd(x))
    # invertible below the 0.995 display clip (~ linear 90)
    np.testing.assert_allclose(y, x, rtol=1e-3, atol=1e-5)
    # above the clip: bounded, monotone-safe
    assert reinhard_inv(reinhard_fwd(np.float32(1e4))) < 120.0


def test_params_npz_roundtrip(tmp_path):
    import jax

    from tracerboy_tpu.ml.finetune import load_params_npz, save_params_npz
    from tracerboy_tpu.ml.oidn import in_channels, init_params, unet_apply

    params = init_params(jax.random.PRNGKey(0), 3)
    path = str(tmp_path / "w.npz")
    save_params_npz(path, params)
    p2 = load_params_npz(path)
    assert in_channels(p2) == 3
    x = np.random.default_rng(0).random((1, 32, 32, 3), np.float32)
    a = unet_apply(params, x)
    b = unet_apply(p2, x)
    # float16 storage: outputs agree to half precision
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=0.02, atol=0.02)


def test_finetune_smoke(tmp_path, monkeypatch):
    """3 steps on a 32x32 random-init model: loss finite, params move,
    holdout evaluated, weights saved."""
    import jax

    import tracerboy_tpu.ml.finetune as ft
    from tracerboy_tpu.ml.oidn import init_params

    rng = np.random.default_rng(1)
    clean = rng.random((6, 32, 32, 3), np.float32) * 0.5
    inp = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
    tgt = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    data = str(tmp_path / "d.npz")
    np.savez(data, inp=np.maximum(inp, 0).astype(np.float16),
             tgt=np.maximum(tgt, 0).astype(np.float16),
             expo=np.ones(6, np.float32),
             view=np.arange(6, dtype=np.int32),
             meta=np.asarray([8, 128], np.int32))

    # random-init weights substitute: intercept load_oidn
    params = init_params(jax.random.PRNGKey(0), 3)
    monkeypatch.setattr(
        "tracerboy_tpu.ml.oidn.load_oidn", lambda path: params)

    out = str(tmp_path / "ft.npz")
    logs = []
    h0, h1 = ft.finetune(data, out, init_weights="ignored", steps=3,
                         lr=1e-3, batch=2, holdout_views=2,
                         log_every=1, progress=logs.append)
    assert np.isfinite(h0) and np.isfinite(h1)
    assert any("step 3/3" in m for m in logs)
    p2 = ft.load_params_npz(out)
    k0 = np.asarray(params["enc_conv0"]["kernel"])
    k1 = np.asarray(p2["enc_conv0"]["kernel"])
    assert not np.allclose(k0, k1), "params did not move"


def test_orbit_offsets_bounded():
    from tracerboy_tpu.ml.finetune import orbit_offsets

    views = orbit_offsets(64, diag=10.0, rng=np.random.default_rng(0))
    assert len(views) == 64
    for v in views:
        assert abs(v["yaw"]) <= 0.10 and abs(v["pitch"]) <= 0.06
        assert abs(v["forward"]) <= 0.15 + 1e-9
        assert abs(v["strafe"]) <= 0.15 + 1e-9
    # views must actually differ (no degenerate duplicates)
    assert len({round(v["yaw"], 6) for v in views}) > 32
