"""Environment rules of the GPU bring-up: the compile-cache location,
PNG output without PIL, a CLI run with neither flax nor PIL importable,
and chip_smoke.py refusing to run without a GPU."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


class TestCompileCache:
    def test_env_variable_wins(self, monkeypatch, tmp_path):
        import jax

        from tracerboy_tpu.utils.compile_cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        # Nothing is set in code when the variable names the directory.
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_checkout_cache(self, monkeypatch):
        import jax

        from tracerboy_tpu.utils.compile_cache import enable_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path


def _read_png(path):
    """Minimal decoder for the 8-bit, filter-0 PNGs write_png emits."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c)
    assert depth == 8 and (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, rng, channels):
    from tracerboy_tpu.core.image_io import write_png

    img = rng.random((7, 11, channels)).astype(np.float32)
    p = str(tmp_path / "x.png")
    write_png(p, img[..., 0] if channels == 1 else img)
    back = _read_png(p)
    np.testing.assert_array_equal(
        back, (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
    try:
        from PIL import Image
    except ImportError:
        return
    pil = np.asarray(Image.open(p))
    np.testing.assert_array_equal(pil.reshape(back.shape), back)


def test_cli_runs_without_flax_and_pil(tmp_path):
    """Render + OIDN denoise + PNG output with flax and PIL unimportable
    (neither is guaranteed beside JAX on the GPU machine)."""
    out = str(tmp_path / "o.png")
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['PIL'] = None\n"
        "from tracerboy_tpu.app.cli import main\n"
        f"rc = main(['shadertoy:cornell', '--spp', '1', '--size', "
        f"'16x16', '--max-bounces', '2', '--denoiser', 'oidn', '--out', "
        f"{out!r}, '-q'])\n"
        "assert 'flax' not in sys.modules or sys.modules['flax'] is None\n"
        "sys.exit(rc)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=_child_env(), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _read_png(out).shape == (16, 16, 3)


def test_chip_smoke_refuses_cpu(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=str(tmp_path), env=_child_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
