"""Golden-image tests against the Tungsten reference renders.

The BASELINE fidelity gates: render the bundled scenes and compare
against the converged Tungsten EXRs via the native PIZ decoder
(SURVEY.md section 4 item 2). The full-resolution converged comparisons
are marked slow; the fast tests gate on the decoder itself and a
downsampled structural comparison.
"""

import os

import numpy as np
import pytest

TEAPOT_EXR = "/root/reference/Scenes/Teapot/TungstenRender.exr"
TEAPOT_PNG = "/root/reference/Scenes/Teapot/TungstenRender.png"
DRAGON_EXR = "/root/reference/Scenes/dragon/TungstenRender.exr"


def require(path):
    if not os.path.exists(path):
        pytest.skip(f"golden not present: {path}")
    return path


class TestPizDecoder:
    def test_teapot_exr_decodes(self):
        from tracerboy_tpu.core.image_io import read_exr_rgb

        img = read_exr_rgb(require(TEAPOT_EXR))
        assert img.shape == (720, 1280, 3)
        assert np.isfinite(img).all()
        assert 0.1 < img.mean() < 1.0

    def test_dragon_exr_decodes(self):
        from tracerboy_tpu.core.image_io import read_exr_rgb

        img = read_exr_rgb(require(DRAGON_EXR))
        assert img.shape[2] == 3 and np.isfinite(img).all()

    def test_teapot_matches_png_structurally(self):
        """Decoded HDR, tonemapped, must correlate strongly with the
        shipped tonemapped PNG of the same render."""
        from tracerboy_tpu.core.image_io import read_exr_rgb, read_ldr

        img = read_exr_rgb(require(TEAPOT_EXR))
        png = read_ldr(require(TEAPOT_PNG))[..., :3]
        tm = np.clip(img / (1 + img), 0, 1) ** (1 / 2.2)
        corr = np.corrcoef(tm[..., 1].ravel(), png[..., 1].ravel())[0, 1]
        assert corr > 0.65


@pytest.mark.slow
class TestConvergedGoldens:
    def test_teapot_render_vs_tungsten(self):
        """Render Teapot and compare against the Tungsten golden.

        Relative RMSE in tonemapped space at reduced resolution; the
        renderers differ (env importance sampling, filter) so the gate is
        loose — it catches gross shading/geometry errors.
        """
        from tracerboy_tpu import Renderer
        from tracerboy_tpu.core.image_io import read_exr_rgb

        golden = read_exr_rgb(require(TEAPOT_EXR))
        scene = require("/root/reference/Scenes/Teapot/scene.pbrt")
        r = Renderer(scene, film_size=(160, 90))
        r.render_sample(32)
        ours = np.asarray(r.resolve_radiance())
        # Downsample golden to match.
        gh = golden.reshape(90, 8, 160, 8, 3).mean(axis=(1, 3))
        tm = lambda x: np.clip(x / (1 + x), 0, 1)
        rmse = np.sqrt(((tm(ours) - tm(gh)) ** 2).mean())
        assert rmse < 0.15, rmse


class TestFidelityGateFast:
    """Default-suite RMSE gate (not @slow): a quick cornell render must
    track the committed converged golden (goldens/cornell_512.exr) —
    catches any regression in shading, accumulation or tonemap."""

    GOLDEN = os.path.join(
        os.path.dirname(__file__), "..", "goldens", "cornell_512.exr"
    )

    def test_cornell_rmse_vs_converged_golden(self):
        from PIL import Image

        import tests.conftest as c
        from tracerboy_tpu import Renderer
        from tracerboy_tpu.core.image_io import read_exr_rgb

        golden = read_exr_rgb(require(self.GOLDEN))
        size = 64
        g = np.asarray(
            Image.fromarray(
                (np.clip(golden, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)
            ).resize((size, size), Image.BILINEAR),
            dtype=np.float32,
        ) / 255.0

        # The golden was rendered from the reference's own Cornell box.
        path = c.require_reference_scene("cornell-box/scene.pbrt")
        r = Renderer(path, film_size=(size, size))
        r.render_sample(24)
        img = np.clip(np.asarray(r.resolve_radiance()), 0, 1) ** (1 / 2.2)
        rmse = float(np.sqrt(np.mean((img - g) ** 2)))
        # 24 spp of MC noise at 64x64 lands ~0.03-0.05; 0.08 catches
        # real breakage while staying robust to sampler changes.
        assert rmse < 0.08, rmse
