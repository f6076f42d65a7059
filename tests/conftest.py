"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device sharding paths are exercised on a virtual CPU mesh (the
strategy SURVEY.md section 4 prescribes); speed is measured only on the
GPU (chip_smoke.py, bench.py). Must set flags before jax initializes.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

from tracerboy_tpu.utils.compile_cache import enable_compile_cache

# Persistent compile cache + bounded live-executable set: the XLA CPU
# compiler segfaults deterministically deep into a single-process run of
# the full suite (reproduced twice at the same point, LLVM frame inside
# backend_compile_and_load; test modules pass in isolation). Clearing
# jax's executable caches between modules keeps the compiler state
# bounded, and the disk cache makes the resulting recompiles cheap.
enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_compiler_state():
    yield
    jax.clear_caches()


# The reference's scene set is not part of this repository. The Cornell
# box is re-authored under tests/scenes/; tests that compare against
# goldens rendered from the reference's own files need a checkout of the
# reference, named by TRACERBOY_REFERENCE (require_reference_scene).
REFERENCE_SCENES = os.path.join(
    os.environ.get("TRACERBOY_REFERENCE", "reference-not-set"), "Scenes")
SCENES_ROOT = os.path.join(os.path.dirname(__file__), "scenes")


def require_scene(name: str) -> str:
    """Path of an in-repository test scene (tests/scenes/<name>)."""
    path = os.path.join(SCENES_ROOT, name)
    if not os.path.exists(path):
        pytest.skip(f"test scene not available: {path}")
    return path


def require_reference_scene(name: str) -> str:
    """Path of a scene from the reference's own checkout; skips when
    that checkout is absent."""
    path = os.path.join(REFERENCE_SCENES, name)
    if not os.path.exists(path):
        pytest.skip(f"reference scene not available: {path}")
    return path


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
