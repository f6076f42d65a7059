"""Where the persistent XLA compile cache lives.

One rule for every entry point (CLI, chip_smoke.py, bench.py, tests):
when JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
is set in code; otherwise the cache is <checkout>/.jax_cache (listed in
.gitignore). A fixed path matters: it is part of the cache's key, so a
directory that moves never hits.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
