"""Build the repository's host C++ helpers (native/*.cpp) at first use.

Each library is compiled on the host that loads it, into native/build/
(listed in .gitignore), under a name keyed by a hash of its source, the
compiler flags and the host architecture, so a stale binary or one
built for another machine is never loaded. The compiler writes a
temporary file that is renamed into place, so concurrent processes
never load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def build_native(src_name: str) -> str:
    """Path of the shared library built from native/<src_name>,
    compiling it with g++ first if this host has no current build."""
    src = os.path.join(NATIVE_DIR, src_name)
    with open(src, "rb") as f:
        source = f.read()
    key = hashlib.sha256(
        source + " ".join(CXX_FLAGS).encode() + platform.machine().encode()
    ).hexdigest()[:16]
    so = os.path.join(
        BUILD_DIR, f"lib{os.path.splitext(src_name)[0]}-{key}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so
