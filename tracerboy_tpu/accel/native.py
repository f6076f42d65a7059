"""ctypes bindings for the native C++ binned-SAH BVH builder.

The host-runtime native component replacing the reference's C++/HLSL
acceleration-structure build stack (D3D12RaytracingFallback, SURVEY.md
2.5). Builds native/bvh_builder.cpp on first use with g++
(utils/native_build.py) and falls back to the pure-numpy LBVH builder
when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tracerboy_tpu.accel.bvh import WideBVH

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        from tracerboy_tpu.utils.native_build import build_native

        lib = ctypes.CDLL(build_native("bvh_builder.cpp"))
        lib.tb_bvh_build.restype = ctypes.c_void_p
        lib.tb_bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.tb_bvh_num_wide.restype = ctypes.c_int32
        lib.tb_bvh_num_wide.argtypes = [ctypes.c_void_p]
        lib.tb_bvh_num_clusters.restype = ctypes.c_int32
        lib.tb_bvh_num_clusters.argtypes = [ctypes.c_void_p]
        lib.tb_bvh_copy.restype = None
        lib.tb_bvh_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tb_bvh_free.restype = None
        lib.tb_bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(v0, v1, v2, leaf_size: int = 4) -> WideBVH:
    """Binned-SAH 8-wide BVH via the native builder.

    Note: unlike the LBVH path, tri_order may contain duplicated indices
    (clusters pad short SAH leaves with their last triangle), so callers
    must treat it as a gather map, not a permutation.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native builder unavailable")
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    tris = np.concatenate(
        [v0[:, None, :], v1[:, None, :], v2[:, None, :]], axis=1
    ).astype(np.float32)
    tris = np.ascontiguousarray(tris.reshape(T, 9))

    h = lib.tb_bvh_build(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, leaf_size
    )
    try:
        W = lib.tb_bvh_num_wide(h)
        C = lib.tb_bvh_num_clusters(h)
        lo = np.empty((W, 8, 3), np.float32)
        hi = np.empty((W, 8, 3), np.float32)
        children = np.empty((W, 8), np.int32)
        order = np.empty((C * leaf_size,), np.int32)
        lib.tb_bvh_copy(
            h,
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            children.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        lib.tb_bvh_free(h)

    scene_lo = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    scene_hi = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    return WideBVH(
        bounds_lo=lo, bounds_hi=hi, children=children,
        tri_order=order.astype(np.int64), leaf_size=leaf_size,
        num_tris=T, world_lo=scene_lo, world_hi=scene_hi,
        num_clusters=C,
    )


def build_bvh_auto(v0, v1, v2, leaf_size: int = 4) -> WideBVH:
    """Native SAH builder when available (or TB_BVH=python to force the
    numpy LBVH)."""
    if os.environ.get("TB_BVH") != "python" and native_available():
        return build_bvh_native(v0, v1, v2, leaf_size)
    from tracerboy_tpu.accel.bvh import build_bvh

    return build_bvh(v0, v1, v2, leaf_size)
