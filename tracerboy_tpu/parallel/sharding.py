"""Multi-chip scaling: pixel-tile and sample sharding over a device mesh.

The reference is a single-GPU renderer (SURVEY.md section 2.8); this
rebuild scales across devices with jax.sharding instead of translating
any queue/fence machinery:

- **Tile sharding** (primary axis): the flat pixel-id pool is sharded over
  a 1-D "tiles" mesh; the scene is replicated; every per-ray array in the
  wavefront inherits the pixel sharding, so the whole render step runs
  SPMD with zero communication. The final image gather happens only at
  host readout — the analog of the reference's single CopyResource to the
  backbuffer per frame.
- **Sample (spp) sharding**: every device traces the full image with a
  different sample index and accumulators merge with a `psum` (an
  all-reduce; every device reaches every other at the same rate, so the
  mesh is 1-D) — the direct analog of data-parallel gradient
  accumulation.
- Stats (ray counts, live lanes) reduce with the same psum.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tracerboy_tpu.trace.wavefront import WaveConfig, render_wave


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), axis_names=("tiles",))


def shard_pixels(mesh: Mesh, width: int, height: int):
    """Flat pixel ids laid out so each device owns contiguous rows."""
    n = width * height
    ndev = mesh.devices.size
    pad = (-n) % ndev
    ids = jnp.arange(n + pad, dtype=jnp.int32)
    sharding = NamedSharding(mesh, P("tiles"))
    return jax.device_put(ids, sharding), pad


# Jitted callables are cached per (mesh, cfg[, spd]) — rebuilding the jit
# wrapper every call would retrace and recompile the whole wavefront
# program each frame.
_tiled_cache: dict = {}
_spp_cache: dict = {}


def render_wave_tiled(mesh, scene, params, pixel_ids, sample_index, cfg):
    """Tile-sharded render step: pixel pool split over the mesh, scene
    replicated; no collectives in the hot path.

    Per-lane params (pre-gathered blue noise, the adaptive active_mask)
    are detected by their leading dim matching the pixel pool and get
    the same tile sharding; everything else replicates."""
    n_lanes = pixel_ids.shape[0]

    def _is_lane(x):
        return getattr(x, "ndim", 0) >= 1 and x.shape[0] == n_lanes

    leaves = jax.tree_util.tree_leaves_with_path(params)
    pkey = tuple(
        (jax.tree_util.keystr(p), _is_lane(leaf)) for p, leaf in leaves
    )
    key = (id(mesh), cfg, n_lanes, pkey)
    fn = _tiled_cache.get(key)
    if fn is None:
        replicated = NamedSharding(mesh, P())
        sharded = NamedSharding(mesh, P("tiles"))
        param_shardings = jax.tree_util.tree_map(
            lambda x: sharded if _is_lane(x) else replicated, params
        )
        fn = jax.jit(
            partial(render_wave, cfg=cfg),
            in_shardings=(replicated, param_shardings, sharded,
                          replicated),
            out_shardings=None,  # per-ray outputs stay tile-sharded
        )
        _tiled_cache[key] = fn
    return fn(scene, params, pixel_ids, sample_index)


def render_spp_sharded(mesh, scene, params, pixel_ids, base_sample, cfg,
                       samples_per_device: int = 1):
    """Sample-sharded render step with psum-merged accumulators.

    Every device traces the full pixel pool at sample indices
    base + dev * samples_per_device + k; radiance/weight sums merge
    across the mesh with psum inside shard_map. Returns the replicated
    accumulated (radiance_sum, weight_sum, rays_traced).
    """
    import dataclasses

    from jax import shard_map

    # AOVs are per-pixel snapshots, not sums — they don't survive a psum
    # merge. The sharded step returns only the accumulator planes.
    cfg_l = dataclasses.replace(cfg, want_aovs=False)

    ndev = mesh.devices.size
    dev_ids = jnp.arange(ndev, dtype=jnp.int32)

    key = (id(mesh), cfg, samples_per_device)
    fn = _spp_cache.get(key)
    if fn is None:
        def per_device(dev_id, base_l, scene_l, params_l, pixel_ids_l):
            dev = dev_id[0]
            base_dev = base_l + dev * samples_per_device
            # Tie carries to the device id so their device-varying
            # type is stable across fori_loop iterations.
            vz = dev.astype(jnp.float32) * 0.0
            rad = jnp.zeros(
                (pixel_ids_l.shape[0], 3), jnp.float32) + vz
            fw = jnp.zeros((pixel_ids_l.shape[0],), jnp.float32) + vz
            rays = vz

            def body(k, carry):
                rad, fw, rays = carry
                out = render_wave(scene_l, params_l, pixel_ids_l,
                                  base_dev + k, cfg_l)
                rad = rad + jnp.stack(
                    [out["radiance_r"], out["radiance_g"],
                     out["radiance_b"]], axis=-1,
                )
                return (rad, fw + out["filter_weight"],
                        rays + out["rays_traced"])

            rad, fw, rays = jax.lax.fori_loop(
                0, samples_per_device, body, (rad, fw, rays)
            )
            # Merge accumulators across the mesh.
            rad = jax.lax.psum(rad, "tiles")
            fw = jax.lax.psum(fw, "tiles")
            rays = jax.lax.psum(rays, "tiles")
            return rad, fw, rays

        fn = jax.jit(shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P("tiles"), P(), P(), P(), P()),
            out_specs=(P(), P(), P()),
        ))
        _spp_cache[key] = fn
    return fn(dev_ids, jnp.asarray(base_sample, jnp.int32), scene, params,
              pixel_ids)
