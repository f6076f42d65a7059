#!/usr/bin/env python3
"""GPU smoke test of the path tracer's main path, on real shapes.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # only the 4-card sharded renders

Phases (one card):
  device   JAX's first device must be a GPU.
  cli-*    The CLI (tracerboy_tpu.app.cli.main) on the procedural
           `shadertoy` scene (19 tessellated spheres, ~44k triangles, BVH
           path) at 1920x1080, 6 bounces + NEE: progressive, RealTime,
           8 spp + the committed OIDN UNet; `shadertoy:cornell` at 512^2
           (brute-force path) with and without the procedural cloud.
  traverse The lock-step BVH traversal against brute force on >=1M
           primary and bounce rays of the shadertoy scene (closest hit
           and shadow any-hit).
  render   A 640x360 render on the BVH backend against the same render
           with TB_TRAVERSAL=brute (same seed).
  lookup   Material/light table gathers against numpy, bit-exact; the
           gather timed against the one-hot product it replaced.
  unet     The bf16 UNet against its f32 HIGHEST-precision run at
           1920x1088.
  animate  Renderer.update_geometry on a deformed shadertoy scene
           against brute force over the deformed triangles.

Each phase prints compile seconds, steady seconds (wall minus compile),
Mrays/s where it traces, peak device memory and the card. The last
line is {"ok": true, "device": {...}}; any failed check, or no GPU,
ends the run with a non-zero exit and {"ok": false, ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "smoke")

FULL = (1920, 1080)
SMALL = (640, 360)
CORNELL = (512, 512)


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_name() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


class Phases:
    """Phase runner: timing, compile accounting, memory, reporting."""

    def __init__(self, card: str):
        import jax

        self.card = card
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        # XLA's own compile (tracing and lowering are counted as steady).
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    @staticmethod
    def peak_bytes() -> int:
        import jax

        return max(d.memory_stats().get("peak_bytes_in_use", 0)
                   for d in jax.local_devices())

    def run(self, name, fn, *args):
        c0, t0 = self.compile_s, time.perf_counter()
        info = fn(*args) or {}
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        steady = max(wall - comp, 1e-9)
        rays = info.pop("rays", None)
        rate = (f"  {rays / steady / 1e6:.2f} Mrays/s ({rays:.4g} rays)"
                if rays else "")
        print(f"[{name}] compile {comp:.1f} s  steady {steady:.1f} s"
              f"{rate}  peak {self.peak_bytes() / 2**30:.2f} GiB"
              f"  card {self.card}", flush=True)
        for k, v in info.items():
            print(f"    {k}: {v}", flush=True)


# ---------------------------------------------------------------------------
# CLI renders


def cli_phase(argv, out_png, size):
    from tracerboy_tpu.app.cli import main
    from tracerboy_tpu.core.image_io import read_pfm

    os.makedirs(OUT_DIR, exist_ok=True)
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "radiance.pfm")
        rc = main(list(argv) + ["--out", os.path.join(OUT_DIR, out_png),
                                "--hdr-out", pfm, "-q"], stats=stats)
        check(rc == 0, f"cli exit code {rc}")
        rad = read_pfm(pfm)
    w, h = size
    import numpy as np

    check(rad.shape == (h, w, 3), f"radiance shape {rad.shape}")
    check(np.isfinite(rad).all(), "non-finite radiance")
    mean = float(rad.mean())
    check(mean > 1e-3, f"black image (mean {mean})")
    check(stats["rays_traced"] > 0, "no rays traced")
    return dict(rays=stats["rays_traced"],
                result=f"spp {stats['spp']}, frames {stats['frames']}, "
                       f"mean radiance {mean:.4f}, image {out_png}")


# ---------------------------------------------------------------------------
# Traversal against brute force


def _scene_rays(sp, width, height, seed):
    """Primary rays through pixel centres plus bounce and shadow rays
    built from their first hits (cosine-ish bounce directions, shadow
    rays toward random points of the scene's light records)."""
    import jax
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.trace.camera import generate_primary_rays_soa

    n = width * height
    ids = jnp.arange(n, dtype=jnp.int32)
    half = jnp.full((n,), 0.5, jnp.float32)
    o, d = generate_primary_rays_soa(sp["camera"], width, height, ids,
                                     half, half)
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return v3.to_rows(o), v3.to_rows(d), keys


def traverse_phase(width, height):
    import jax
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.scene.compile import load_scene
    from tracerboy_tpu.trace.intersect import (
        BIG,
        brute_force_anyhit_soa,
        brute_force_closest_soa,
    )
    from tracerboy_tpu.trace.traverse import traverse_wide

    cs = load_scene("shadertoy", film_size=(width, height))
    sp = cs.as_pytree()
    tri9 = sp["tri9"]
    T = tri9.shape[0]
    mask = sp["tri_shadow_opaque"]

    @jax.jit
    def bvh_closest(o, d, tmax):
        return traverse_wide(o, d, tmax, sp["bvh_lo"], sp["bvh_hi"],
                             sp["bvh_children"], sp["tri_v0"],
                             sp["tri_v1"], sp["tri_v2"],
                             leaf_size=cs.leaf_size)[:2]

    @jax.jit
    def bvh_any(o, d, tmax):
        return traverse_wide(o, d, tmax, sp["bvh_lo"], sp["bvh_hi"],
                             sp["bvh_children"], sp["tri_v0"],
                             sp["tri_v1"], sp["tri_v2"],
                             leaf_size=cs.leaf_size, any_hit=True,
                             tri_mask=mask)

    @jax.jit
    def brute_closest(o, d, tmax):
        t, tri, _, _ = brute_force_closest_soa(
            v3.from_rows(o), v3.from_rows(d), tri9, tmax)
        return t, tri

    @jax.jit
    def brute_any(o, d, tmax):
        return brute_force_anyhit_soa(v3.from_rows(o), v3.from_rows(d),
                                      tri9, tmax, tri_opaque=mask)

    @jax.jit
    def compare(t_a, id_a, t_b, id_b):
        same = id_a == id_b
        # Degenerate padding copies duplicate a triangle: equal vertex
        # rows are the same surface.
        twin = jnp.all(tri9[jnp.clip(id_a, 0, T - 1)]
                       == tri9[jnp.clip(id_b, 0, T - 1)], axis=1)
        agree = same | ((id_a >= 0) & (id_b >= 0) & twin)
        both = agree & (id_b >= 0)
        rel = jnp.where(both, jnp.abs(t_a - t_b)
                        / jnp.maximum(jnp.abs(t_b), 1e-30), 0.0)
        return (jnp.mean(agree), jnp.mean(jnp.where(both, rel <= 1e-5, True)),
                jnp.max(rel), jnp.sum(id_b >= 0))

    o, d, (k1, k2, k3, k4) = _scene_rays(sp, width, height, 0)
    n = o.shape[0]
    big = jnp.full((n,), BIG, jnp.float32)
    t0, id0 = brute_closest(o, d, big)
    hit = id0 >= 0
    p = o + d * jnp.where(hit, t0, 0.0)[:, None]
    tri = tri9[jnp.clip(id0, 0, T - 1)]
    nrm = jnp.cross(tri[:, 3:6] - tri[:, 0:3], tri[:, 6:9] - tri[:, 0:3])
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=1, keepdims=True),
                            1e-12)
    nrm = jnp.where(jnp.sum(nrm * d, axis=1, keepdims=True) > 0, -nrm, nrm)
    rnd = jax.random.normal(k1, (n, 3))
    rnd = rnd / jnp.linalg.norm(rnd, axis=1, keepdims=True)
    bd = nrm + rnd
    bd = bd / jnp.maximum(jnp.linalg.norm(bd, axis=1, keepdims=True), 1e-12)
    # Misses re-launch from random points of the scene box.
    lo, hi = tri9.reshape(-1, 3).min(0), tri9.reshape(-1, 3).max(0)
    rp = lo + jax.random.uniform(k2, (n, 3)) * (hi - lo)
    b_o = jnp.where(hit[:, None], p + nrm * 1e-4, rp)
    b_d = jnp.where(hit[:, None], bd, rnd)
    # Shadow rays toward random points on the light records.
    L = cs.num_lights
    lights = sp["lights"]
    li = jax.random.randint(k3, (n,), 0, L)
    uv = jax.random.uniform(k4, (n, 2))
    flip = uv.sum(1) > 1
    uu = jnp.where(flip, 1 - uv[:, 0], uv[:, 0])[:, None]
    vv = jnp.where(flip, 1 - uv[:, 1], uv[:, 1])[:, None]
    lp = (lights["p0"][li] * (1 - uu - vv) + lights["p1"][li] * uu
          + lights["p2"][li] * vv)
    s_o = b_o
    s_v = lp - s_o
    s_t = jnp.linalg.norm(s_v, axis=1)
    s_d = s_v / jnp.maximum(s_t, 1e-12)[:, None]
    s_tmax = s_t * (1 - 1e-3)

    out = {}
    rays = 0
    for name, (oo, dd) in (("primary", (o, d)), ("bounce", (b_o, b_d))):
        t_b, id_b = (t0, id0) if name == "primary" else brute_closest(
            oo, dd, big)
        t_a, id_a = bvh_closest(oo, dd, big)
        agree, t_ok, t_max_rel, hits = (float(x) for x in
                                        compare(t_a, id_a, t_b, id_b))
        rays += n
        out[f"{name} closest"] = (
            f"{n} rays, {int(hits)} hits: ids agree on {agree:.6%}, "
            f"t within 1e-5 rel on {t_ok:.6%} (max rel {t_max_rel:.3g})")
        check(agree >= 0.9999, f"{name} closest-hit ids agree {agree}")
        check(t_ok >= 0.9999, f"{name} t agreement {t_ok}")
    occ_a = bvh_any(s_o, s_d, s_tmax)
    occ_b = brute_any(s_o, s_d, s_tmax)
    occ_agree = float(jnp.mean(occ_a == occ_b))
    rays += n
    out["shadow any-hit"] = (
        f"{n} rays, {float(jnp.mean(occ_b)):.2%} occluded: masks agree on "
        f"{occ_agree:.6%}")
    check(occ_agree >= 0.9999, f"any-hit masks agree {occ_agree}")
    out["tolerance"] = ("ids (or identical vertex rows) and shadow masks on "
                        ">= 99.99% of rays; t within 1e-5 relative on "
                        ">= 99.99% of agreeing hits; float32 on both sides")
    out["rays"] = 2 * rays   # each ray traced by both methods
    return out


# ---------------------------------------------------------------------------
# Whole render: BVH backend against brute force


def _render(scene, size, traversal, spp, renderer_hook=None):
    import numpy as np

    from tracerboy_tpu.renderer import Renderer

    old = os.environ.get("TB_TRAVERSAL")
    os.environ["TB_TRAVERSAL"] = traversal
    try:
        r = Renderer(scene, film_size=size, seed=7)
    finally:
        if old is None:
            os.environ.pop("TB_TRAVERSAL")
        else:
            os.environ["TB_TRAVERSAL"] = old
    check(r.traversal == traversal, f"backend {r.traversal}")
    if renderer_hook:
        renderer_hook(r)
    r.render_sample(spp)
    return np.asarray(r.resolve_radiance()), r.rays_traced


def _image_diff(a, b):
    import numpy as np

    check(np.isfinite(a).all() and np.isfinite(b).all(), "non-finite")
    return (float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12)),
            float(np.abs(a - b).max()))


def render_phase(size, spp):
    img_j, rays_j = _render("shadertoy", size, "jnp", spp)
    img_b, rays_b = _render("shadertoy", size, "brute", spp)
    rel, mx = _image_diff(img_j, img_b)
    check(img_j.shape == (size[1], size[0], 3), f"shape {img_j.shape}")
    check(rel <= 1e-3, f"mean relative difference {rel}")
    return dict(rays=rays_j + rays_b,
                result=f"{size[0]}x{size[1]}, {spp} spp, seed 7: mean "
                       f"relative difference {rel:.3g}, max abs {mx:.3g}",
                tolerance="mean |jnp - brute| / mean |brute| <= 1e-3")


# ---------------------------------------------------------------------------
# Table lookups


def lookup_phase(lanes, reps=20):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracerboy_tpu.scene.compile import load_scene
    from tracerboy_tpu.shade.nee import _light_table_t
    from tracerboy_tpu.shade.surface import _mat_table_t, _take_cols

    cs = load_scene("shadertoy", film_size=(8, 8))
    sp = cs.as_pytree()
    out = {}
    gather = jax.jit(_take_cols)

    @jax.jit
    def one_hot(table_t, idx):
        oh = (jnp.arange(table_t.shape[1])[:, None] == idx[None, :])
        return jnp.dot(table_t, oh.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)

    def timed(fn, *a):
        fn(*a).block_until_ready()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*a).block_until_ready()
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))

    for name, table_t in (("material", _mat_table_t(sp["materials"])),
                          ("light", _light_table_t(sp["lights"]))):
        M = table_t.shape[1]
        idx = jax.random.randint(jax.random.PRNGKey(M), (lanes,), 0, M)
        got = np.asarray(gather(table_t, idx))
        ref = np.asarray(table_t)[:, np.asarray(idx)]
        check(np.array_equal(got, ref), f"{name} gather not bit-exact")
        # The one-hot matrix is (M, lanes) f32; keep it under 8 GiB.
        oh_lanes = min(lanes, 2**31 // M)
        oh_idx = idx[:oh_lanes]
        oh_exact = np.array_equal(np.asarray(one_hot(table_t, oh_idx)),
                                  ref[:, :oh_lanes])
        out[name] = (
            f"({table_t.shape[0]}, {M}) table: gather x {lanes} lanes "
            f"{timed(gather, table_t, idx):.3f} ms (bit-exact vs numpy); "
            f"one-hot HIGHEST x {oh_lanes} lanes "
            f"{timed(one_hot, table_t, oh_idx):.3f} ms (bit-exact: "
            f"{oh_exact}); median of {reps}")
    return out


# ---------------------------------------------------------------------------
# UNet precision


def unet_phase(width, height):
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracerboy_tpu.ml.oidn import load_oidn, unet_apply

    params = load_oidn()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:height, 0:width] / max(height, width)
    base = np.stack([xx, yy, 0.5 * (xx + yy)], axis=-1)
    x = jnp.asarray(np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
                    [None].astype(np.float32))
    fast = jax.jit(unet_apply)
    ref = jax.jit(functools.partial(
        unet_apply, dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST))
    y = fast(params, x).block_until_ready()
    y_ref = ref(params, x).block_until_ready()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        fast(params, x).block_until_ready()
        ts.append(time.perf_counter() - t0)
    mae = float(jnp.mean(jnp.abs(jnp.clip(y, 0, 1) - jnp.clip(y_ref, 0, 1))))
    check(y.shape == (1, height, width, 3), f"shape {y.shape}")
    check(bool(jnp.isfinite(y).all()), "non-finite UNet output")
    check(mae <= 5e-3, f"UNet bf16 vs f32 MAE {mae}")
    return dict(result=f"{width}x{height}: bf16 vs f32 HIGHEST mean abs "
                       f"error {mae:.3g} on [0,1] output; bf16 "
                       f"{1e3 * float(np.median(ts)):.1f} ms/frame "
                       "(median of 5)",
                tolerance="mean abs error <= 5e-3")


# ---------------------------------------------------------------------------
# Animated geometry


def animate_phase(size, spp):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracerboy_tpu.core import vec3 as v3
    from tracerboy_tpu.trace.intersect import BIG, brute_force_closest_soa
    from tracerboy_tpu.trace.traverse import traverse_wide

    def twist(v):
        v = jnp.asarray(v)
        ang = 0.25 * v[:, 1:2]
        c, s = jnp.cos(ang), jnp.sin(ang)
        return jnp.concatenate([c * v[:, 0:1] + s * v[:, 2:3], v[:, 1:2],
                                -s * v[:, 0:1] + c * v[:, 2:3]], axis=1)

    def deform(r):
        c = r.compiled
        r.update_geometry(twist(c.tri_v0), twist(c.tri_v1), twist(c.tri_v2))

    holder = {}

    def keep(r):
        deform(r)
        holder["r"] = r

    img_j, rays_j = _render("shadertoy", size, "jnp", spp, keep)
    img_b, rays_b = _render("shadertoy", size, "brute", spp, deform)
    rel, mx = _image_diff(img_j, img_b)
    check(rel <= 1e-3, f"animated mean relative difference {rel}")

    # Traversal of the rebuilt tables against brute force over the
    # deformed triangles in compile order.
    r = holder["r"]
    sp, c = r.scene_pytree, r.compiled
    w0, w1, w2 = twist(c.tri_v0), twist(c.tri_v1), twist(c.tri_v2)
    tri9 = jnp.concatenate([w0, w1, w2], axis=1)
    o, d, _ = _scene_rays(sp, size[0], size[1], 1)
    big = jnp.full((o.shape[0],), BIG, jnp.float32)
    t_a, id_a = jax.jit(lambda o, d: traverse_wide(
        o, d, big, sp["bvh_lo"], sp["bvh_hi"], sp["bvh_children"],
        sp["tri_v0"], sp["tri_v1"], sp["tri_v2"], leaf_size=r.leaf_size)[:2]
    )(o, d)
    t_b, id_b, _, _ = jax.jit(lambda o, d: brute_force_closest_soa(
        v3.from_rows(o), v3.from_rows(d), tri9, big))(o, d)
    sp9 = sp["tri9"]
    rows_a = sp9[jnp.clip(id_a, 0, sp9.shape[0] - 1)]
    rows_b = tri9[jnp.clip(id_b, 0, tri9.shape[0] - 1)]
    agree = ((id_a < 0) & (id_b < 0)) | (
        (id_a >= 0) & (id_b >= 0) & jnp.all(rows_a == rows_b, axis=1))
    agree = float(jnp.mean(agree))
    mat_a = sp["tri_attr_rows"][jnp.clip(id_a, 0, sp9.shape[0] - 1), 15]
    mat_b = jnp.asarray(c.tri_material)[jnp.clip(id_b, 0, tri9.shape[0] - 1)]
    both = (id_a >= 0) & (id_b >= 0) & jnp.all(rows_a == rows_b, axis=1)
    mat_ok = bool(jnp.all(jnp.where(both, mat_a == mat_b, True)))
    check(agree >= 0.9999, f"animated hit triangles agree {agree}")
    check(mat_ok, "reordered attribute rows do not follow the triangles")
    return dict(rays=rays_j + rays_b,
                result=f"twisted shadertoy, {size[0]}x{size[1]}, {spp} spp: "
                       f"render mean relative difference {rel:.3g} (max abs "
                       f"{mx:.3g}); primary-ray hit triangles agree on "
                       f"{agree:.6%}; attribute rows follow the rebuild "
                       f"order; leaf size {r.leaf_size}",
                tolerance="render mean relative difference <= 1e-3; hit "
                          "triangles (by vertex rows) >= 99.99%")


# ---------------------------------------------------------------------------
# Four cards


def sharded_phase(size, cards):
    import dataclasses

    import numpy as np

    from tracerboy_tpu.renderer import Renderer
    from tracerboy_tpu.utils.config import default_output_settings

    s = default_output_settings()
    s = s.replace(performance_settings=dataclasses.replace(
        s.performance_settings, max_bounces=6))

    def img(shard, n):
        r = Renderer("shadertoy", settings=s, film_size=size, seed=3,
                     shard=shard, n_devices=cards if shard else None)
        r.render_sample(n)
        return np.asarray(r.resolve_radiance()), r.rays_traced

    one, rays1 = img(None, 1)
    tiles, rays_t = img("tiles", 1)
    d = np.abs(tiles - one)
    frac = float((d <= 1e-6).mean())
    check(np.isfinite(tiles).all(), "non-finite tiled image")
    check(frac == 1.0, f"tiles: {frac:.6%} of values within 1e-6 "
                       f"(max {d.max():.3g})")
    one4, rays4 = img(None, cards)
    spp, rays_s = img("spp", cards)
    ok = np.allclose(spp, one4, rtol=1e-5, atol=1e-6)
    rel = float(np.max(np.abs(spp - one4) / np.maximum(np.abs(one4), 1e-6)))
    check(ok, f"spp: max relative difference {rel:.3g}")
    return dict(rays=rays1 + rays_t + rays4 + rays_s,
                tiles=f"{size[0]}x{size[1]}, 1 spp over {cards} cards vs one "
                      f"card: {frac:.6%} of values within 1e-6 (max abs "
                      f"{d.max():.3g})",
                spp=f"{cards} spp, one per card, vs one card's {cards}-sample "
                    f"batch: max relative difference {rel:.3g}",
                tolerance="tiles: every value within 1e-6 absolute; spp: "
                          "within 1e-5 relative (+1e-6 absolute)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the sharded renders over four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    check(dev.platform == "gpu",
          f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})")
    check(len(devices) >= args.cards,
          f"{args.cards} cards asked for, {len(devices)} present")
    sys.path.insert(0, REPO)
    from tracerboy_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    card = card_name()
    ph = Phases(card)
    w, h = FULL
    common = ["--max-bounces", "6", "--seed", "1"]
    if args.cards == 4:
        ph.run("shard-4", sharded_phase, FULL, 4)
    else:
        ph.run("cli-unbiased", cli_phase,
               ["shadertoy", "--size", f"{w}x{h}", "--spp", "4"] + common,
               "shadertoy_4spp.png", FULL)
        ph.run("cli-realtime", cli_phase,
               ["shadertoy", "--size", f"{w}x{h}", "--mode", "realtime",
                "--frames", "30"] + common,
               "shadertoy_realtime.png", FULL)
        ph.run("cli-denoised", cli_phase,
               ["shadertoy", "--size", f"{w}x{h}", "--spp", "8",
                "--denoiser", "oidn"] + common,
               "shadertoy_8spp_oidn.png", FULL)
        cw, ch = CORNELL
        ph.run("cli-cornell", cli_phase,
               ["shadertoy:cornell", "--size", f"{cw}x{ch}", "--spp", "8"]
               + common, "cornell_8spp.png", CORNELL)
        ph.run("cli-cloud", cli_phase,
               ["shadertoy:cornell", "--size", f"{cw}x{ch}", "--spp", "8",
                "--volume", "cloud"] + common, "cornell_cloud_8spp.png",
               CORNELL)
        ph.run("traverse", traverse_phase, w, h)
        ph.run("render", render_phase, SMALL, 2)
        ph.run("lookup", lookup_phase, w * h)
        ph.run("unet", unet_phase, 1920, 1088)
        ph.run("animate", animate_phase, SMALL, 1)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report, then fail the run
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False,
                          "error": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
        sys.exit(1)
