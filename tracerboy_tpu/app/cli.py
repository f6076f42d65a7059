"""Command-line renderer: the headless analog of the reference app shell.

Replaces WinMain + D3D12App's interactive loop (WinMain/WinMain.cpp:193-247,
TracerBoy/D3D12App.cpp) with a CLI: progressive render to a sample/time
target with live progress reporting (the loading-screen/status analog,
UIController.cpp:124-140), PNG/EXR/HDR output (the 'P' capture key,
D3D12App.cpp:341-364), optional AOV dumps, denoiser selection, and
checkpoint/resume of the accumulation state.

Usage:
  python -m tracerboy_tpu.app.cli SCENE.pbrt --spp 64 --out out.png
  python -m tracerboy_tpu.app.cli SCENE.pbrt --mode realtime --frames 30
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(prog="tracerboy-tpu", description=__doc__)
    p.add_argument("scene", help=".pbrt scene file (or .npz compiled cache)")
    p.add_argument("--out", default="out.png", help="output image path")
    p.add_argument("--spp", type=int, default=None,
                   help="sample target (default: settings/sampler)")
    p.add_argument("--size", default=None, metavar="WxH",
                   help="override film resolution, e.g. 512x512")
    p.add_argument("--mode", choices=["unbiased", "realtime"],
                   default="unbiased")
    p.add_argument("--frames", type=int, default=30,
                   help="frames to run in realtime mode")
    p.add_argument("--max-bounces", type=int, default=None)
    p.add_argument("--tonemap", default=None,
                   choices=["reinhard", "aces", "clamp", "uncharted",
                            "pbr_neutral", "agx", "agx_punchy", "gt"])
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--env-nee", default="auto",
                   choices=["auto", "on", "off"],
                   help="environment NEE with MIS: auto = on when the "
                        "env dome is the scene's only light")
    p.add_argument("--sampler", default="pcg", choices=["pcg", "sobol"],
                   help="sample streams: pcg hash randoms (+blue noise,"
                        " the reference scheme) or padded Owen-scrambled"
                        " Sobol (lower variance at low spp)")
    p.add_argument("--ris", action="store_true",
                   help="enable reservoir (RIS) light sampling")
    p.add_argument("--transparent-shadows", action="store_true",
                   help="glass attenuates shadow rays by Fresnel "
                        "transmission instead of hard-occluding "
                        "(straight-line approximation)")
    p.add_argument("--no-auto-exposure", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--firefly-clamp", type=float, default=0.0)
    p.add_argument("--dof-focus", type=float, default=0.0)
    p.add_argument("--dof-aperture", type=float, default=0.01)
    p.add_argument("--time-limit", type=float, default=-1.0,
                   help="stop after N seconds")
    p.add_argument("--aov", default=None,
                   choices=["albedo", "normal", "depth", "luminance"],
                   help="write this AOV instead of the lit image")
    p.add_argument("--denoiser", default="none",
                   choices=["none", "oidn", "oidn-clip"],
                   help="ML denoise the final image with the committed "
                        "colour-only UNet (ml/weights/rt_ldr_ft.npz, the "
                        "fine-tuned rt_ldr of OpenImageDenoise.h:219). "
                        "oidn runs it on the invertible Reinhard "
                        "encoding; oidn-clip on clipped radiance")
    p.add_argument("--upscale", default=None, choices=["fsr"],
                   help="2x upscale the output (FSR-style EASU+RCAS)")
    p.add_argument("--volume", default=None,
                   help="attach a heterogeneous medium: .vdb (OpenVDB "
                        "FloatGrid), .vol (Mitsuba grid), .npy density, "
                        "or 'cloud' (procedural test cloud)")
    p.add_argument("--hdr-out", default=None,
                   help="also write linear radiance (.exr/.hdr/.pfm)")
    p.add_argument("--capture-every", type=int, default=0, metavar="N",
                   help="write a numbered PNG every N samples (the 'P'-key "
                        "recording of the reference)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to save/resume accumulation")
    p.add_argument("--checkpoint-every", type=int, default=64,
                   help="checkpoint every N samples")
    p.add_argument("--shard", default="none",
                   choices=["none", "tiles", "spp"],
                   help="multi-device scaling axis over all visible "
                        "devices: tiles = pixel pool split across the "
                        "mesh (zero-comm waves); spp = every device "
                        "traces different sample indices, accumulators "
                        "psum-merge across the mesh")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices for --shard (default: all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export-pbf", default=None, metavar="OUT.pbf",
                   help="serialize the parsed scene as a .pbf binary "
                        "(the reference's fast-load cache format) and exit")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv=None, stats: dict | None = None):
    """Run the CLI; returns the exit code. `stats`, when given, is
    filled with the run's counters: rays traced, samples or frames,
    and the renderer's wall seconds (scene load to final image)."""
    args = build_parser().parse_args(argv)

    if args.export_pbf:
        from tracerboy_tpu.scene.pbf import write_pbf
        from tracerboy_tpu.scene.pbrt_parser import parse_pbrt

        write_pbf(args.export_pbf, parse_pbrt(args.scene))
        print(f"wrote {args.export_pbf}")
        return 0

    from tracerboy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from tracerboy_tpu import Renderer
    from tracerboy_tpu.core import image_io
    from tracerboy_tpu.utils.config import (
        OutputType,
        RenderMode,
        TonemapType,
        default_output_settings,
    )

    film = None
    if args.size:
        w, h = args.size.lower().split("x")
        film = (int(w), int(h))

    s = default_output_settings()
    perf = s.performance_settings
    import dataclasses

    perf = dataclasses.replace(
        perf,
        enable_next_event_estimation=not args.no_nee,
        enable_sampling_importance_resampling=args.ris,
        environment_nee=args.env_nee,
        sampler=args.sampler,
        transparent_shadows=args.transparent_shadows,
        **({"max_bounces": args.max_bounces} if args.max_bounces else {}),
    )
    post = dataclasses.replace(
        s.post_settings,
        enable_auto_exposure=not args.no_auto_exposure,
        exposure_multiplier=args.exposure,
        **(
            {"tonemap_type": TonemapType[args.tonemap.upper()
                                         .replace("PBR_NEUTRAL",
                                                  "KHRONOS_PBR_NEUTRAL")]}
            if args.tonemap else {}
        ),
    )
    s = s.replace(
        performance_settings=perf,
        post_settings=post,
        render_mode=(RenderMode.REAL_TIME if args.mode == "realtime"
                     else RenderMode.UNBIASED),
        fireflies_clamp=args.firefly_clamp,
        debug_settings=dataclasses.replace(
            s.debug_settings, time_limit_seconds=args.time_limit
        ),
    )
    if args.aov:
        s = s.replace(output_type=OutputType[args.aov.upper()])
    if args.dof_focus > 0:
        s = s.replace(camera_settings=dataclasses.replace(
            s.camera_settings,
            dof_focus_distance=args.dof_focus,
            dof_aperture_width=args.dof_aperture,
        ))

    t0 = time.time()
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(f"[{time.time()-t0:7.1f}s]", *a, flush=True)
    )

    log(f"loading {args.scene} ...")
    vol = None
    if args.volume:
        from tracerboy_tpu.scene import volume as vmod

        vol = (vmod.procedural_cloud() if args.volume == "cloud"
               else vmod.load_volume(args.volume))
    shard = None if args.shard == "none" else args.shard
    r = Renderer(args.scene, settings=s, film_size=film, seed=args.seed,
                 volume=vol, shard=shard, n_devices=args.devices)
    log(f"scene ready: {r.compiled.num_tris} tris, "
        f"{r.compiled.num_lights} lights, {r.width}x{r.height}, "
        f"{len(r.compiled.materials['flags'])} materials")
    if shard:
        log(f"sharding: {shard} over {r.mesh.devices.size} devices")

    from tracerboy_tpu.utils.checkpoint import (
        load_render_checkpoint,
        save_render_checkpoint,
    )

    if args.checkpoint:
        if load_render_checkpoint(args.checkpoint, r):
            log(f"resumed from checkpoint at {r.state.spp} spp")

    if args.mode == "realtime":
        for f in range(args.frames):
            img = r.render_realtime_frame_fused(
                as_numpy=(f == args.frames - 1)
            )
            if f % 10 == 0:
                log(f"frame {f}")
        import numpy as _np

        img = _np.asarray(img)
    else:
        target = args.spp or r.compiled.sampler_spp
        batch = 4
        while r.state.spp < target:
            n = min(batch, target - r.state.spp)
            r.render_sample(n)
            log(f"{r.state.spp}/{target} spp  "
                f"convergence={r.convergence_error():.5f}")
            if args.checkpoint and r.state.spp % args.checkpoint_every == 0:
                save_render_checkpoint(args.checkpoint, r)
            if (args.capture_every
                    and r.state.spp % args.capture_every == 0):
                from tracerboy_tpu.core import image_io as _io

                base, ext = os.path.splitext(args.out)
                _io.write_png(f"{base}_{r.state.spp:05d}{ext or '.png'}",
                              r.current_image())
            if (args.time_limit > 0
                    and time.time() - t0 > args.time_limit):
                log("time limit reached")
                break
        img = r.current_image()
    if stats is not None:
        stats.update(
            rays_traced=r.rays_traced, spp=r.state.spp,
            frames=args.frames if args.mode == "realtime" else 0,
            seconds=time.time() - t0,
        )
    log(f"{r.rays_traced / 1e6:.1f} Mrays traced")

    import numpy as np
    import jax.numpy as jnp

    if args.denoiser != "none":
        from tracerboy_tpu.post.pipeline import display_transform

        transfer = "clip" if args.denoiser == "oidn-clip" else "reinhard"
        den_lin = r.denoise(transfer=transfer)
        ps = r.settings.post_settings
        img = np.asarray(display_transform(
            jnp.asarray(den_lin), ps.exposure_multiplier,
            int(ps.tonemap_type), ps.enable_gamma_correction,
            ps.enable_auto_exposure,
        ))
        log(f"denoised (OIDN UNet, {transfer} transfer)")

    if args.upscale == "fsr":
        from tracerboy_tpu.ml.fsr import fsr_upscale

        img = np.asarray(fsr_upscale(jnp.asarray(img)))
        log("upscaled 2x (FSR-style EASU+RCAS)")

    image_io.write_png(args.out, img)
    log(f"wrote {args.out}")

    if args.hdr_out:
        rad = np.asarray(r.resolve_radiance())
        ext = args.hdr_out.rsplit(".", 1)[-1].lower()
        if ext == "exr":
            image_io.write_exr(args.hdr_out, rad)
        elif ext == "pfm":
            image_io.write_pfm(args.hdr_out, rad)
        else:
            image_io.write_hdr(args.hdr_out, rad)
        log(f"wrote {args.hdr_out}")

    if args.checkpoint and args.mode != "realtime":
        save_render_checkpoint(args.checkpoint, r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
