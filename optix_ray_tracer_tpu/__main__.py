"""Application entry point — the ``main()`` analog (``src/Global/Main.cu``).

Usage:
    python -m optix_ray_tracer_tpu --config path/to/config.json \
        [--frames N] [--output DIR] [--spp N] [--width W --height H]

Dispatch mirrors Main.cu:12-47: parse config; ``"cache": true`` bakes the
mesh cache and exits; otherwise commit the Mesh- or Time-mode scene, run the
render loop, and write one PNG per frame (the headless replacement for the
SDL swapchain).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="optix_ray_tracer_tpu")
    ap.add_argument("--config", required=True,
                    help="config.json (reference-compatible schema)")
    ap.add_argument("--frames", type=int, default=None,
                    help="max frames to render (default: one series pass)")
    ap.add_argument("--output", default=None, help="output directory")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--loop", action="store_true",
                    help="cycle the animation like the interactive renderer")
    ap.add_argument("--viewer", action="store_true",
                    help="serve an interactive MJPEG viewer (SDL-window analog)")
    ap.add_argument("--port", type=int, default=8425, help="viewer port")
    ap.add_argument("--progressive", type=int, default=None, metavar="SPP",
                    help="progressively accumulate SPP on frame 0 with "
                         "checkpoint/resume")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path for --progressive (resumes if it "
                         "exists)")
    ap.add_argument("--adaptive", action="store_true",
                    help="with --progressive: variance-guided sample "
                         "allocation (each batch traces only the "
                         "highest-error quarter of the pixels after a "
                         "uniform warmup; 1.2-1.4x lower equal-budget "
                         "RMSE measured)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--shard", action="store_true",
                    help="tile-shard every animation frame over all "
                         "jax.devices() (multi-chip render loop)")
    ap.add_argument("--aov", action="store_true",
                    help="also write albedo/normal guide AOV images next "
                         "to each output frame (<name>_albedo.png / "
                         "<name>_normal.png)")
    ap.add_argument("--no-denoise", action="store_true",
                    help="bypass the per-frame denoiser (the reference's "
                         "Tab-key analog)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from optix_ray_tracer_tpu.io.config import ConfigError, load_config
    from optix_ray_tracer_tpu.utils.jitcache import enable_compilation_cache
    from optix_ray_tracer_tpu.utils.logging import LOG, configure

    # persistent jit cache (the reference's OptiX module/PTX cache analog):
    # the fused animation chunk costs tens of seconds of compile per cold
    # process
    enable_compilation_cache()

    configure(verbose=args.verbose)
    try:
        config = load_config(args.config)
    except ConfigError as e:
        LOG.error("config error: %s", e)
        return 2
    if args.no_denoise:
        config.denoise = False
    if config.debug_mode:
        # reference semantics: OptiX validation mode / VK validation layers
        # behind one flag (RendererImpl.cu:14, docs/configuration.md:43-49)
        from optix_ray_tracer_tpu.utils.debug import enable_debug_mode
        enable_debug_mode()

    if config.mesh and config.cache:
        # "cache": true bakes and exits (Main.cu:23-25)
        from optix_ray_tracer_tpu.models import renderer_mesh
        meta = renderer_mesh.write_cache_files(config)
        LOG.info("cache bake complete: %s", meta)
        return 0

    out_dir = args.output or config.resolve(config.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    if config.mesh:
        from optix_ray_tracer_tpu.models import renderer_mesh as frontend
    else:
        from optix_ray_tracer_tpu.models import renderer_time as frontend

    t0 = time.time()
    data = frontend.commit(config)
    LOG.info("scene committed in %.1fs", time.time() - t0)

    if args.viewer:
        return _run_viewer(frontend, data, config, args, out_dir)
    if args.progressive:
        return _run_progressive(frontend, data, config, args, out_dir)

    n = 0
    # quantize=True: frames leave the device as sRGB uint8 (4 B/pixel,
    # the reference's float4->uchar4 conversion, RendererImpl.cu:672-678)
    # — the PNG writer needs nothing more
    aov = args.aov
    if args.shard and aov:
        LOG.warning("--aov is not supported with --shard; ignoring")
        aov = False
    if args.shard:
        import jax

        from optix_ray_tracer_tpu.parallel.animation import (
            render_frames_sharded,
        )
        from optix_ray_tracer_tpu.parallel.sharding import make_mesh

        mesh = make_mesh(tile=len(jax.devices()))
        LOG.info("sharding frames over %d device(s)", len(jax.devices()))
        ld = config.loop_data
        frames = render_frames_sharded(
            data, "mesh" if config.mesh else "time",
            args.width or ld.window_width, args.height or ld.window_height,
            args.spp or config.spp, mesh, max_frames=args.frames,
            loop=args.loop, quantize=True)
    else:
        # --aov needs the guide channels on host, which the quantized
        # uint8 fast path does not carry: fall back to float Films with
        # fetch_guides (slower fetch, documented in PERF.md)
        frames = frontend.render_frames(
            data, width=args.width, height=args.height, spp=args.spp,
            max_frames=args.frames, loop=args.loop, quantize=not aov,
            fetch_guides=aov)
    for fi, k, film in frames:
        stem = f"frame_{n:06d}"
        path = os.path.join(out_dir, stem + ".png")
        film.save(path)
        if aov:
            film.save_aovs(os.path.join(out_dir, stem))
        LOG.info("file %d frame %d -> %s (spp=%d)", fi, k, path, int(film.spp))
        n += 1
    LOG.info("render finished: %d frames in %.1fs", n, time.time() - t0)
    return 0


def _run_viewer(frontend, data, config, args, out_dir) -> int:
    """Interactive mode: live fly camera + animation stepping + denoiser
    toggle (the SDL window loop analog, SDL_GraphicsWindow.cu:79-214).

    Dispatch amortization: the viewer renders through ``fused_chunk`` —
    refit + render + denoise + sRGB/uint8 quantization for K look-ahead
    frames in ONE device dispatch while the camera is idle, dropping to
    K=1 under input.  Frames leave the device already quantized
    (4 B/pixel)."""
    from optix_ray_tracer_tpu.models import common
    from optix_ray_tracer_tpu.render.viewer import ViewerServer
    from optix_ray_tracer_tpu.utils.color import color_to_uint8
    from optix_ray_tracer_tpu.utils.debug import DEBUG_MODE
    from optix_ray_tracer_tpu.utils.logging import LOG
    import numpy as np

    ld = config.loop_data
    width = args.width or min(ld.window_width, 400)
    height = args.height or min(ld.window_height, 300)

    # animation schedule: (file, frame, frame_count) per viewer frame, cycled
    schedule = []
    for fi in range(data.file_count):
        n_frames = common.frame_count_for_file(
            data.durations[fi], ld.fps, ld.render_speed_ratio)
        schedule.extend((fi, k, n_frames) for k in range(n_frames))

    state = {"step": 0, "intersector": None, "key": None, "lights": None,
             "fd": None, "rstate": None, "prev_camera": None, "vframe": 0}

    if config.integrator.startswith("restir"):
        # interactive ReSTIR: reservoirs PERSIST across viewer frames, so
        # every frame after the first resamples against the full temporal
        # history — the fly camera is handled by prev-frame reprojection
        # and animation steps by the depth/normal reuse rejection (no
        # reset needed).  This is the regime ReSTIR was designed for
        # (Bitterli 2020 targets interactive many-light rendering).
        import jax

        from optix_ray_tracer_tpu.render import restir as restir_mod

        gi_kw = ({"max_depth": config.max_depth}
                 if config.integrator == "restir-gi" else {})
        restir_render = (restir_mod.render_restir_gi
                         if config.integrator == "restir-gi"
                         else restir_mod.render_restir)
        restir_step = jax.jit(
            lambda scene, mats, lights, cam, prev_cam, st, f, inter, env,
            tex: restir_render(
                scene, mats, lights, cam, width, height,
                seed=config.seed, frame=f, state=st, prev_camera=prev_cam,
                intersector=inter, background=config.background, env=env,
                textures=tex, sampler=getattr(config, "sampler", "pcg"),
                **gi_kw))

    def render_fn(camera, denoise_on=True, animate=False,
                  filter_name=None):
        fi, k, n_frames = schedule[state["step"] % len(schedule)]
        if animate:
            state["step"] += 1
        scene = frontend.frame_scene(data, fi, k, n_frames)
        if state["key"] != fi:
            state["intersector"] = common.choose_intersector(scene)
            state["key"] = fi
        else:
            state["intersector"] = common.refit_or_choose(
                state["intersector"], scene)
        if state["lights"] is None:
            state["lights"] = common.collect_lights(config, scene,
                                                    data.materials)
        if config.integrator.startswith("restir"):
            if state["rstate"] is None:
                state["rstate"] = restir_mod.empty_reservoir_state(
                    width, height)
            img, alb, nrm, state["rstate"] = restir_step(
                scene, data.materials, state["lights"], camera,
                state["prev_camera"] or camera, state["rstate"],
                state["vframe"], state["intersector"], data.env,
                data.textures)
            state["prev_camera"] = camera
            state["vframe"] += 1
            img = common.apply_denoiser(
                img, alb, nrm, config,
                denoise_override=denoise_on and config.denoise,
                denoiser_override=filter_name)
        else:
            img, _, _ = common.render_frame(
                config, scene, data.materials, camera, width, height,
                spp=args.spp or 1, seed=config.seed,
                intersector=state["intersector"], env=data.env,
                textures=data.textures, lights=state["lights"],
                denoise_override=denoise_on and config.denoise,
                denoiser_override=filter_name)
        return np.asarray(color_to_uint8(img))

    render_chunk_fn = None
    if data.file_count and not DEBUG_MODE and data.update_fn is None and \
            schedule and not config.integrator.startswith("restir"):
        import jax.numpy as jnp

        from optix_ray_tracer_tpu.models import fused

        mode = "mesh" if config.mesh else "time"
        file_data_fn = (fused.mesh_file_data if config.mesh
                        else fused.time_file_data)
        bg = jnp.asarray(config.background, jnp.float32)

        from optix_ray_tracer_tpu.utils.color import color_to_uint8 as _q

        def _chunk(camera, ks, seeds, denoise_on, quantize,
                   temporal=False, filter_name=None):
            out = fused.fused_chunk(
                state["fd"], jnp.asarray(ks, jnp.float32),
                jnp.asarray(seeds, jnp.int32), state["intersector"],
                data.materials, camera, data.extra_spheres,
                data.extra_triangles, data.env, data.textures,
                state["lights"], bg,
                state.get("tstate") if temporal else None,
                mode=mode, width=width, height=height,
                spp=args.spp or 1, integrator=config.integrator,
                do_denoise=bool(denoise_on and config.denoise),
                denoiser=_resolve_filter(filter_name),
                sampler=getattr(config, "sampler", "pcg"),
                max_depth=config.max_depth,
                has_extras=bool(data.extra_triangles.count),
                euler_path=getattr(data, "reference_euler_path", False),
                quantize=quantize, want_guides=False, temporal=temporal)
            if temporal:
                out, state["tstate"] = out
            return out

        def _resolve_filter(name):
            """Viewer /filter override; None = config default.  Degrades
            to a-trous when the neural weights asset is absent."""
            if name is None:
                return common.resolve_denoiser(config)
            import types
            return common.resolve_denoiser(
                types.SimpleNamespace(denoiser=name))

        still = {"cam": None, "acc": None, "spp": 0}

        def render_chunk_fn(camera, chunk, denoise_on, animate,
                            filter_name=None):
            fi, k, n_frames = schedule[state["step"] % len(schedule)]
            if state["key"] != fi or state["fd"] is None:
                scene0 = frontend.frame_scene(data, fi, 0, n_frames)
                state["intersector"] = common.rebuild_or_choose(
                    state["intersector"], scene0)
                state["key"] = fi
                state["fd"] = file_data_fn(data, fi, n_frames)
                if state["lights"] is None:
                    state["lights"] = common.collect_lights(
                        config, scene0, data.materials)
            cam_key = tuple(np.asarray(camera.center).tolist()) + \
                tuple(np.asarray(camera.w).tolist())
            if not animate and still["cam"] == cam_key:
                # idle + still camera: PROGRESSIVE refinement — each
                # dispatch adds `chunk` raw samples to a host accumulator
                # (something the reference's 1-spp loop cannot do); the
                # stream shows the converging mean, denoiser bypassed
                # once real sample counts beat it
                seeds = config.seed + still["spp"] + np.arange(chunk)
                out = _chunk(camera, [k] * chunk, seeds, False,
                             quantize=False)
                imgs = np.asarray(out[0], np.float32)    # (K, H, W, 3)
                if still["acc"] is None:
                    still["acc"] = imgs.sum(0)
                else:
                    still["acc"] += imgs.sum(0)
                still["spp"] += chunk
                mean = jnp.asarray(still["acc"] / still["spp"])
                return np.asarray(_q(mean))[None]
            moved = still["cam"] != cam_key
            still["cam"] = cam_key
            still["acc"] = None
            still["spp"] = 0
            # temporal reprojection is valid only while the camera holds
            # still (history is projected through the CURRENT camera)
            use_temporal = (bool(getattr(config, "temporal", True))
                            and config.integrator != "path"
                            and not moved)
            if moved or state.get("tstate") is None:
                from optix_ray_tracer_tpu.render import temporal as tmod
                state["tstate"] = tmod.empty_state(width, height)
            if animate:
                # look-ahead stays inside this file (one compiled shape);
                # wraps at the file end, the next call moves to file+1
                ks = [(k + j) % n_frames for j in range(chunk)]
                state["step"] += chunk
                seeds = config.seed + np.asarray(ks, np.int32)
            else:
                ks = [k] * chunk     # newly-still camera: 1 chunk of
                seeds = config.seed + np.arange(chunk, dtype=np.int32)
            out = _chunk(camera, ks, seeds, denoise_on, quantize=True,
                         temporal=use_temporal, filter_name=filter_name)
            return np.asarray(out[0])

    LOG.info("interactive viewer: %dx%d%s", width, height,
             " (chunked dispatch)" if render_chunk_fn else "")
    ViewerServer(data.camera, render_fn, port=args.port,
                 move_speed=ld.camera_speed_stride
                 * ld.camera_initial_speed_ratio * 25,
                 mouse_sensitivity=ld.mouse_sensitivity,
                 pitch_limit_degree=ld.camera_pitch_limit_degree,
                 render_chunk_fn=render_chunk_fn,
                 ).serve(blocking=True)
    return 0


def _run_progressive(frontend, data, config, args, out_dir) -> int:
    """Progressive accumulation on frame 0 with checkpoint/resume."""
    import numpy as np

    from optix_ray_tracer_tpu.models import common
    from optix_ray_tracer_tpu.render.film import Film
    from optix_ray_tracer_tpu.utils.logging import LOG

    ld = config.loop_data
    width = args.width or ld.window_width
    height = args.height or ld.window_height
    target_spp = args.progressive
    ckpt = args.checkpoint or os.path.join(out_dir, "progressive.npz")

    scene = frontend.frame_scene(data, 0, 0, 1)
    intersector = common.choose_intersector(scene)
    lights = common.collect_lights(config, scene, data.materials)

    if args.adaptive:
        return _run_progressive_adaptive(
            config, scene, data, intersector, lights, width, height,
            target_spp, ckpt, out_dir, aov=args.aov)

    if os.path.exists(ckpt):
        film = Film.restore(ckpt)
        LOG.info("resumed checkpoint %s at %d spp", ckpt, int(film.spp))
    else:
        film = Film.create(width, height)

    while int(film.spp) < target_spp:
        # sample_offset = accumulated spp => bit-exact continuation after
        # resume: one GLOBAL sample counter under a fixed seed, so jitter
        # strata and (sampler "sobol") QMC sequences keep accumulating
        # instead of restarting per batch.  Batches accumulate RAW
        # radiance; denoising (non-linear) happens once at save.
        done = int(film.spp)
        batch = max(1, min(16, target_spp - done))
        img, alb, nrm = common.render_frame(
            config, scene, data.materials, data.camera, width, height,
            spp=batch, seed=config.seed, intersector=intersector,
            env=data.env, textures=data.textures, lights=lights,
            denoise_override=False, sample_offset=done)
        film = film.add(img, alb, nrm, batch)
        film.checkpoint(ckpt, meta={"seed": config.seed, "target": target_spp})
        LOG.info("progressive: %d/%d spp", int(film.spp), target_spp)

    out = os.path.join(out_dir, "progressive.png")
    if config.denoise:
        from optix_ray_tracer_tpu.render.denoise import denoise
        from optix_ray_tracer_tpu.utils.color import color_to_uint8, write_png
        inv = 1.0 / max(int(film.spp), 1)
        img = denoise(film.mean(), film.albedo_accum * inv,
                      film.normal_accum * inv)
        write_png(out, np.asarray(color_to_uint8(img)))
    else:
        film.save(out)
    if args.aov:
        film.save_aovs(os.path.join(out_dir, "progressive"))
    LOG.info("progressive render done -> %s", out)
    return 0


def _run_progressive_adaptive(config, scene, data, intersector, lights,
                              width, height, target_spp, ckpt,
                              out_dir, aov: bool = False) -> int:
    """``--progressive N --adaptive``: same total ray budget as the
    uniform loop (N * npix samples), allocated by per-pixel variance
    (render/adaptive.py; measured 1.2-1.4x lower equal-budget RMSE on
    subject-plus-background scenes)."""
    import numpy as np

    from optix_ray_tracer_tpu.render.adaptive import (
        AdaptiveFilm, adaptive_batch,
    )
    from optix_ray_tracer_tpu.utils.logging import LOG

    npix = width * height
    if config.integrator.startswith("restir"):
        # adaptive traces arbitrary pixel SUBSETS; restir's spatial reuse
        # needs full image-structured frames — refuse loudly
        raise SystemExit(
            "--adaptive supports integrator 'whitted' or 'path'; "
            f"'{config.integrator}' renders full frames (drop --adaptive)")
    integrator = "path" if config.integrator == "path" else "whitted"
    kw = dict(seed=config.seed, background=config.background,
              max_depth=config.max_depth, intersector=intersector,
              env=data.env, textures=data.textures,
              sampler=getattr(config, "sampler", "pcg"),
              integrator=integrator)

    if os.path.exists(ckpt):
        try:
            film = AdaptiveFilm.restore(ckpt)
        except KeyError:
            LOG.error("checkpoint %s is a uniform-progressive film; "
                      "--adaptive cannot resume it (delete it or drop "
                      "--adaptive)", ckpt)
            return 2
        if (film.width, film.height) != (width, height):
            LOG.error("checkpoint %s is %dx%d, requested %dx%d", ckpt,
                      film.width, film.height, width, height)
            return 2
        LOG.info("resumed adaptive checkpoint %s at %d total samples",
                 ckpt, film.total_samples)
    else:
        film = AdaptiveFilm.create(width, height)

    budget = target_spp * npix
    warmup = min(4, target_spp) * npix
    k_batch = max(1, npix // 4)
    while film.total_samples < budget:
        done = film.total_samples
        k = npix if done < warmup else min(k_batch, budget - done)
        film = adaptive_batch(scene, data.materials, lights, data.camera,
                              film, k=k, **kw)
        film.checkpoint(ckpt, meta={"seed": config.seed,
                                    "target": target_spp})
        LOG.info("adaptive progressive: %d/%d samples (%.1f avg spp)",
                 film.total_samples, budget, film.total_samples / npix)

    out = os.path.join(out_dir, "progressive.png")
    if config.denoise:
        from optix_ray_tracer_tpu.render.denoise import denoise
        from optix_ray_tracer_tpu.utils.color import color_to_uint8, write_png
        alb, nrm = film.guide_means()
        img = denoise(film.mean(), alb, nrm)
        write_png(out, np.asarray(color_to_uint8(img)))
    else:
        film.save(out)
    if aov:
        from optix_ray_tracer_tpu.render.film import save_aov_images
        g_alb, g_nrm = film.guide_means()
        save_aov_images(os.path.join(out_dir, "progressive"), g_alb, g_nrm)
    LOG.info("adaptive progressive render done -> %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
