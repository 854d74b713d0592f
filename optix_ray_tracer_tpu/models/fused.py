"""Fused animation segments — refit + render + denoise for a CHUNK of
frames in ONE XLA dispatch.

A per-frame loop pays a dispatch and a host sync several times per frame
(transform, refit, render, denoise, fetch).  The reference instead keeps
its whole hot loop on one CUDA stream (RendererMesh.cu:315-454).  The
equivalent here is to put the per-frame work inside a ``lax.scan`` over
the frame index: instance transforms, BVH refit (the updateIAS analog,
RendererImpl.cu:210-242), the integrator, and the
denoiser (RendererImpl.cu:680-734) all trace into one program; frames
leave the device as one stacked fetch per chunk.

Both frontends route through ``fused_chunk`` whenever no host-side
per-frame hook is installed (``update_fn``) and debug-mode validation is
off; otherwise they fall back to the per-frame path.

With a ``mesh`` the SAME chunk scan runs tile/sample-sharded over all
devices (one shard_map around the scan) — the distributed animation loop
the single-GPU reference never had (docs/technical-details.md:325-328).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.scene.geometry import Scene, Triangles

# target device bytes for one chunk's stacked output buffers
_CHUNK_BYTES = 192 * 1024 * 1024


def chunk_size(width: int, height: int, n_frames: int,
               bytes_per_pixel: int = 36) -> int:
    """Frames per fused dispatch: the largest DIVISOR of ``n_frames``
    within the memory cap (``bytes_per_pixel`` of stacked output per
    frame: 36 = 3 float32 RGB buffers, 4 = one quantized uint8 RGBA).

    Divisors keep every chunk of a file the same shape — a shrinking
    tail chunk would trigger a second multi-minute XLA compile of the
    whole fused scan, and a clamped (padded) tail would re-render frames
    at ~100x the cost of the dispatch overhead fusion saves."""
    per_frame = width * height * bytes_per_pixel
    cap = max(1, min(16, _CHUNK_BYTES // max(per_frame, 1)))
    best = 1
    for c in range(1, cap + 1):
        if n_frames % c == 0:
            best = c
    return best


def _mesh_scene(fd, k, extra_spheres, extra_triangles, has_extras: bool):
    from optix_ray_tracer_tpu.models.renderer_mesh import _frame_world

    shift_scale = fd["duration"] * k * fd["inv_frame_count"]
    world_v, normals, mat = _frame_world(
        fd["vertices"], fd["normals"], fd["tri_particle"], fd["tri_valid"],
        fd["velocities"], fd["particle_mat"], shift_scale,
        fd["particle_shift"], fd["particle_scale"])
    tris = Triangles(world_v, normals, mat)
    if has_extras:
        tris = tris.concat(extra_triangles)
    return Scene(spheres=extra_spheres, triangles=tris)


def _time_scene(fd, k, extra_spheres, extra_triangles, has_extras: bool,
                euler_path: bool):
    from optix_ray_tracer_tpu.models.renderer_time import _frame_triangles

    v, n, mat = _frame_triangles(
        fd["lib_vertices"], fd["lib_normals"],
        fd["tri_lib_idx"], fd["tri_inst"], fd["tri_ok"],
        fd["positions"], fd["quats"], fd["quats_next"],
        fd["velocities"], fd["particle_mat"],
        fd["duration"], k, fd["inv_frames_minus1"], fd["inv_frame_count"],
        fd["particle_shift"], fd["particle_scale"],
        euler_path=euler_path)
    tris = Triangles(v, n, mat)
    if has_extras:
        tris = tris.concat(extra_triangles)
    return Scene(spheres=extra_spheres, triangles=tris)


@partial(jax.jit, static_argnames=(
    "mode", "width", "height", "spp", "integrator", "do_denoise",
    "denoiser", "sampler", "max_depth", "has_extras",
    "euler_path", "quantize", "want_guides", "temporal", "mesh"))
def fused_chunk(fd, ks, seeds, base_inter, materials, camera,
                extra_spheres, extra_triangles, env, textures, lights,
                background, tstate=None, *, mode: str, width: int,
                height: int,
                spp: int, integrator: str, do_denoise: bool,
                denoiser: str = "atrous", sampler: str = "pcg",
                max_depth: int, has_extras: bool,
                euler_path: bool = False, quantize: bool = False,
                want_guides: bool = True, temporal: bool = False,
                mesh=None):
    """Render frames ``ks`` (float32 frame indices) of one animation file
    in a single dispatch.

    Returns a tuple of stacked outputs: the image stack — (len(ks), H, W,
    3) float32 linear, or with ``quantize`` (len(ks), H, W, 4) sRGB uint8
    quantized ON DEVICE (the reference's float4->uchar4 kernel,
    RendererImpl.cu:672-678) — followed, when ``want_guides``, by the
    (len(ks), H, W, 3) albedo and normal guide stacks.  Dropping the
    guides (the animation default: the in-loop denoiser consumes them on
    device) keeps them out of the chunk's output memory budget entirely.

    ``fd`` is the per-file data dict (equal shapes across files, so one
    compile serves the whole series).

    ``temporal`` (camera must be constant over the chunk): SVGF temporal
    reprojection across frames using the exactly-known per-instance rigid
    motion — ``tstate`` is the carried history (render/temporal.py
    ``empty_state``), and the return becomes ``(outs, final_tstate)`` so
    history flows across chunks and files.  Works with both integrators:
    radiance is demodulated by the first-hit albedo guide before the
    blend (for the path integrator this folds NEE direct light into the
    blended irradiance, the standard SVGF treatment).

    ``mesh`` (a ``jax.sharding.Mesh`` with ``tile``/``sample`` axes):
    run the SAME chunk scan once across all mesh devices via shard_map —
    each device traces its row band (RNG keys off GLOBAL pixel ids, so
    output matches the single-device scan), partial sample sums merge
    with a ``psum`` over the sample axis, and the bands ``all_gather``
    over tile before the (cheap, replicated) temporal / denoise /
    quantize stages, which need full frames."""
    from optix_ray_tracer_tpu.ops import gpu_traverse
    from optix_ray_tracer_tpu.render import pathtracer, wavefront

    if integrator not in ("whitted", "path"):
        # restir renders per-frame (frontends route it there); anything
        # else reaching the fused scan is a wiring bug — fail loudly
        # instead of silently rendering whitted
        raise ValueError(f"fused_chunk supports whitted|path, "
                         f"got integrator={integrator!r}")

    if mesh is not None:
        n_tile = mesh.shape["tile"]
        n_sample = mesh.shape["sample"]
        if height % n_tile != 0:
            raise ValueError(
                f"height {height} not divisible by tile={n_tile}")
        if spp % n_sample != 0:
            raise ValueError(
                f"spp {spp} not divisible by sample={n_sample}")
        rows_per = height // n_tile
        spp_per = spp // n_sample

    # everything below is parameterized by chunk_impl's OWN arguments
    # (shard_map rebinds them to shard-local values on the sharded path;
    # no closure capture of traced operands)
    def chunk_impl(fd, ks, seeds, base_inter, materials, camera,
                   extra_spheres, extra_triangles, env, textures, lights,
                   background, tstate, *, banded: bool = False):

        def build_scene(k):
            if mode == "mesh":
                return _mesh_scene(fd, k, extra_spheres, extra_triangles,
                                   has_extras)
            return _time_scene(fd, k, extra_spheres, extra_triangles,
                               has_extras, euler_path)

        def postprocess(carry, k, img, alb, nrm, aux):
            """Full-frame tail: temporal blend, denoise, quantize."""
            if temporal:
                from optix_ray_tracer_tpu.render import temporal as tmod
                from optix_ray_tracer_tpu.utils.vecmath import (
                    INF, normalize,
                )

                t_g, prim_g = aux
                # hit world points via pixel-center rays (sub-pixel jitter
                # mismatch is far inside the validity tolerances)
                o_c, d_c = camera.generate_rays(width, height)
                hit_ok = (t_g < INF)[..., None]
                x = jnp.where(hit_ok, o_c + t_g[..., None] * d_c,
                              o_c + d_c)
                if mode == "mesh":
                    from optix_ray_tracer_tpu.models.renderer_mesh import (
                        prev_world_points,
                    )
                    x_prev = prev_world_points(fd, k, x, prim_g)
                else:
                    from optix_ray_tracer_tpu.models.renderer_time import (
                        prev_world_points,
                    )
                    x_prev = prev_world_points(fd, k, x, prim_g,
                                               euler_path=euler_path)
                px, py, in_front = tmod.project_to_pixels(
                    camera, x_prev, width, height)
                prev_t = jnp.linalg.norm(x_prev - camera.center, axis=-1)
                safe_alb = jnp.maximum(alb, 1e-3)
                nrm_u = normalize(nrm)
                blended, carry = tmod.temporal_blend(
                    carry, img / safe_alb, t_g, nrm_u, px, py, prev_t,
                    in_front)
                if do_denoise and denoiser == "neural":
                    from optix_ray_tracer_tpu.render import neural_denoise
                    # learned spatial filter faded out as history
                    # converges (the a-trous branch gets the same effect
                    # through its history-adaptive sigma).  Rescale to
                    # the neural demod convention (miss pixels filter
                    # raw radiance — neural_denoise.demod_albedo)
                    alb_n = neural_denoise.demod_albedo(alb)
                    irr_n = blended * (safe_alb / alb_n)
                    params = neural_denoise.default_params()
                    filt = neural_denoise.apply(params, irr_n, alb,
                                                normalize(nrm))
                    # hist is (H, W, 1) — broadcasts over color directly
                    w = 1.0 / jnp.sqrt(jnp.maximum(carry["hist"], 1.0))
                    img = (w * filt + (1.0 - w) * irr_n) * alb_n
                elif do_denoise:
                    from optix_ray_tracer_tpu.render.denoise import (
                        filter_irradiance,
                    )
                    # history-adaptive edge-stopping: converged pixels
                    # filter tighter (see filter_irradiance docstring)
                    sig = 1.0 / jnp.sqrt(jnp.maximum(carry["hist"], 1.0))
                    img = filter_irradiance(blended, nrm,
                                            sigma_color=sig) * safe_alb
                else:
                    img = blended * safe_alb
            elif do_denoise and denoiser == "neural":
                from optix_ray_tracer_tpu.render import neural_denoise
                img = neural_denoise.denoise_neural.__wrapped__(
                    img, alb, nrm, neural_denoise.default_params())
            elif do_denoise:
                from optix_ray_tracer_tpu.render.denoise import denoise
                img = denoise.__wrapped__(img, alb, nrm)
            if quantize:
                from optix_ray_tracer_tpu.utils.color import color_to_uint8
                img = color_to_uint8(img)
            return carry, (img, alb, nrm) if want_guides else (img,)

        def render_full(scene, inter, seed):
            # NOTE: call the UNJITTED implementations (__wrapped__):
            # first-tracing a public jitted entry inside this scan poisons
            # its top-level dispatch cache on this jax version ("Execution
            # supplied 18 buffers but compiled program expected 20")
            if integrator == "path":
                out = pathtracer.render_path.__wrapped__(
                    scene, materials, lights, camera, width=width,
                    height=height, spp=spp, seed=seed,
                    background=background, max_depth=max_depth,
                    intersector=inter, env=env, textures=textures,
                    want_aux=temporal, sampler=sampler)
            else:
                out = wavefront.render.__wrapped__(
                    scene, materials, camera, width, height, spp=spp,
                    seed=seed, background=background, max_depth=max_depth,
                    intersector=inter, env=env, want_aux=temporal,
                    sampler=sampler)
            if temporal:
                return out
            return out + (None,)

        def render_band(scene, inter, seed):
            """Trace this device's row band, then psum samples +
            all_gather tiles into replicated full frames for the
            postprocess tail."""
            from optix_ray_tracer_tpu.parallel.sharding import _tile_rays
            from optix_ray_tracer_tpu.utils.vecmath import INF

            tile_idx = jax.lax.axis_index("tile")
            sample_idx = jax.lax.axis_index("sample")
            spp_offset = sample_idx * spp_per
            npix = rows_per * width
            # GLOBAL pixel ids (bands are contiguous rows) -> the same
            # RNG streams as the single-device render
            pixel_id = (tile_idx * npix
                        + jnp.arange(npix, dtype=jnp.int32))
            background_a = jnp.asarray(background, jnp.float32)
            want_aux = temporal

            def sample_step(acc, s_local):
                o, d = _tile_rays(camera, width, height, rows_per,
                                  tile_idx, spp_offset, s_local, pixel_id,
                                  seed, True)
                if integrator == "path":
                    out = pathtracer.trace_path.__wrapped__(
                        scene, materials, lights, o, d, pixel_id,
                        spp_offset + s_local, seed, background_a,
                        max_depth, inter, env, textures,
                        want_aux=want_aux, sampler=sampler)
                else:
                    out = wavefront.trace.__wrapped__(
                        scene, materials, o, d, pixel_id,
                        spp_offset + s_local, seed, background_a,
                        max_depth, inter, env, want_aux=want_aux,
                        sampler=sampler)
                new = (acc[0] + out[0], acc[1] + out[1], acc[2] + out[2])
                if want_aux:
                    # depth/prim taps come from GLOBAL sample 0 only
                    t_b, prim_b = out[3]
                    first = (spp_offset + s_local) == 0
                    new += (jnp.where(first, t_b, acc[3]),
                            jnp.where(first, prim_b, acc[4]))
                return new, None

            z = jnp.zeros((npix, 3), jnp.float32)
            init = (z, z, z)
            if want_aux:
                init += (jnp.full((npix,), INF, jnp.float32),
                         jnp.full((npix,), -1, jnp.int32))
            acc, _ = jax.lax.scan(sample_step, init,
                                  jnp.arange(spp_per, dtype=jnp.int32))

            def full(band):  # (npix, ...) band -> replicated full frame
                band = band.reshape((rows_per, width) + band.shape[1:])
                return jax.lax.all_gather(band, "tile", axis=0,
                                          tiled=True)

            img, alb, nrm = (
                full(jax.lax.psum(a, "sample") / spp) for a in acc[:3])
            aux = None
            if want_aux:
                # only the sample-0 shard holds real taps; the others
                # carry masked zeros, so a psum reconstructs them
                t_f = full(jax.lax.psum(
                    jnp.where(sample_idx == 0, acc[3], 0.0), "sample"))
                p_f = full(jax.lax.psum(
                    jnp.where(sample_idx == 0, acc[4], 0), "sample"))
                aux = (t_f, p_f)
            return img, alb, nrm, aux

        render_frame = render_band if banded else render_full

        def step(carry, xs):
            k, seed = xs
            scene = build_scene(k)
            # the updateIAS-refit analog, on device, inside the scan
            # (None = brute force, for scenes below the BVH threshold)
            inter = (gpu_traverse.refit(base_inter, scene)
                     if base_inter is not None else None)
            img, alb, nrm, aux = render_frame(scene, inter, seed)
            return postprocess(carry, k, img, alb, nrm, aux)

        if temporal:
            from optix_ray_tracer_tpu.render import temporal as tmod

            init = tstate if tstate is not None \
                else tmod.empty_state(width, height)
            final, out = jax.lax.scan(step, init, (ks, seeds))
            return out, final
        _, out = jax.lax.scan(step, None, (ks, seeds))
        return out

    if mesh is None:
        return chunk_impl(fd, ks, seeds, base_inter, materials, camera,
                          extra_spheres, extra_triangles, env, textures,
                          lights, background, tstate)

    # ---- sharded chunk scan: ONE shard_map around the whole scan ----
    # inputs replicated; every output is replicated too (bands gather
    # before the full-frame tail), so one P() prefix covers all leaves.
    # check_vma off for the same reason as parallel/sharding.py: the
    # variance checker demands pvary annotations inside the device-local
    # integrators; equality across mesh shapes is covered by
    # tests/test_sharding.py instead.
    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(partial(chunk_impl, banded=True), mesh=mesh,
                       in_specs=(P(),) * 13, out_specs=P(),
                       check_vma=False)
    return fn(fd, ks, seeds, base_inter, materials, camera, extra_spheres,
              extra_triangles, env, textures, lights, background, tstate)


def render_frames_fused(data, mode: str, file_data_fn, width: int,
                        height: int, spp: int, max_frames, loop: bool,
                        fetch_guides: bool = False,
                        quantize: bool = False, mesh=None):
    """Shared fused render loop for both frontends: yields
    (file_index, frame_index, Film) — or (…, U8Frame) with ``quantize``.

    ``file_data_fn(data, fi, n_frames) -> fd dict`` supplies the per-file
    arrays consumed by the scene builders above.

    ``mesh``: tile/sample-shard every chunk over a device mesh
    (``fused_chunk``'s sharded path); the render height pads up to a
    tile multiple and crops on output.

    Transfer policy: chunks are software-pipelined
    (chunk k+1 is dispatched before chunk k is fetched, overlapping
    device compute with the host transfer); with ``quantize`` frames are
    sRGB-quantized to uint8 ON DEVICE and fetched at 4 B/pixel; and the
    albedo/normal guide buffers are only computed as chunk outputs and
    fetched when ``fetch_guides`` is set — the in-loop denoiser already
    consumed them ON DEVICE (fused_chunk).  Without ``fetch_guides`` the
    yielded Films carry ZERO guide channels (documented API contract;
    the per-frame fallback in the frontends always carries real guides).
    """
    import numpy as np

    from optix_ray_tracer_tpu.models import common
    from optix_ray_tracer_tpu.render.film import Film, U8Frame

    if quantize and fetch_guides:
        raise ValueError("quantize yields U8Frames, which carry no guide "
                         "channels — use fetch_guides with quantize=False")
    cfg = data.config
    ld = cfg.loop_data
    bg = jnp.asarray(cfg.background, jnp.float32)
    # pad the render height to a tile multiple; frames crop on emit
    n_tile = mesh.shape["tile"] if mesh is not None else 1
    hp = -(-height // n_tile) * n_tile
    # SVGF temporal reprojection (render/temporal.py): fused-path only —
    # history rides the scan carry across frames, chunks, and files;
    # both integrators (the path tracer demodulates by the first-hit
    # albedo guide, folding NEE direct light into the blended irradiance)
    use_temporal = bool(getattr(cfg, "temporal", True))
    state = {"lights": None, "base": None, "tstate": None}
    if use_temporal:
        from optix_ray_tracer_tpu.render import temporal as tmod
        state["tstate"] = tmod.empty_state(width, hp)

    def dispatch_chunks():
        """Dispatch fused chunks asynchronously; yields
        (fi, k0, chunk, device outputs)."""
        planned = 0
        while True:
            for fi in range(data.file_count):
                n_frames = common.frame_count_for_file(
                    data.durations[fi], ld.fps, ld.render_speed_ratio)
                # per-file build (buildGAS analog, RendererMesh.cu:93-167):
                # a device-side LBVH rebuild (fresh Morton order, jitted)
                # for the series' padded shapes; refit happens in-scan per
                # frame
                from optix_ray_tracer_tpu.models import (
                    renderer_mesh, renderer_time,
                )
                frontend = renderer_mesh if mode == "mesh" else renderer_time
                scene0 = frontend.frame_scene(data, fi, 0, n_frames)
                if state["lights"] is None:
                    state["lights"] = common.collect_lights(
                        cfg, scene0, data.materials)
                # rebuild_or_choose degrades to a fresh build if a frontend
                # ever yields per-file scenes with differing padded counts
                state["base"] = common.rebuild_or_choose(
                    state["base"], scene0)
                fd = file_data_fn(data, fi, n_frames)
                bpp = (4 if quantize else 12) + (24 if fetch_guides else 0)
                chunk = chunk_size(width, hp, n_frames, bpp)
                for k0 in range(0, n_frames, chunk):
                    ks = jnp.arange(k0, k0 + chunk, dtype=jnp.float32)
                    seeds = jnp.arange(
                        cfg.seed + planned, cfg.seed + planned + chunk,
                        dtype=jnp.int32)
                    out = fused_chunk(
                        fd, ks, seeds, state["base"], data.materials,
                        data.camera, data.extra_spheres,
                        data.extra_triangles, data.env, data.textures,
                        state["lights"], bg, state["tstate"],
                        mode=mode, width=width, height=hp, spp=spp,
                        integrator=cfg.integrator, do_denoise=cfg.denoise,
                        denoiser=common.resolve_denoiser(cfg),
                        sampler=getattr(cfg, "sampler", "pcg"),
                        max_depth=cfg.max_depth,
                        has_extras=bool(data.extra_triangles.count),
                        euler_path=getattr(data, "reference_euler_path",
                                           False),
                        quantize=quantize, want_guides=fetch_guides,
                        temporal=use_temporal, mesh=mesh)
                    if use_temporal:
                        out, state["tstate"] = out
                    yield fi, k0, chunk, out
                    planned += chunk
                    if max_frames is not None and planned >= max_frames:
                        return
            if not loop:
                return

    produced = 0

    def emit(item):
        nonlocal produced
        fi, k0, chunk, out = item
        imgs = np.asarray(out[0])
        if fetch_guides:
            albs = np.asarray(out[1])
            nrms = np.asarray(out[2])
        else:
            albs = nrms = None
        for j in range(chunk):
            if quantize:
                frame = U8Frame(imgs[j][:height], spp)
            else:
                z = np.zeros((height, width, 3), imgs.dtype)
                frame = Film.create(width, height).add(
                    imgs[j][:height],
                    albs[j][:height] if albs is not None else z,
                    nrms[j][:height] if nrms is not None else z, spp)
            yield fi, k0 + j, frame
            produced += 1
            if max_frames is not None and produced >= max_frames:
                return

    prev = None
    for item in dispatch_chunks():
        if prev is not None:
            yield from emit(prev)
            if max_frames is not None and produced >= max_frames:
                return
        prev = item
    if prev is not None:
        yield from emit(prev)


def mesh_file_data(data, fi: int, n_frames: int) -> dict:
    cfg = data.config.loop_data
    return dict(
        vertices=data.vertices[fi], normals=data.normals[fi],
        tri_particle=data.tri_particle[fi], tri_valid=data.tri_valid[fi],
        velocities=data.velocities[fi], particle_mat=data.particle_mat[fi],
        duration=jnp.float32(data.durations[fi]),
        inv_frame_count=jnp.float32(1.0 / max(n_frames, 1)),
        particle_shift=jnp.asarray(cfg.particle_shift, jnp.float32),
        particle_scale=jnp.asarray(cfg.particle_scale, jnp.float32))


def time_file_data(data, fi: int, n_frames: int) -> dict:
    cfg = data.config.loop_data
    nxt = min(fi + 1, data.file_count - 1)
    return dict(
        lib_vertices=data.library.vertices, lib_normals=data.library.normals,
        tri_lib_idx=data.tri_lib_idx[fi], tri_inst=data.tri_inst[fi],
        tri_ok=data.tri_ok[fi],
        positions=data.positions[fi], quats=data.quats[fi],
        quats_next=data.quats[nxt], velocities=data.velocities[fi],
        particle_mat=data.particle_mat[fi],
        duration=jnp.float32(data.durations[fi]),
        inv_frames_minus1=jnp.float32(1.0 / max(n_frames - 1, 1)),
        inv_frame_count=jnp.float32(1.0 / max(n_frames, 1)),
        particle_shift=jnp.asarray(cfg.particle_shift, jnp.float32),
        particle_scale=jnp.asarray(cfg.particle_scale, jnp.float32))
