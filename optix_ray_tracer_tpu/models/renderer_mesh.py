"""Mesh-mode renderer frontend.

Counterpart of ``RendererMesh`` (``src/Global/RendererMesh.cu``):
each VTK file carries full per-particle triangle geometry; files are baked
to a binary cache, loaded in a thread pool, and animated by shifting each
particle along its velocity across the file's duration
(RendererMesh.cu:379-391: shift = velocity * duration * frame/frameCount,
composed with the global particle offset/scale).

Redesign decisions (vs. the reference's structure):

* Per-file geometry is padded to ONE static shape (max triangle count), so
  one compiled render program serves every animation file — no per-file
  recompiles (XLA static-shape discipline).
* Per-frame particle transforms are computed ON DEVICE and fused into the
  vertex buffer (a gather + multiply-add), replacing the reference's
  CPU transform loop + pinned-memory H2D copy + IAS refit
  (RendererMesh.cu:379-397, RendererImpl.cu:210-242).
* The acceleration structure is a device-resident LBVH, built per file
  and refitted per frame (jitted), the reference's build/refit policy.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from optix_ray_tracer_tpu.io import cache as cache_io
from optix_ray_tracer_tpu.io.config import RendererConfig
from optix_ray_tracer_tpu.io.series import read_series
from optix_ray_tracer_tpu.models import common
from optix_ray_tracer_tpu.render.film import Film
from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles
from optix_ray_tracer_tpu.utils.logging import LOG


@dataclasses.dataclass
class MeshRendererData:
    """Committed scene state (device arrays + static host metadata)."""
    config: RendererConfig
    materials: object             # MaterialTable
    material_offset: int
    extra_spheres: Spheres
    extra_triangles: Triangles    # static config meshes (appended per frame)
    env: object | None            # EnvMap from config, or None
    textures: object | None      # TextureSet from config, or None
    durations: list[float]
    # stacked per-file device arrays, padded to max triangle / particle count
    vertices: jax.Array           # (F, Tmax, 3, 3) object-space
    normals: jax.Array            # (F, Tmax, 3, 3)
    tri_particle: jax.Array       # (F, Tmax) int32 particle slot per triangle
    tri_valid: jax.Array          # (F, Tmax) bool
    velocities: jax.Array         # (F, Pmax, 3)
    particle_mat: jax.Array       # (F, Pmax) int32 material row
    file_count: int
    max_triangles: int
    camera: object
    update_fn: Callable | None = None   # analog of setAddGeoInsUpdateFunc


def commit(config: RendererConfig) -> MeshRendererData:
    """Load series + caches and upload device arrays
    (RendererMesh::commitRendererData parity)."""
    series = read_series(config.resolve(config.series_path), config.series_name)
    LOG.info("mesh mode: %d files in series", series.count)

    frames = cache_io.load_or_bake(
        config.resolve(config.cache_path), series.paths,
        use_cache=True, thread_count=config.cache_process_thread_count)

    max_cells = max((len(f.ids) for f in frames), default=0)
    materials, bases = common.build_materials(config, max_cells)
    material_offset = bases.material_offset
    extra_spheres = common.build_extra_spheres(config, bases)
    extra_triangles = common.build_extra_triangles(config, bases)
    env = common.build_envmap(config)
    textures = common.build_textures(config, bases, materials.count)

    # pad + stack across files
    verts = common.pad_stack([f.vertices for f in frames])
    normals = common.pad_stack([f.normals for f in frames])
    tri_pid, tri_valid, vels, pmat = [], [], [], []
    tmax = verts.shape[1] if verts.ndim > 1 else 0
    pmax = max((len(f.ids) for f in frames), default=1)
    for f in frames:
        pid = np.zeros(tmax, np.int32)
        valid = np.zeros(tmax, bool)
        for p, (off, cnt) in enumerate(zip(f.tri_offsets, f.tri_counts)):
            pid[off:off + cnt] = p
            valid[off:off + cnt] = True
        tri_pid.append(pid)
        tri_valid.append(valid)
        v = np.zeros((pmax, 3), np.float32)
        v[:len(f.velocities)] = f.velocities
        vels.append(v)
        m = np.zeros(pmax, np.int32)
        # per-particle material = ramp row id + materialOffset
        # (RendererMesh.cu:274-276: particle.id + materialOffset)
        m[:len(f.ids)] = f.ids.astype(np.int32) + material_offset
        pmat.append(m)

    return MeshRendererData(
        config=config, materials=materials, material_offset=material_offset,
        extra_spheres=extra_spheres, extra_triangles=extra_triangles,
        env=env, textures=textures, durations=series.durations,
        vertices=jnp.asarray(verts), normals=jnp.asarray(normals),
        tri_particle=jnp.asarray(np.stack(tri_pid) if tri_pid else
                                 np.zeros((0, 0), np.int32)),
        tri_valid=jnp.asarray(np.stack(tri_valid) if tri_valid else
                              np.zeros((0, 0), bool)),
        velocities=jnp.asarray(np.stack(vels) if vels else
                               np.zeros((0, 1, 3), np.float32)),
        particle_mat=jnp.asarray(np.stack(pmat) if pmat else
                                 np.zeros((0, 1), np.int32)),
        file_count=series.count, max_triangles=tmax,
        camera=common.camera_from_config(config))


def _cache_exists(config: RendererConfig) -> bool:
    return os.path.isdir(config.resolve(config.cache_path))


def write_cache_files(config: RendererConfig) -> dict:
    """``writeCacheFilesAndExit`` analog (RendererMesh.cu:502-508) — bakes
    caches and returns metadata instead of exiting the process."""
    series = read_series(config.resolve(config.series_path), config.series_name)
    return cache_io.write_mesh_cache(
        config.resolve(config.cache_path), series.paths,
        config.cache_process_thread_count)


def set_update_fn(data: MeshRendererData, fn: Callable) -> None:
    """User hook analog of setAddGeoInsUpdateFunc (Main.cu:5-9): called per
    frame with (spheres, frame_index) and may return replacement spheres."""
    data.update_fn = fn


@partial(jax.jit, static_argnames=())
def _frame_world(verts, normals, tri_pid, tri_valid, vels, pmat,
                 shift_scale, particle_shift, particle_scale):
    """Device-side per-frame world build: world_verts = v*scale +
    (offset + velocity*progress) gathered per triangle.

    Replaces the reference's CPU loop writing pinned OptixInstance
    transforms (RendererMesh.cu:379-397) — no host round-trip."""
    shift = particle_shift[None, :] + vels * shift_scale  # (Pmax, 3)
    tri_shift = shift[tri_pid]                            # (Tmax, 3)
    world_v = verts * particle_scale + tri_shift[:, None, :]
    world_v = jnp.where(tri_valid[:, None, None], world_v, 0.0)
    mat = pmat[tri_pid]
    return world_v, normals, mat


def prev_world_points(fd, k, x, prim):
    """Previous-frame world positions of this frame's hit points (the
    temporal reprojector's motion model, render/temporal.py).

    Mesh-mode motion is pure translation: particle p moves by
    velocity * duration / frame_count per frame (RendererMesh.cu:379-391),
    so the previous position of a point on packed triangle ``prim``
    (particle ``tri_particle[prim]``) is x - vel * step.  Static extras
    (prim >= packed count), sphere hits and misses (prim < 0) map to
    themselves; frame 0 has no intra-file predecessor and maps to itself.

    fd: the fused-path file-data dict (models/fused.py ``mesh_file_data``);
    x: (..., 3); prim: (...) int32.
    """
    t_pack = fd["tri_particle"].shape[0]
    dynamic = (prim >= 0) & (prim < t_pack) & (k > 0.0)
    pid = fd["tri_particle"][jnp.clip(prim, 0, max(t_pack - 1, 0))]
    step = fd["duration"] * fd["inv_frame_count"]
    x_prev = x - fd["velocities"][pid] * step
    return jnp.where(dynamic[..., None], x_prev, x)


def frame_scene(data: MeshRendererData, file_index: int, frame_index: int,
                frame_count: int) -> Scene:
    """Build the world-space Scene for one animation frame."""
    cfg = data.config.loop_data
    duration = data.durations[file_index]
    # totalShift = velocity*duration; per-frame shift = totalShift/frameCount
    # accumulated frame_index times (RendererMesh.cu:381-387)
    shift_scale = jnp.float32(duration * frame_index / max(frame_count, 1))
    world_v, normals, mat = _frame_world(
        data.vertices[file_index], data.normals[file_index],
        data.tri_particle[file_index], data.tri_valid[file_index],
        data.velocities[file_index], data.particle_mat[file_index],
        shift_scale,
        jnp.asarray(cfg.particle_shift, jnp.float32),
        jnp.asarray(cfg.particle_scale, jnp.float32))
    tris = Triangles(world_v, normals, mat)
    if data.extra_triangles.count:
        # static extras appended AFTER the (static-size) particle block, so
        # their indices — and any lights collected from them — are stable
        # across frames
        tris = tris.concat(data.extra_triangles)

    spheres = data.extra_spheres
    if data.update_fn is not None:
        out = data.update_fn(spheres, frame_index)
        if out is not None:
            spheres = out
    return Scene(spheres=spheres, triangles=tris)


def render_frames(data: MeshRendererData, width: int | None = None,
                  height: int | None = None, spp: int | None = None,
                  max_frames: int | None = None,
                  loop: bool = False, fetch_guides: bool = False,
                  quantize: bool = False) -> Iterator[tuple[int, int, Film]]:
    """The render loop (startRender parity, headless): yields
    (file_index, frame_index, Film) per frame.

    Animation pacing follows the reference: frames per file =
    duration * fps * renderSpeedRatio (RendererMesh.cu:370-371); ``loop``
    repeats the series cyclically like the reference's animation loop.

    Guide-channel contract: the default fused path yields Films whose
    albedo/normal guide channels are ZERO (the in-loop denoiser consumed
    the guides on device) — pass ``fetch_guides=True`` to fetch real
    guides per frame.  The per-frame fallback (update_fn installed or
    debug mode) always carries real guides.  ``quantize=True`` yields
    :class:`~optix_ray_tracer_tpu.render.film.U8Frame` (device-quantized
    sRGB uint8, the animation fast path) instead of Films.
    """
    cfg = data.config
    ld = cfg.loop_data
    width = width or ld.window_width
    height = height or ld.window_height
    spp = spp or cfg.spp

    from optix_ray_tracer_tpu.utils.debug import DEBUG_MODE
    if (data.update_fn is None and not DEBUG_MODE and data.file_count
            and not cfg.integrator.startswith("restir")):
        # fused path: refit+render+denoise for a whole frame chunk in one
        # dispatch (models/fused.py) — the per-frame host loop below pays
        # the ~6 ms dispatch floor several times per frame.  The restir
        # integrator renders per-frame (reservoir state lives in
        # common.render_frame's progressive scan, not the fused scan).
        from optix_ray_tracer_tpu.models import fused
        yield from fused.render_frames_fused(
            data, "mesh", fused.mesh_file_data, width, height, spp,
            max_frames, loop, fetch_guides=fetch_guides, quantize=quantize)
        return

    produced = 0
    lights = None
    intersector = None
    while True:
        for fi in range(data.file_count):
            n_frames = common.frame_count_for_file(
                data.durations[fi], ld.fps, ld.render_speed_ratio)
            for k in range(n_frames):
                scene = frame_scene(data, fi, k, n_frames)
                if produced == 0:
                    # emissives only come from static extras, so the light
                    # table collected once stays valid for every frame
                    lights = common.collect_lights(cfg, scene, data.materials)
                # accel policy matching the reference (RendererImpl.cu:
                # 210-242): full build on the file's first frame (done on
                # DEVICE after the first file — fresh Morton order via
                # rebuild_clusters), exact device-side refit for the
                # remaining animation frames
                intersector = (common.rebuild_or_choose(intersector, scene)
                               if k == 0
                               else common.refit_or_choose(intersector,
                                                           scene))
                img, alb, nrm = common.render_frame(
                    cfg, scene, data.materials, data.camera, width, height,
                    spp=spp, seed=cfg.seed + produced,
                    intersector=intersector, env=data.env,
                    textures=data.textures, lights=lights)
                film = Film.create(width, height).add(img, alb, nrm, spp)
                if quantize:
                    from optix_ray_tracer_tpu.render.film import U8Frame
                    film = U8Frame(film.to_uint8(), spp)
                yield fi, k, film
                produced += 1
                if max_frames is not None and produced >= max_frames:
                    return
        if not loop:
            return
