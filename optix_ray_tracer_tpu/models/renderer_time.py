"""Time-mode renderer frontend.

Counterpart of ``RendererTime`` (``src/Global/RendererTime.cu``):
VTK files carry only particle poses (position, quaternion, velocity,
shape_id); geometry comes from a shared library of STL shapes loaded once
(RendererTime.cu:176-182, lexicographic filename order = shape_id).  Per
frame, positions integrate along velocity and orientations slerp between
consecutive files (RendererTime.cu:436-472).

Redesign:

* The STL shape library is one packed triangle buffer with (offset, count)
  ranges (``ShapeLibrary``); per-frame instancing is a device-side gather +
  batched affine ("flatten instancing"), replacing pinned OptixInstance
  arrays + H2D copies + IAS refit.
* Instancing is PACKED: per-file gather tables map each output triangle
  slot to (library triangle, instance), so frame geometry is sized by the
  SUM of the instanced shapes' triangle counts — not particles x the max
  shape size (the two-level-IAS memory behavior of
  RendererImpl.cu:174-242, without per-ray instance transforms; two-level
  traversal in the GPU kernel is queued in ROADMAP.md).
* Orientation math: the reference converts the slerped quaternion to Euler
  XYZ degrees and rebuilds Rx@Ry@Rz (RendererTime.cu:343-370 +
  DeviceFunctions.cuh:128-133) — a lossy decompose/recompose round-trip
  (the conventions don't commute).  We rotate directly with the quaternion's
  rotation matrix (exact); pass ``reference_euler_path=True`` to reproduce
  the reference's numerics bit-for-bit intention.
* Particle slerp/integration is jitted and runs on device for ALL particles
  at once.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from optix_ray_tracer_tpu.io.config import RendererConfig
from optix_ray_tracer_tpu.io.series import load_stl_directory, read_series
from optix_ray_tracer_tpu.io.native_io import read_time_file
from optix_ray_tracer_tpu.models import common
from optix_ray_tracer_tpu.render.film import Film
from optix_ray_tracer_tpu.scene.geometry import (
    Scene, ShapeLibrary, Spheres, Triangles,
)
from optix_ray_tracer_tpu.utils.logging import LOG
from optix_ray_tracer_tpu.utils.transforms import (
    quat_slerp, quat_to_euler_degrees, quat_to_rotation_matrix,
    rotation_matrix_euler_xyz_degrees,
)


@dataclasses.dataclass
class TimeRendererData:
    config: RendererConfig
    materials: object
    material_offset: int
    extra_spheres: Spheres
    extra_triangles: Triangles
    env: object | None
    textures: object | None
    durations: list[float]
    library: ShapeLibrary
    # padded per-file particle state (F, Pmax, ...)
    positions: jax.Array      # (F, Pmax, 3)
    quats: jax.Array          # (F, Pmax, 4) w-x-y-z
    velocities: jax.Array     # (F, Pmax, 3)
    shape_ids: jax.Array      # (F, Pmax) int32
    particle_mat: jax.Array   # (F, Pmax) int32
    particle_valid: jax.Array  # (F, Pmax) bool
    # packed instancing tables: per-file maps from output triangle slot to
    # (library triangle, instance) — frame geometry is sized by the SUM of
    # instanced shape sizes, not Pmax * max shape size
    tri_lib_idx: jax.Array    # (F, T_pack) int32 into the packed library
    tri_inst: jax.Array       # (F, T_pack) int32 particle index
    tri_ok: jax.Array         # (F, T_pack) bool
    file_count: int
    camera: object
    reference_euler_path: bool = False
    update_fn: Callable | None = None


def commit(config: RendererConfig,
           reference_euler_path: bool = False) -> TimeRendererData:
    """RendererTime::commitRendererData parity: STL library + pose series."""
    meshes = load_stl_directory(config.resolve(config.stl_path))
    library = ShapeLibrary.from_meshes(meshes)
    LOG.info("time mode: %d STL shapes, %d packed triangles",
             library.num_shapes, int(library.vertices.shape[0]))

    series = read_series(config.resolve(config.series_path), config.series_name)
    frames = [read_time_file(p) for p in series.paths]
    LOG.info("time mode: %d pose files", len(frames))

    max_points = max((len(f.ids) for f in frames), default=0)
    materials, bases = common.build_materials(config, max_points)
    material_offset = bases.material_offset
    extra_spheres = common.build_extra_spheres(config, bases)
    extra_triangles = common.build_extra_triangles(config, bases)
    env = common.build_envmap(config)
    textures = common.build_textures(config, bases, materials.count)

    pmax = max(max_points, 1)
    F = len(frames)
    pos = np.zeros((F, pmax, 3), np.float32)
    quat = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (F, pmax, 1))
    vel = np.zeros((F, pmax, 3), np.float32)
    sid = np.zeros((F, pmax), np.int32)
    pmat = np.zeros((F, pmax), np.int32)
    valid = np.zeros((F, pmax), bool)
    for i, f in enumerate(frames):
        p = len(f.ids)
        pos[i, :p] = f.positions
        quat[i, :p] = f.quats
        vel[i, :p] = f.velocities
        sid[i, :p] = np.clip(f.shape_ids, 0, max(library.num_shapes - 1, 0))
        pmat[i, :p] = f.ids.astype(np.int32) + material_offset
        valid[i, :p] = True

    # packed instancing tables (one gather row per ACTUAL instanced
    # triangle; T_pack = max over files of sum of shape sizes)
    offs = np.asarray(library.offsets, np.int64) if library.num_shapes \
        else np.zeros(1, np.int64)
    cnts = np.asarray(library.counts, np.int64) if library.num_shapes \
        else np.zeros(1, np.int64)
    per_file_tot = [int(cnts[sid[i][valid[i]]].sum()) for i in range(F)]
    t_pack = max(max(per_file_tot, default=0), 1)
    lib_idx = np.zeros((F, t_pack), np.int32)
    inst_idx = np.zeros((F, t_pack), np.int32)
    tri_ok = np.zeros((F, t_pack), bool)
    for i in range(F):
        w = 0
        for p in range(pmax):
            if not valid[i, p]:
                continue
            c = int(cnts[sid[i, p]])
            lib_idx[i, w:w + c] = offs[sid[i, p]] + np.arange(c)
            inst_idx[i, w:w + c] = p
            tri_ok[i, w:w + c] = True
            w += c
    LOG.info("time mode: packed instancing %d triangles/frame "
             "(flat padding would be %d)", t_pack,
             int(cnts.max() if library.num_shapes else 0) * pmax)

    return TimeRendererData(
        config=config, materials=materials, material_offset=material_offset,
        extra_spheres=extra_spheres, extra_triangles=extra_triangles,
        env=env, textures=textures, durations=series.durations,
        library=library,
        positions=jnp.asarray(pos), quats=jnp.asarray(quat),
        velocities=jnp.asarray(vel), shape_ids=jnp.asarray(sid),
        particle_mat=jnp.asarray(pmat), particle_valid=jnp.asarray(valid),
        tri_lib_idx=jnp.asarray(lib_idx), tri_inst=jnp.asarray(inst_idx),
        tri_ok=jnp.asarray(tri_ok),
        file_count=F, camera=common.camera_from_config(config),
        reference_euler_path=reference_euler_path)


def set_update_fn(data: TimeRendererData, fn: Callable) -> None:
    data.update_fn = fn


def _instance_poses(pos_cur, quat_cur, quat_next, vel, duration, frame_idx,
                    inv_frames_minus1, inv_frame_count, particle_shift,
                    euler_path: bool):
    """Per-particle rigid pose at (possibly fractional) frame index:
    rot (P, 3, 3) + shift (P, 3).  The EXACT motion model of the render
    loop (RendererTime.cu:436-472 semantics) — shared by the frame
    builder below and the temporal reprojector (``prev_world_points``)."""
    factor = jnp.clip(frame_idx * inv_frames_minus1, 0.0, 1.0)
    q = quat_slerp(quat_cur, quat_next,
                   jnp.broadcast_to(factor, quat_cur.shape[:-1]))
    if euler_path:
        rot = rotation_matrix_euler_xyz_degrees(quat_to_euler_degrees(q))
    else:
        rot = quat_to_rotation_matrix(q)
    shift = (pos_cur + vel * (duration * frame_idx * inv_frame_count)
             + particle_shift[None, :])                       # (P, 3)
    return rot, shift


def prev_world_points(fd, k, x, prim, euler_path: bool = False):
    """Previous-frame world positions of this frame's hit points.

    The temporal reprojector's motion model (render/temporal.py): the hit
    point ``x`` on packed triangle ``prim`` belongs to particle
    ``tri_inst[prim]`` whose rigid pose at ANY frame index is known in
    closed form — transform to object space with frame k's pose, back to
    world with frame k-1's.  Static extras (prim >= packed count), sphere
    hits and misses (prim < 0) map to themselves.

    fd: the fused-path file-data dict (models/fused.py ``time_file_data``);
    x: (..., 3); prim: (...) int32.
    """
    args = (fd["positions"], fd["quats"], fd["quats_next"],
            fd["velocities"], fd["duration"])
    tail = (fd["inv_frames_minus1"], fd["inv_frame_count"],
            fd["particle_shift"], euler_path)
    rot_k, shift_k = _instance_poses(*args, k, *tail)
    rot_p, shift_p = _instance_poses(*args, jnp.maximum(k - 1.0, 0.0), *tail)

    t_pack = fd["tri_inst"].shape[0]
    dynamic = (prim >= 0) & (prim < t_pack)
    inst = fd["tri_inst"][jnp.clip(prim, 0, max(t_pack - 1, 0))]
    rk = rot_k[inst]                                         # (..., 3, 3)
    rp = rot_p[inst]
    x_obj = jnp.einsum("...ji,...j->...i", rk, x - shift_k[inst])
    x_prev = jnp.einsum("...ij,...j->...i", rp, x_obj) + shift_p[inst]
    return jnp.where(dynamic[..., None], x_prev, x)


@partial(jax.jit, static_argnames=("euler_path",))
def _frame_triangles(lib_vertices, lib_normals,
                     tri_lib_idx, tri_inst, tri_ok,
                     pos_cur, quat_cur, quat_next, vel, pmat,
                     duration, frame_idx, inv_frames_minus1, inv_frame_count,
                     particle_shift, particle_scale,
                     euler_path: bool):
    """Device-side per-frame PACKED instancing:

    position(t) = pos + velocity*duration*frame/frameCount + global shift
    orientation(t) = slerp(quat_cur, quat_next, frame/(frameCount-1))
    world_verts = R @ (v * scale) + position            per instance, gathered
    (RendererTime.cu:436-472 semantics, fully on device.)

    ``tri_lib_idx``/``tri_inst`` map each packed output slot to (library
    triangle, particle), so the gather touches exactly the instanced
    triangles — sum of shape sizes, not particles x max shape size.
    """
    rot, shift = _instance_poses(
        pos_cur, quat_cur, quat_next, vel, duration, frame_idx,
        inv_frames_minus1, inv_frame_count, particle_shift, euler_path)

    v = lib_vertices[tri_lib_idx]                             # (T, 3, 3)
    n = lib_normals[tri_lib_idx]
    rot_t = rot[tri_inst]                                     # (T, 3, 3)
    shift_t = shift[tri_inst]                                 # (T, 3)
    v = v * particle_scale                                    # object space
    v = jnp.einsum('tij,tkj->tki', rot_t, v) + shift_t[:, None, :]
    n = jnp.einsum('tij,tkj->tki', rot_t, n)
    v = jnp.where(tri_ok[:, None, None], v, 0.0)

    mat = pmat[tri_inst]
    return v, n, mat.astype(jnp.int32)


def frame_scene(data: TimeRendererData, file_index: int, frame_index: int,
                frame_count: int) -> Scene:
    cfg = data.config.loop_data
    next_index = min(file_index + 1, data.file_count - 1)
    if data.library.num_shapes == 0:
        tris = Triangles.empty()
    else:
        v, n, mat = _frame_triangles(
            data.library.vertices, data.library.normals,
            data.tri_lib_idx[file_index], data.tri_inst[file_index],
            data.tri_ok[file_index],
            data.positions[file_index], data.quats[file_index],
            data.quats[next_index], data.velocities[file_index],
            data.particle_mat[file_index],
            jnp.float32(data.durations[file_index]),
            jnp.float32(frame_index),
            jnp.float32(1.0 / max(frame_count - 1, 1)),
            jnp.float32(1.0 / max(frame_count, 1)),
            jnp.asarray(cfg.particle_shift, jnp.float32),
            jnp.asarray(cfg.particle_scale, jnp.float32),
            euler_path=data.reference_euler_path)
        tris = Triangles(v, n, mat)
    if data.extra_triangles.count:
        # static extras appended AFTER the (static-size) particle block, so
        # their indices — and any lights collected from them — are stable
        tris = tris.concat(data.extra_triangles)

    spheres = data.extra_spheres
    if data.update_fn is not None:
        out = data.update_fn(spheres, frame_index)
        if out is not None:
            spheres = out
    return Scene(spheres=spheres, triangles=tris)


def render_frames(data: TimeRendererData, width: int | None = None,
                  height: int | None = None, spp: int | None = None,
                  max_frames: int | None = None,
                  loop: bool = False, fetch_guides: bool = False,
                  quantize: bool = False) -> Iterator[tuple[int, int, Film]]:
    """startRender parity (headless): yields (file_index, frame_index, Film).

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
            and data.library.num_shapes > 0
            and not cfg.integrator.startswith("restir")):
        # fused path: refit+render+denoise for a whole frame chunk in one
        # dispatch (models/fused.py) — the per-frame host loop below pays
        # a dispatch and a sync several times per frame.  Empty shape
        # libraries stay on the per-frame path, which has the explicit
        # Triangles.empty() branch (frame_scene above); restir renders
        # per-frame too (its reservoir scan lives in common.render_frame).
        from optix_ray_tracer_tpu.models import fused
        yield from fused.render_frames_fused(
            data, "time", fused.time_file_data, width, height, spp,
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
