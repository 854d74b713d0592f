"""Multi-chip rendering via jax.sharding — the distributed layer the
reference never had (single GPU by design, reference
docs/technical-details.md:325-328; multi-GPU listed as future work).

Two orthogonal sharding axes, composable on a 2D device mesh:

* TILE sharding ("dp" analog): the pixel grid splits into row bands, one per
  device along the ``tile`` axis; each device traces only its band.  Scene,
  BVH, and materials are replicated (scenes fit device memory; the
  framebuffer is the big thing).  No collective needed — the output image is laid out sharded.
* SAMPLE sharding ("sp" analog): samples-per-pixel split along the
  ``sample`` axis; partial accumulations merge with one ``psum``.

Determinism is exact under any mesh shape: the counter-based RNG keys off
GLOBAL (pixel_id, sample_index), which the shards compute from their mesh
coordinates — resharding never changes the image.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from optix_ray_tracer_tpu.render import wavefront
from optix_ray_tracer_tpu.utils import rng as rng_mod


def make_mesh(tile: int = 1, sample: int = 1, devices=None) -> Mesh:
    """Build a (tile, sample) device mesh from the first tile*sample devices."""
    devices = devices if devices is not None else jax.devices()
    need = tile * sample
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(tile, sample)
    return Mesh(arr, axis_names=("tile", "sample"))


def _tile_rays(camera, width, height, rows_per_shard, tile_idx, spp_offset,
               sample_in_shard, pixel_id, seed, jitter,
               sampler: str = "pcg"):
    """Primary rays for one row band with GLOBAL pixel ids/jitter."""
    iy0 = tile_idx * rows_per_shard
    iy = (jnp.arange(rows_per_shard, dtype=jnp.float32)[:, None]
          + jnp.float32(iy0))
    ix = jnp.arange(width, dtype=jnp.float32)[None, :]
    if jitter:
        u1, u2 = rng_mod.stratified_jitter(
            pixel_id, spp_offset + sample_in_shard, seed, sampler)
        ox = u1.reshape(rows_per_shard, width)
        oy = u2.reshape(rows_per_shard, width)
    else:
        ox = oy = 0.5
    ndc_x = ((ix + ox) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((iy + oy) / height) * 2.0
    aspect = width / height
    dirs = (ndc_x[..., None] * aspect * camera.u
            + ndc_y[..., None] * camera.v + camera.w)
    from optix_ray_tracer_tpu.utils.vecmath import normalize
    dirs = normalize(dirs)
    origins = jnp.broadcast_to(camera.center, dirs.shape)
    # thin-lens DOF (static aperture: pruned entirely for pinhole
    # cameras), same stream keying as the integrators' sample_step
    if float(camera.aperture) > 0.0:
        lens = rng_mod.random_in_unit_disk(
            pixel_id, spp_offset + sample_in_shard, jnp.int32(-2),
            seed ^ 0x68E31DA4, sampler).reshape(rows_per_shard, width, 2)
        origins, dirs = camera.apply_lens(origins, dirs, lens)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "max_depth", "jitter",
                          "mesh", "want_guides", "sampler"))
def render_sharded(scene, materials, camera, width: int, height: int,
                   spp: int, mesh: Mesh, seed: int = 0,
                   background=wavefront.DEFAULT_BACKGROUND,
                   max_depth: int = wavefront.DEFAULT_MAX_DEPTH,
                   intersector=None, jitter: bool = True, env=None,
                   want_guides: bool = False, sampler: str = "pcg"):
    """Render with the pixel grid sharded over ``tile`` and samples over
    ``sample``.  Returns a (H, W, 3) linear image (sharded along rows on the
    tile axis; sample axis already reduced); with ``want_guides`` returns
    (image, albedo, normal) — the denoiser inputs, same sharding.
    """
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile={n_tile}")
    if spp % n_sample != 0:
        raise ValueError(f"spp {spp} not divisible by sample={n_sample}")
    rows_per = height // n_tile
    spp_per = spp // n_sample

    if intersector is None:
        from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
        intersector = BruteForceIntersector()
    background_a = jnp.asarray(background, jnp.float32)

    replicated = P()

    def shard_fn(scene, materials, camera, intersector, env):
        tile_idx = jax.lax.axis_index("tile")
        sample_idx = jax.lax.axis_index("sample")
        spp_offset = sample_idx * spp_per
        npix = rows_per * width
        # GLOBAL pixel ids -> sharding-invariant RNG
        pixel_id = (tile_idx * npix
                    + jnp.arange(npix, dtype=jnp.int32)).astype(jnp.int32)

        def sample_step(acc, s_local):
            o, d = _tile_rays(camera, width, height, rows_per, tile_idx,
                              spp_offset, s_local, pixel_id, seed, jitter,
                              sampler)
            radiance, alb, nrm = wavefront.trace(
                scene, materials, o, d, pixel_id,
                spp_offset + s_local, seed, background_a, max_depth,
                intersector, env, sampler=sampler)
            return (acc[0] + radiance, acc[1] + alb, acc[2] + nrm), None

        z = jnp.zeros((npix, 3), jnp.float32)
        acc, _ = jax.lax.scan(sample_step, (z, z, z),
                              jnp.arange(spp_per, dtype=jnp.int32))
        # merge the sample axis
        acc = jax.lax.psum(acc, axis_name="sample")
        return tuple((a / spp).reshape(rows_per, width, 3) for a in acc)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(replicated,) * 5,
        out_specs=(P("tile", None, None),) * 3,
        # varying-manual-axes checker off: it demands pvary/pcast variance
        # annotations on every scan carry INSIDE the single-device
        # integrators and intersectors (e.g. the Hit carry in
        # ops/intersect.py), leaking sharding concerns into device-local
        # code.  The guarantee the checker would give is covered by tests
        # instead: tests/test_sharding.py asserts bit-identical images vs
        # single-device execution across mesh shapes for BOTH the
        # brute-force and the production traversal intersectors
        check_vma=False)
    img, alb, nrm = fn(scene, materials, camera, intersector, env)
    if want_guides:
        return img, alb, nrm
    return img


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "max_depth", "jitter",
                          "mesh", "want_guides", "sampler"))
def render_path_sharded(scene, materials, lights, camera, width: int,
                        height: int, spp: int, mesh: Mesh, seed: int = 0,
                        background=(0.0, 0.0, 0.0), max_depth: int = 8,
                        intersector=None, env=None, textures=None,
                        jitter: bool = True, want_guides: bool = False,
                        sampler: str = "pcg"):
    """NEE+MIS path tracing over the (tile, sample) mesh — same sharding
    contract as :func:`render_sharded` (exact under any mesh shape).
    With ``want_guides`` returns (image, albedo, normal)."""
    from optix_ray_tracer_tpu.render.pathtracer import trace_path

    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile={n_tile}")
    if spp % n_sample != 0:
        raise ValueError(f"spp {spp} not divisible by sample={n_sample}")
    rows_per = height // n_tile
    spp_per = spp // n_sample

    if intersector is None:
        from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
        intersector = BruteForceIntersector()
    background_a = jnp.asarray(background, jnp.float32)
    replicated = P()

    def shard_fn(scene, materials, lights, camera, intersector, env,
                 textures):
        tile_idx = jax.lax.axis_index("tile")
        sample_idx = jax.lax.axis_index("sample")
        spp_offset = sample_idx * spp_per
        npix = rows_per * width
        pixel_id = (tile_idx * npix
                    + jnp.arange(npix, dtype=jnp.int32)).astype(jnp.int32)

        def sample_step(acc, s_local):
            o, d = _tile_rays(camera, width, height, rows_per, tile_idx,
                              spp_offset, s_local, pixel_id, seed, jitter,
                              sampler)
            radiance, alb, nrm = trace_path(
                scene, materials, lights, o, d, pixel_id,
                spp_offset + s_local, seed, background_a, max_depth,
                intersector, env, textures, sampler=sampler)
            return (acc[0] + radiance, acc[1] + alb, acc[2] + nrm), None

        z = jnp.zeros((npix, 3), jnp.float32)
        acc, _ = jax.lax.scan(sample_step, (z, z, z),
                              jnp.arange(spp_per, dtype=jnp.int32))
        acc = jax.lax.psum(acc, axis_name="sample")
        return tuple((a / spp).reshape(rows_per, width, 3) for a in acc)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(replicated,) * 7,
        out_specs=(P("tile", None, None),) * 3,
        check_vma=False)
    img, alb, nrm = fn(scene, materials, lights, camera, intersector, env,
                       textures)
    if want_guides:
        return img, alb, nrm
    return img


@partial(jax.jit, static_argnames=("width", "height", "mesh",
                                   "m_candidates", "spatial_taps",
                                   "spatial_radius", "sampler"))
def render_restir_sharded(scene, materials, lights, camera, width: int,
                          height: int, mesh: Mesh, seed=0, frame=0,
                          state=None, prev_camera=None,
                          m_candidates: int = 16, spatial_taps: int = 2,
                          spatial_radius: int = 16, intersector=None,
                          background=(0.0, 0.0, 0.0), env=None,
                          textures=None, sampler: str = "pcg"):
    """ReSTIR DI (render/restir.py) over the ``tile`` axis of the mesh.

    Hybrid sharding, chosen to fit what each stage IS: the two RAY
    stages (primary intersect, winner shadow ray) run under ``shard_map``
    in row bands because the traversal kernel cannot be auto-partitioned; the resample/reuse math between them is pure lane
    arithmetic plus small image gathers, so it runs as ONE global
    program and GSPMD partitions it — spatial taps that cross band edges
    and the anywhere-to-anywhere temporal reprojection gathers become
    XLA collectives automatically instead of hand-rolled halo exchanges.

    Exact under any tile count: RNG keys off global pixel ids and every
    arithmetic op is per-pixel, so image AND new reservoir state match
    :func:`render_restir` bit-for-bit (tests/test_sharding.py).  ReSTIR
    is one sample/pixel/frame by construction, so there is no sample
    axis to shard (use temporal frames or
    ``render_restir_progressive`` for more rays).
    """
    from optix_ray_tracer_tpu.render import restir as R

    n_tile = mesh.shape["tile"]
    if mesh.shape.get("sample", 1) != 1:
        raise ValueError("restir renders 1 sample/pixel/frame: use a "
                         "tile-only mesh (sample axis must be 1)")
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile={n_tile}")
    if lights is None or lights.count == 0:
        raise ValueError("render_restir needs a non-empty light table")
    rows_per = height // n_tile
    band = rows_per * width

    if intersector is None:
        from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
        intersector = BruteForceIntersector()
    background = jnp.asarray(background, jnp.float32)
    frame = jnp.asarray(frame, jnp.int32)
    from optix_ray_tracer_tpu.utils.vecmath import INF

    def primary(scene, camera, intersector):
        tile_idx = jax.lax.axis_index("tile")
        pid = (tile_idx * band
               + jnp.arange(band, dtype=jnp.int32)).astype(jnp.int32)
        o, d = camera.generate_rays_for_pixels(pid, width, height)
        hit = intersector.intersect(scene, o, d,
                                    t_max=jnp.full((band,), INF))
        return o, d, hit

    o, d, hit = jax.shard_map(
        primary, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P("tile", None), P("tile", None), P("tile")),
        check_vma=False)(scene, camera, intersector)

    point, n_unit, albedo, active, base, albedo_g, normal_g = R._gbuffer(
        scene, materials, o, d, hit, textures, env, background)

    packed = R._pack_lights(lights)
    li2, u22, u32, W2, m2, act2, t2, n2 = R._resample(
        lights, packed, point, n_unit, albedo, active, hit.t, width,
        height, frame, seed, state, camera, prev_camera, m_candidates,
        spatial_taps, spatial_radius, sampler)

    rgb, wdir, dist, live, Wf = R._shade_terms(
        packed, li2, u22, u32, W2, point, n_unit, albedo, active)

    def shadow(scene, intersector, origin, wdir, t_max):
        return intersector.any_hit(scene, origin, wdir, t_min=1e-4,
                                   t_max=t_max)

    occluded = jax.shard_map(
        shadow, mesh=mesh,
        in_specs=(P(), P(), P("tile", None), P("tile", None), P("tile")),
        out_specs=P("tile"), check_vma=False)(
        scene, intersector, point + n_unit * 1e-3, wdir,
        jnp.where(live, dist - 2e-3, 0.0))

    return R._compose(base, rgb, Wf, live, occluded, li2, u22, u32, m2,
                      act2, t2, n2, albedo_g, normal_g, width, height)


def broadcast_scene(scene_host):
    """Multi-host scene distribution: device_put the host scene once per
    process (DCN broadcast analog).  On a single host this is a plain
    transfer; under multi-controller JAX each process loads/receives the
    same arrays so replication is consistent."""
    return jax.device_put(scene_host)
