"""Wavefront integrator — the replacement for the reference's recursive
OptiX megakernel.

The reference shades by device-side recursion: closest-hit re-invokes
``optixTrace`` up to depth 5 and multiplies the returned radiance by the
surface albedo on unwind (``shader/Shader.cu:229-241``).  XLA cannot
recurse, so the integrator is an *iterative wavefront*: a ``lax.scan`` over bounce depth
carrying SoA ray state (origin, direction, throughput, radiance, alive mask)
for the whole batch.  The unwind-multiply becomes a running ``throughput``
product, mathematically identical:

    radiance = (prod of albedos along the path) * background   on a miss
    radiance = 0                                               depth exhausted

Matching the reference protocol exactly (payload starts at depth w=1, a hit
with w >= rayTraceDepth returns black, miss returns the background color —
Shader.cu:102-107, 276-287):  bounce index b in [0, max_depth) corresponds
to w = b+1; a hit at b == max_depth-1 contributes nothing.

Extensions beyond the reference shader (required by BASELINE configs):
DIELECTRIC scattering and EMISSIVE accumulation, plus first-bounce
albedo/normal guide buffers (the reference captures these for the OptiX
denoiser at w==1, Shader.cu:216-227).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.ops import intersect as isect
from optix_ray_tracer_tpu.scene.geometry import Scene
from optix_ray_tracer_tpu.scene.materials import (
    DIELECTRIC, EMISSIVE, METAL, ROUGH, MaterialTable,
)
from optix_ray_tracer_tpu.utils import rng
from optix_ray_tracer_tpu.utils.vecmath import (
    EPS, INF, dot, length_squared, normalize, reflect, refract,
    schlick_fresnel,
)

# Decorrelation constants folded into the RNG seed per random *purpose*
# (dimension); arbitrary odd constants kept below 2^31 so they xor cleanly
# with traced int32 seeds.
_DIM_SCATTER = 0x1E3779B9
_DIM_FUZZ = 0x05EBCA6B
_DIM_FRESNEL = 0x42B2AE35
_DIM_LENS = 0x68E31DA4

# The reference's max recursion depth (include/Global/Shader.cuh:8).
DEFAULT_MAX_DEPTH = 5
# Miss background of both frontends (src/Global/RendererMesh.cu:261).
DEFAULT_BACKGROUND = (0.7, 0.8, 0.9)


def scatter(materials: MaterialTable, material_id, d_in, normal, front_face,
            pixel_id, sample, bounce, seed, sampler: str = "pcg"):
    """Compute the scattered direction + attenuation for a batch of hits.

    Vectorized replacement for the material switch in ``closesthitImpl``
    (shader/Shader.cu:164-213): every BSDF branch is evaluated masked and
    blended.

    Returns (new_dir (R,3) unit, attenuation (R,3), emitted (R,3),
    terminate (R,) — True for EMISSIVE hits which end the path).
    """
    mtype, albedo, param, emission = materials.gather(material_id)
    n = normalize(normal)

    # ROUGH: Lambertian, dir = normal + unit_sphere_sample with the
    # degenerate-cancellation guard (Shader.cu:169-179).
    rand_unit = rng.random_unit_vector(pixel_id, sample, bounce,
                                       seed ^ _DIM_SCATTER, sampler)
    d_rough = n + rand_unit
    degenerate = length_squared(d_rough) < EPS
    d_rough = jnp.where(degenerate[..., None], n, d_rough)

    # METAL: mirror + fuzz * unit_sphere_sample (Shader.cu:180-191).
    d_metal = normalize(reflect(d_in, n))
    fuzz_vec = rng.random_unit_vector(pixel_id, sample, bounce,
                                      seed ^ _DIM_FUZZ, sampler)
    d_metal = d_metal + param[..., None] * fuzz_vec

    # DIELECTRIC: refract unless TIR/Schlick says reflect.
    ior = jnp.where(param > 0.0, param, 1.5)
    eta = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(-dot(d_in, n), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = eta * sin_theta > 1.0
    u_fresnel = rng.uniform4(pixel_id, sample, bounce,
                             seed ^ _DIM_FRESNEL, sampler)[0]
    reflectance = schlick_fresnel(cos_theta, ior)
    do_reflect = cannot_refract | (reflectance > u_fresnel)
    d_refr = refract(d_in, n, eta[..., None])
    d_diel = jnp.where(do_reflect[..., None], normalize(reflect(d_in, n)), d_refr)

    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]
    new_dir = jnp.where(is_diel, d_diel, jnp.where(is_metal, d_metal, d_rough))

    # Numeric fallback chain (Shader.cu:202-213): non-finite or near-zero
    # direction -> normal -> fixed +z.
    bad = (~jnp.all(jnp.isfinite(new_dir), axis=-1)) | \
          (length_squared(new_dir) <= EPS)
    new_dir = jnp.where(bad[..., None], n, new_dir)
    bad2 = (~jnp.all(jnp.isfinite(new_dir), axis=-1)) | \
           (length_squared(new_dir) <= EPS)
    fallback = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], new_dir.dtype),
                                new_dir.shape)
    new_dir = normalize(jnp.where(bad2[..., None], fallback, new_dir))

    attenuation = jnp.where(is_diel, jnp.ones_like(albedo), albedo)
    terminate = mtype == EMISSIVE
    return new_dir, attenuation, emission, terminate


def _default_intersector():
    from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
    return BruteForceIntersector()


@partial(jax.jit, static_argnames=("max_depth", "want_aux", "sampler"))
def trace(scene: Scene, materials: MaterialTable, origins, directions,
          pixel_id, sample, seed, background,
          max_depth: int = DEFAULT_MAX_DEPTH,
          intersector=None, env=None, want_aux: bool = False,
          sampler: str = "pcg"):
    """Trace a wavefront of rays to completion.

    origins/directions: (R, 3); pixel_id: (R,) int32; sample: scalar int;
    seed: scalar int; background: (3,) linear color.  ``intersector`` is a
    pytree (TraversalIntersector / BVHIntersector / BruteForceIntersector);
    None = brute force.

    Returns (radiance (R,3) linear, albedo_guide (R,3), normal_guide (R,3));
    with ``want_aux`` also (t (R,), prim_id (R,) int32) of the PRIMARY hit
    (INF / -1 on miss) — the depth/id buffers the temporal reprojector
    consumes (render/temporal.py).
    """
    if intersector is None:
        intersector = _default_intersector()
    nrays = origins.shape[0]
    background = jnp.asarray(background, jnp.float32)

    state = dict(
        o=origins, d=directions,
        throughput=jnp.ones((nrays, 3), jnp.float32),
        radiance=jnp.zeros((nrays, 3), jnp.float32),
        alive=jnp.ones((nrays,), bool),
        albedo_g=jnp.zeros((nrays, 3), jnp.float32),
        normal_g=jnp.zeros((nrays, 3), jnp.float32),
    )
    if want_aux:
        state["t_g"] = jnp.full((nrays,), INF, jnp.float32)
        state["prim_g"] = jnp.full((nrays,), -1, jnp.int32)

    def bounce_step(state, b):
        alive = state["alive"]
        # dead lanes trace with t_max=0: the traversal kernel retires them
        # before their first node fetch
        hit = intersector.intersect(
            scene, state["o"], state["d"],
            t_max=jnp.where(alive, INF, 0.0))
        missed = alive & ~hit.is_hit
        hit_alive = alive & hit.is_hit

        # miss: add throughput-weighted background (Shader.cu:276-287);
        # an EnvMap generalizes the constant miss color (config 5)
        miss_radiance = env.sample(state["d"]) if env is not None \
            else background
        radiance = state["radiance"] + jnp.where(
            missed[..., None], state["throughput"] * miss_radiance, 0.0)

        point, normal, front_face, material_id = isect.shading_frame(
            scene, state["o"], state["d"], hit)
        new_dir, attenuation, emission, emissive_hit = scatter(
            materials, material_id, state["d"], normal, front_face,
            pixel_id, sample, b, seed, sampler)

        # EMISSIVE extension: emitters contribute and end the path.
        radiance = radiance + jnp.where(
            (hit_alive & emissive_hit)[..., None],
            state["throughput"] * emission, 0.0)

        # guide buffers at the first bounce (w==1; Shader.cu:216-227)
        first = hit_alive & (b == 0)
        albedo_g = jnp.where(first[..., None], attenuation, state["albedo_g"])
        normal_g = jnp.where(first[..., None], normalize(normal),
                             state["normal_g"])
        aux = {}
        if want_aux:
            # primary-hit depth + TRIANGLE id (-1 for miss/sphere hits:
            # spheres are static extras, reprojection treats them static)
            aux["t_g"] = jnp.where(first, hit.t, state["t_g"])
            aux["prim_g"] = jnp.where(
                first & (hit.prim_type == isect.PRIM_TRIANGLE),
                hit.prim_id, state["prim_g"])

        scattered = hit_alive & ~emissive_hit
        # depth exhaustion: a hit on the last bounce contributes nothing
        # (handled by the scan simply ending with alive=True rays dropped).
        throughput = jnp.where(scattered[..., None],
                               state["throughput"] * attenuation,
                               state["throughput"])
        o = jnp.where(scattered[..., None], point, state["o"])
        d = jnp.where(scattered[..., None], new_dir, state["d"])
        alive = scattered

        return dict(o=o, d=d, throughput=throughput, radiance=radiance,
                    alive=alive, albedo_g=albedo_g, normal_g=normal_g,
                    **aux), None

    state, _ = jax.lax.scan(bounce_step, state,
                            jnp.arange(max_depth, dtype=jnp.int32))
    if want_aux:
        return (state["radiance"], state["albedo_g"], state["normal_g"],
                (state["t_g"], state["prim_g"]))
    return state["radiance"], state["albedo_g"], state["normal_g"]


def _default_samples_per_wave(spp: int) -> int:
    """Largest divisor of spp among (4, 2, 1): fewer, wider waves."""
    for s in (4, 2, 1):
        if spp % s == 0:
            return s
    return 1


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "max_depth", "jitter",
                          "samples_per_wave", "want_aux", "sampler"))
def render(scene: Scene, materials: MaterialTable, camera,
           width: int, height: int, spp: int = 1, seed: int = 0,
           background=DEFAULT_BACKGROUND,
           max_depth: int = DEFAULT_MAX_DEPTH,
           intersector=None, env=None,
           jitter: bool = True, samples_per_wave: int | None = None,
           want_aux: bool = False, sampler: str = "pcg",
           sample_offset=0):
    """Render a full frame: spp samples per pixel, accumulated in linear space.

    The reference renders 1 spp/frame at pixel centers and relies on the AI
    denoiser; we default to jittered progressive accumulation, but spp=1,
    jitter=False reproduces the reference's sampling pattern.

    ``samples_per_wave`` merges S samples of every pixel into one wavefront
    (must divide spp; default: largest of 4/2/1 that does).  RNG streams are
    keyed by (pixel, sample, bounce), so results match the unmerged renderer
    up to fp accumulation order.

    Returns (image (H, W, 3) linear, albedo (H, W, 3), normal (H, W, 3)).
    """
    if intersector is None:
        intersector = _default_intersector()
    npix = width * height
    pixel_id = jnp.arange(npix, dtype=jnp.int32)
    S = samples_per_wave or _default_samples_per_wave(spp)
    if spp % S:
        raise ValueError(f"samples_per_wave={S} must divide spp={spp}")
    pix_rep = jnp.tile(pixel_id, S)                      # (S*npix,)

    def sample_step(acc, s0):
        s_vec = s0 + jnp.arange(S, dtype=jnp.int32)      # (S,)
        samp = jnp.repeat(s_vec, npix)                   # (S*npix,)
        if jitter:
            u1, u2 = rng.stratified_jitter(pix_rep, samp, seed, sampler)
            jit_uv = jnp.stack([u1, u2], -1).reshape(S, height, width, 2)
        else:
            # pixel centers for every sample (reference parity)
            jit_uv = jnp.full((S, height, width, 2), 0.5, jnp.float32)
        lens = None
        if float(camera.aperture) > 0.0:   # static: pruned for pinhole
            lens = rng.random_in_unit_disk(
                pix_rep, samp, jnp.int32(-2), seed ^ _DIM_LENS,
                sampler).reshape(S, height, width, 2)
        o, d = camera.generate_rays(width, height, jit_uv,
                                    lens_uv=lens)   # (S, H, W, 3)
        out = trace(
            scene, materials, o.reshape(-1, 3), d.reshape(-1, 3),
            pix_rep, samp, seed, background, max_depth, intersector, env,
            want_aux=want_aux, sampler=sampler)
        radiance, albedo_g, normal_g = out[:3]
        nxt = (acc[0] + radiance.reshape(S, npix, 3).sum(0),
               acc[1] + albedo_g.reshape(S, npix, 3).sum(0),
               acc[2] + normal_g.reshape(S, npix, 3).sum(0))
        if want_aux:
            # depth/prim buffers from sample 0 only (jitter variance in
            # the aux taps is irrelevant to reprojection validity tests)
            t_g, prim_g = out[3]
            keep = s0 == 0
            nxt += (jnp.where(keep, t_g[:npix], acc[3]),
                    jnp.where(keep, prim_g[:npix], acc[4]))
        return nxt, None

    zeros = jnp.zeros((npix, 3), jnp.float32)
    init = (zeros, zeros, zeros)
    if want_aux:
        init += (jnp.full((npix,), INF, jnp.float32),
                 jnp.full((npix,), -1, jnp.int32))
    acc, _ = jax.lax.scan(
        sample_step, init,
        jnp.arange(0, spp, S, dtype=jnp.int32)
        + jnp.asarray(sample_offset, jnp.int32))
    rad, alb, nrm = acc[:3]
    inv = 1.0 / spp
    outs = (rad.reshape(height, width, 3) * inv,
            alb.reshape(height, width, 3) * inv,
            nrm.reshape(height, width, 3) * inv)
    if want_aux:
        return outs + ((acc[3].reshape(height, width),
                        acc[4].reshape(height, width)),)
    return outs
