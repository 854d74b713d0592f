"""Path tracer with next-event estimation + multiple importance sampling.

This is the extension integrator for the BASELINE benchmark configs (Cornell
Box area-light NEE+MIS; Sponza-class scenes) — capability the reference
renderer does not have (its tracer is background-lit Whitted,
shader/Shader.cu).  Same wavefront architecture as ``render/wavefront.py``:
``lax.scan`` over bounces, SoA state, masked shading; per bounce it adds a
shadow-ray wave (counted in the rays/sec benchmarks).

Estimator (balance-heuristic MIS):
  * emitted radiance on BSDF hits, weighted by w_bsdf = p_bsdf/(p_bsdf+p_nee)
    (full weight on the camera ray and after specular bounces),
  * NEE: one area-light sample per diffuse bounce, weighted by
    w_nee = p_nee/(p_nee+p_bsdf).

Diffuse bounces use cosine-weighted hemisphere sampling; METAL/DIELECTRIC
are delta lobes (no NEE, no MIS at their vertices) like the classic
smallpt/PBRT treatment of perfect mirrors/glass.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.ops import intersect as isect
from optix_ray_tracer_tpu.scene.geometry import Scene
from optix_ray_tracer_tpu.scene.lights import AreaLights, sample_lights
from optix_ray_tracer_tpu.scene.materials import (
    DIELECTRIC, EMISSIVE, METAL, ROUGH, MaterialTable,
)
from optix_ray_tracer_tpu.utils import rng
from optix_ray_tracer_tpu.utils.vecmath import (
    INF, PI, dot, normalize, reflect, refract, schlick_fresnel,
)

_DIM_BSDF = 0x3C6EF372
_DIM_LIGHT = 0x27220A95
_DIM_LOBE = 0x165667B1
_DIM_RR = 0x2545F491
_DIM_LENS = 0x68E31DA4
_DIM_ENV = 0x4F6CDD1D


def _onb(n):
    """Orthonormal basis about unit normal n (branchless Frisvad/Duff)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + s * n[..., 0] * n[..., 0] * a,
                   s * b,
                   -s * n[..., 0]], axis=-1)
    bt = jnp.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def _cosine_sample(n, pixel_id, sample, bounce, seed, mode="pcg"):
    local = rng.random_cosine_direction(pixel_id, sample, bounce, seed,
                                        mode)
    t, bt = _onb(n)
    d = (local[..., 0:1] * t + local[..., 1:2] * bt + local[..., 2:3] * n)
    pdf = jnp.maximum(local[..., 2], 1e-6) / PI
    return normalize(d), pdf


@partial(jax.jit, static_argnames=("max_depth", "rr_start", "want_aux",
                                   "sampler", "restir_direct"))
def trace_path(scene: Scene, materials: MaterialTable, lights: AreaLights,
               origins, directions, pixel_id, sample, seed, background,
               max_depth: int = 8, intersector=None, env=None,
               textures=None, rr_start: int = 3, clamp: float = 0.0,
               want_aux: bool = False, sampler: str = "pcg",
               restir_direct: bool = False, first_hit=None):
    """Trace a wavefront with NEE+MIS.  Returns (radiance, albedo_g, normal_g);
    with ``want_aux`` also (t (R,), prim_id (R,) int32) of the PRIMARY hit
    (INF / -1 on miss or sphere hit) — the depth/id buffers the temporal
    reprojector consumes (render/temporal.py), same contract as
    wavefront.trace.

    ``lights`` may be None (falls back to BSDF sampling only).
    ``rr_start``: bounce index where Russian roulette begins (unbiased;
    pass >= max_depth to disable).
    ``clamp``: if > 0, cap each INDIRECT per-bounce radiance contribution
    (bounce >= 1) at this value per channel — the standard biased firefly
    suppressor; direct light and camera-visible emitters are never clamped.

    ``restir_direct``: the primary vertex's AREA-LIGHT direct lighting is
    estimated by a ReSTIR reservoir pass instead (render/restir.py
    ``render_restir_gi``), so this trace contributes only what ReSTIR does
    not: it drops the bounce-0 miss/emitter radiance (ReSTIR's ``base``),
    the bounce-0 area-light NEE, and — because a BSDF ray from a DIFFUSE
    primary that lands on an emitter at bounce 1 samples that same direct
    integral — emitter hits at bounce 1 from diffuse primaries.  Delta
    primaries (metal/dielectric) keep their bounce-1 emitter hits (ReSTIR
    resamples only diffuse vertices), and the bounce-0 env NEE stays (the
    reservoir target excludes the environment).  The partition is exact,
    so ReSTIR direct + this trace is unbiased.  ``first_hit``: optional
    precomputed bounce-0 Hit (the ReSTIR pipeline already traced the
    camera wave; don't pay it twice).
    """
    if intersector is None:
        from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
        intersector = BruteForceIntersector()
    nrays = origins.shape[0]
    background = jnp.asarray(background, jnp.float32)
    have_lights = lights is not None and lights.count > 0
    # env NEE: importance-sample the environment at diffuse vertices when
    # the map carries sampling tables (factory-built maps always do) —
    # MIS'd against the cosine lobe, symmetric to the area-light NEE
    have_env_nee = env is not None and env.can_sample

    state = dict(
        o=origins, d=directions,
        throughput=jnp.ones((nrays, 3), jnp.float32),
        radiance=jnp.zeros((nrays, 3), jnp.float32),
        alive=jnp.ones((nrays,), bool),
        # pdf of the BSDF sample that produced the current ray
        # (<=0 -> delta lobe or camera ray: emitters get full weight)
        prev_pdf=jnp.zeros((nrays,), jnp.float32),
        albedo_g=jnp.zeros((nrays, 3), jnp.float32),
        normal_g=jnp.zeros((nrays, 3), jnp.float32))
    if want_aux:
        state["t_g"] = jnp.full((nrays,), INF, jnp.float32)
        state["prim_g"] = jnp.full((nrays,), -1, jnp.int32)
    if restir_direct:
        # was THIS lane's primary vertex diffuse? (drives the bounce-1
        # emitter-hit drop — see the docstring's partition argument)
        state["prim_diff"] = jnp.zeros((nrays,), bool)

    def bounce_step(s, b, ext_hit=None):
        alive = s["alive"]
        # dead lanes trace with t_max=0: the traversal kernel retires them
        # before their first node fetch
        if ext_hit is not None:
            hit = ext_hit
        else:
            hit = intersector.intersect(
                scene, s["o"], s["d"], t_max=jnp.where(alive, INF, 0.0))
        missed = alive & ~hit.is_hit
        if restir_direct:
            # bounce-0 miss radiance lives in ReSTIR's base image
            missed = missed & (b >= 1)
        hit_alive = alive & hit.is_hit

        def _cap(contrib):
            """Firefly clamp for indirect bounces only (clamp is traced:
            0 disables)."""
            return jnp.where((b >= 1) & (clamp > 0.0),
                             jnp.minimum(contrib, clamp), contrib)

        miss_radiance = env.sample(s["d"]) if env is not None else background
        if have_env_nee:
            # MIS counterpart of the env NEE below: a BSDF ray that
            # escapes is down-weighted by the env-sampling pdf of its
            # direction (prev_pdf <= 0 = delta lobe / camera ray: the env
            # could not have been NEE-sampled, full weight)
            env_pdf_here = env.pdf_solid_angle(s["d"])
            w_miss = jnp.where(
                s["prev_pdf"] > 0.0,
                s["prev_pdf"] / jnp.maximum(s["prev_pdf"] + env_pdf_here,
                                            1e-12),
                1.0)[..., None]
        else:
            w_miss = 1.0
        radiance = s["radiance"] + _cap(jnp.where(
            missed[..., None], s["throughput"] * miss_radiance * w_miss,
            0.0))

        point, normal, front_face, material_id = isect.shading_frame(
            scene, s["o"], s["d"], hit)
        n_unit = normalize(normal)
        mtype, albedo, param, emission = materials.gather(material_id)
        if textures is not None:
            uv = isect.interpolate_uv(scene, hit)
            albedo = albedo * textures.sample(material_id, uv)

        # ---- emitted light at BSDF hits, MIS-weighted -------------------
        is_emitter = hit_alive & (mtype == EMISSIVE)
        if have_lights:
            from optix_ray_tracer_tpu.scene.lights import light_pdf_solid_angle
            nee_pdf_here = light_pdf_solid_angle(
                lights, hit.prim_id, hit.prim_type == isect.PRIM_TRIANGLE,
                s["d"], hit.t)
            w_bsdf = jnp.where(
                s["prev_pdf"] > 0.0,
                s["prev_pdf"] / jnp.maximum(s["prev_pdf"] + nee_pdf_here, 1e-12),
                1.0)
        else:
            w_bsdf = jnp.ones((nrays,), jnp.float32)
        emit_vis = is_emitter
        if restir_direct:
            # bounce-0 emitters are in ReSTIR's base; bounce-1 emitter
            # hits from a DIFFUSE primary are the direct integral ReSTIR
            # already estimates
            emit_vis = is_emitter & (b >= 1) \
                & ~(s["prim_diff"] & (b == 1))
        radiance = radiance + _cap(jnp.where(
            emit_vis[..., None],
            s["throughput"] * emission * w_bsdf[..., None], 0.0))

        # guide buffers
        first = hit_alive & (b == 0)
        albedo_g = jnp.where(first[..., None],
                             jnp.where((mtype == EMISSIVE)[..., None],
                                       emission, albedo),
                             s["albedo_g"])
        normal_g = jnp.where(first[..., None], n_unit, s["normal_g"])
        aux = {}
        if want_aux:
            # primary-hit depth + TRIANGLE id (-1 for miss/sphere hits:
            # spheres are static extras, reprojection treats them static)
            aux["t_g"] = jnp.where(first, hit.t, s["t_g"])
            aux["prim_g"] = jnp.where(
                first & (hit.prim_type == isect.PRIM_TRIANGLE),
                hit.prim_id, s["prim_g"])

        is_diffuse = mtype == ROUGH
        shading_alive = hit_alive & ~is_emitter
        extra = {}
        if restir_direct:
            extra["prim_diff"] = jnp.where(b == 0, hit_alive & is_diffuse,
                                           s["prim_diff"])

        # ---- NEE: one light sample at diffuse vertices ------------------
        if have_lights:
            wl, dist, pdf_l, emitted, _ = sample_lights(
                lights, point, pixel_id, sample, b, seed ^ _DIM_LIGHT,
                mode=sampler)
            cos_s = dot(wl, n_unit)
            valid = shading_alive & is_diffuse & (cos_s > 0.0) & (pdf_l > 0.0)
            if restir_direct:
                # the reservoir pass owns bounce-0 area-light NEE; the
                # masked-out shadow ray traces with t_max=0 (free)
                valid = valid & (b >= 1)
            # shadow ray (offset along the light direction; end before light)
            occluded = intersector.any_hit(
                scene, point + n_unit * 1e-3, wl,
                t_min=1e-4, t_max=jnp.where(valid, dist - 2e-3, 0.0))
            visible = valid & ~occluded
            f = albedo / PI                               # Lambertian BRDF
            pdf_bsdf_for_light = jnp.maximum(cos_s, 0.0) / PI
            w_nee = pdf_l / jnp.maximum(pdf_l + pdf_bsdf_for_light, 1e-12)
            contrib = (s["throughput"] * f * emitted
                       * (jnp.maximum(cos_s, 0.0) / jnp.maximum(pdf_l, 1e-12)
                          * w_nee)[..., None])
            radiance = radiance + _cap(
                jnp.where(visible[..., None], contrib, 0.0))

        # ---- NEE: one environment sample at diffuse vertices ------------
        if have_env_nee:
            # dims 0/1 (the strict Sobol pair) drive the two-level texel
            # pick; dims 2/3 are sub-texel jitter
            ub, ut, uj, vj = rng.uniform4(pixel_id, sample, b,
                                          seed ^ _DIM_ENV, sampler)
            we, pdf_e = env.sample_direction(ub, ut, uj, vj)
            cos_e = dot(we, n_unit)
            valid_e = shading_alive & is_diffuse & (cos_e > 0.0) \
                & (pdf_e > 0.0)
            # occlusion to infinity (the env is behind everything)
            occ_e = intersector.any_hit(
                scene, point + n_unit * 1e-3, we,
                t_min=1e-4, t_max=jnp.where(valid_e, INF, 0.0))
            vis_e = valid_e & ~occ_e
            le = env.sample(we)
            f_e = albedo / PI
            pdf_bsdf_for_env = jnp.maximum(cos_e, 0.0) / PI
            w_env = pdf_e / jnp.maximum(pdf_e + pdf_bsdf_for_env, 1e-12)
            contrib_e = (s["throughput"] * f_e * le
                         * (jnp.maximum(cos_e, 0.0)
                            / jnp.maximum(pdf_e, 1e-12) * w_env)[..., None])
            radiance = radiance + _cap(
                jnp.where(vis_e[..., None], contrib_e, 0.0))

        # ---- BSDF sampling ----------------------------------------------
        # diffuse: cosine hemisphere
        d_diff, pdf_diff = _cosine_sample(n_unit, pixel_id, sample, b,
                                          seed ^ _DIM_BSDF, sampler)
        # metal: mirror + fuzz
        fuzz_vec = rng.random_unit_vector(pixel_id, sample, b,
                                          seed ^ _DIM_LOBE, sampler)
        d_metal = normalize(normalize(reflect(s["d"], n_unit))
                            + param[..., None] * fuzz_vec)
        # dielectric
        ior = jnp.where(param > 0.0, param, 1.5)
        eta = jnp.where(front_face, 1.0 / ior, ior)
        cos_theta = jnp.minimum(-dot(s["d"], n_unit), 1.0)
        sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta ** 2))
        cannot = eta * sin_theta > 1.0
        u_fr = rng.uniform4(pixel_id, sample, b, seed ^ _DIM_LOBE,
                            sampler)[1]
        do_reflect = cannot | (schlick_fresnel(cos_theta, ior) > u_fr)
        d_diel = jnp.where(do_reflect[..., None],
                           normalize(reflect(s["d"], n_unit)),
                           refract(s["d"], n_unit, eta[..., None]))

        is_metal = (mtype == METAL)[..., None]
        is_diel = (mtype == DIELECTRIC)[..., None]
        new_dir = jnp.where(is_diel, d_diel,
                            jnp.where(is_metal, d_metal, d_diff))
        new_dir = normalize(new_dir)

        # throughput: diffuse = albedo * cos / pdf = albedo (cosine sampling
        # cancels); delta lobes multiply albedo (metal) or 1 (dielectric)
        atten = jnp.where(is_diel, 1.0,
                          jnp.where(is_metal, albedo, albedo))
        prev_pdf = jnp.where(is_diffuse, pdf_diff, 0.0)  # delta -> 0

        throughput = jnp.where(shading_alive[..., None],
                               s["throughput"] * atten, s["throughput"])

        # ---- Russian roulette (unbiased path termination) ----------------
        # From bounce rr_start on, continue with p = max-channel throughput
        # (floored so dark paths still terminate in finite expectation) and
        # compensate survivors by 1/p.  Killed lanes trace with t_max=0 next
        # bounce, which the traversal kernel retires at once.
        if rr_start < max_depth:
            u_rr = rng.uniform4(pixel_id, sample, b, seed ^ _DIM_RR,
                                sampler)[0]
            p_cont = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
            do_rr = shading_alive & (b >= rr_start)
            survive = ~do_rr | (u_rr < p_cont)
            throughput = jnp.where(
                do_rr[..., None], throughput / p_cont[..., None], throughput)
            shading_alive = shading_alive & survive

        o = jnp.where(shading_alive[..., None],
                      point + n_unit * jnp.where(
                          is_diel[..., 0] & ~do_reflect, -1e-3, 1e-3)[..., None],
                      s["o"])
        d = jnp.where(shading_alive[..., None], new_dir, s["d"])

        return dict(o=o, d=d, throughput=throughput, radiance=radiance,
                    alive=shading_alive, prev_pdf=prev_pdf,
                    albedo_g=albedo_g, normal_g=normal_g, **aux,
                    **extra), None

    # bounce 0 unrolled: it may take a precomputed camera-wave hit
    state, _ = bounce_step(state, jnp.int32(0), ext_hit=first_hit)
    if max_depth > 1:
        state, _ = jax.lax.scan(bounce_step, state,
                                jnp.arange(1, max_depth, dtype=jnp.int32))
    if want_aux:
        return (state["radiance"], state["albedo_g"], state["normal_g"],
                (state["t_g"], state["prim_g"]))
    return state["radiance"], state["albedo_g"], state["normal_g"]


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "max_depth", "jitter",
                          "rr_start", "samples_per_wave", "want_aux",
                          "sampler"))
def render_path(scene: Scene, materials: MaterialTable, lights, camera,
                width: int, height: int, spp: int = 16, seed: int = 0,
                background=(0.0, 0.0, 0.0), max_depth: int = 8,
                intersector=None, env=None, textures=None,
                jitter: bool = True, rr_start: int = 3, clamp: float = 0.0,
                samples_per_wave: int | None = None,
                want_aux: bool = False, sampler: str = "pcg",
                sample_offset=0):
    """Full-frame path trace; same conventions as wavefront.render,
    including the samples-per-wave merge (RNG streams are (pixel, sample,
    bounce)-keyed, so merging is exact); the default is S=1.

    ``want_aux``: also return (t, prim) primary-hit buffers from sample 0
    (the temporal reprojector's depth/id taps, as in wavefront.render)."""
    npix = width * height
    pixel_id = jnp.arange(npix, dtype=jnp.int32)
    S = samples_per_wave or 1
    if spp % S:
        raise ValueError(f"samples_per_wave={S} must divide spp={spp}")
    pix_rep = jnp.tile(pixel_id, S)

    def sample_step(acc, s0):
        s_vec = s0 + jnp.arange(S, dtype=jnp.int32)
        samp = jnp.repeat(s_vec, npix)
        if jitter:
            u1, u2 = rng.stratified_jitter(pix_rep, samp, seed,
                                           sampler)
            jit_uv = jnp.stack([u1, u2], -1).reshape(S, height, width, 2)
        else:
            jit_uv = jnp.full((S, height, width, 2), 0.5, jnp.float32)
        lens = None
        if float(camera.aperture) > 0.0:   # static: pruned for pinhole
            lens = rng.random_in_unit_disk(
                pix_rep, samp, jnp.int32(-2), seed ^ _DIM_LENS,
                sampler).reshape(S, height, width, 2)
        o, d = camera.generate_rays(width, height, jit_uv,
                                    lens_uv=lens)   # (S, H, W, 3)
        out = trace_path(
            scene, materials, lights, o.reshape(-1, 3), d.reshape(-1, 3),
            pix_rep, samp, seed, background, max_depth, intersector, env,
            textures, rr_start, clamp, want_aux=want_aux, sampler=sampler)
        radiance, alb, nrm = out[:3]
        nxt = (acc[0] + radiance.reshape(S, npix, 3).sum(0),
               acc[1] + alb.reshape(S, npix, 3).sum(0),
               acc[2] + nrm.reshape(S, npix, 3).sum(0))
        if want_aux:
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
    # sample_offset (traced): progressive batches continue the GLOBAL
    # sample counter, so jitter strata and Sobol sequences accumulate as
    # one long stream across checkpoint/resume instead of restarting
    acc, _ = jax.lax.scan(
        sample_step, init,
        jnp.arange(0, spp, S, dtype=jnp.int32)
        + jnp.asarray(sample_offset, jnp.int32))
    inv = 1.0 / spp
    outs = (acc[0].reshape(height, width, 3) * inv,
            acc[1].reshape(height, width, 3) * inv,
            acc[2].reshape(height, width, 3) * inv)
    if want_aux:
        return outs + ((acc[3].reshape(height, width),
                        acc[4].reshape(height, width)),)
    return outs
