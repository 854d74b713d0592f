"""ReSTIR DI — reservoir-based spatiotemporal importance resampling for
direct lighting (weighted reservoir RIS, Bitterli et al. 2020).

Reference analog: none — the reference's only light transport is the
background-lit Whitted tracer (``shader/Shader.cu:276-287``); this module
extends the path-tracing side (``scene/lights.py`` NEE).  Why it matters
here: incoherent shadow rays are the costliest wave, so
equal-quality-for-fewer-shadow-rays is a lever.  ReSTIR keeps exactly ONE
shadow ray per pixel per frame while raising the EFFECTIVE light-sample
count to ``M x history x spatial taps`` — and every one of those extra
samples is pure elementwise arithmetic (no rays, no big gathers).

Design:

* candidate generation is a ``lax.scan`` over M light samples — all
  elementwise math on (H*W,) lanes; the only gathers index the small
  (L,)-row light table;
* reservoirs are SoA image arrays ``(li, u2, u3, W, m)`` carried across
  frames exactly like the SVGF temporal state (``render/temporal.py``);
* temporal reuse reprojects hit points with the same closed-form camera
  math as ``temporal.project_to_pixels``; spatial reuse is a fixed small
  number of neighbor gathers;
* every random stream is counter-RNG keyed by (pixel, frame, candidate)
  — deterministic replay and shard-safety, like every other integrator.

Bias contract: candidate RIS with the final visibility ray is unbiased
(the target function excludes visibility).  Temporal/spatial reuse
re-evaluates the target at the destination surface and rejects dissimilar
history (depth/normal tests) — the standard "biased ReSTIR" variant whose
residual error is bounded by the rejection tolerances.
``tests/test_restir.py`` measures both the mean drift and the
equal-shadow-ray-budget RMSE win against plain power-weighted NEE.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.ops import intersect as isect
from optix_ray_tracer_tpu.scene.geometry import Scene
from optix_ray_tracer_tpu.scene.lights import AreaLights
from optix_ray_tracer_tpu.scene.materials import (
    EMISSIVE, ROUGH, MaterialTable,
)
from optix_ray_tracer_tpu.utils import rng
from optix_ray_tracer_tpu.utils.color import luminance
from optix_ray_tracer_tpu.utils.vecmath import (
    INF, PI, dot, length_squared, normalize,
)

_DIM_CAND = 0x5851F42D
_DIM_PICK = 0x14057B7E
_DIM_REUSE = 0x61C88647
# seed salt for the GI continuation trace (decorrelates the path
# tracer's (pixel, frame, bounce) streams from the reservoir streams)
_DIM_GI = 0x2545F491

# temporal history cap, in multiples of M candidates: bounds how much the
# (slightly stale) history can outweigh fresh candidates — same role as
# HISTORY_CAP in render/temporal.py
M_CAP = 20.0
# reuse similarity tolerances (SVGF-style)
DEPTH_TOL = 0.05
NORMAL_MIN = 0.9


def empty_reservoir_state(width: int, height: int) -> dict:
    """Initial (no-history) reservoir state: one reservoir per pixel plus
    the G-buffer taps (depth, normal) that validate reuse."""
    z = jnp.zeros((height, width), jnp.float32)
    return dict(
        li=jnp.zeros((height, width), jnp.int32),
        u2=z, u3=z, W=z, m=z,
        t=jnp.full((height, width), INF, jnp.float32),
        normal=jnp.zeros((height, width, 3), jnp.float32),
    )


# below this light count, per-candidate table rows come from a one-hot
# matmul instead of a row gather (not yet measured against a plain gather
# on the GPU; ROADMAP.md), and either way the SIX per-field gathers
# consolidate into ONE row lookup
DENSE_LOOKUP_MAX = 128


def _pack_lights(lights: AreaLights):
    """(L, 16) row-packed light table: v0|e1|e2|normal|emission|pdf_scale.
    One lookup per candidate replaces six per-field gathers."""
    return jnp.concatenate(
        [lights.v0, lights.e1, lights.e2, lights.normal, lights.emission,
         lights.pdf_scale[:, None]], axis=1)


def _lookup(packed, li):
    """Row(s) ``li`` of the packed table — one-hot matmul for small
    tables, single gather otherwise."""
    L = packed.shape[0]
    if L <= DENSE_LOOKUP_MAX:
        oh = (li[..., None] == jnp.arange(L, dtype=li.dtype)
              ).astype(packed.dtype)
        return oh @ packed
    return packed[li]


def _sample_point_row(row, u2, u3):
    """Reconstruct the stored light sample from its packed table row:
    point + emitted + normal.  (li, u2, u3) is the portable encoding —
    re-evaluable at ANY pixel."""
    su = jnp.sqrt(jnp.maximum(u2, 1e-12))[..., None]
    b1 = 1.0 - su
    b2 = u3[..., None] * su
    y = row[..., 0:3] + b1 * row[..., 3:6] + b2 * row[..., 6:9]
    return y, row[..., 12:15], row[..., 9:12]


def _phat_row(row, u2, u3, point, n_unit, albedo):
    """Target function of a stored sample at a shading point, in AREA
    measure: phat = luminance(f * Le * cos_s * |cos_l| / d^2).

    Returns (phat, rgb contribution, direction, distance) — rgb is the
    full integrand so ``shade`` only multiplies by W and visibility.
    """
    y, le, ln = _sample_point_row(row, u2, u3)
    to = y - point
    d2 = length_squared(to)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
    w = to / dist[..., None]
    cos_s = jnp.maximum(dot(w, n_unit), 0.0)
    cos_l = jnp.abs(dot(w, ln))
    g = cos_s * cos_l / jnp.maximum(d2, 1e-12)
    rgb = (albedo / PI) * le * g[..., None]
    return luminance(rgb), rgb, w, dist


def _initial_candidates(lights: AreaLights, packed, point, n_unit, albedo,
                        active, pixel_id, frame, seed, m_candidates: int,
                        sampler: str = "pcg"):
    """Streaming weighted-reservoir sampling over M CDF-drawn candidates.

    Returns (li, u2, u3, wsum) of the winning sample; candidate pdfs are
    in area measure (``lights.pdf_scale`` = P(select)/area, packed col
    15), matching ``_phat_row``'s measure, so w_i = phat_i / p_i needs no
    solid-angle conversion.
    """
    nl = lights.count
    cdf = lights.cdf

    def step(carry, ci):
        y_li, y_u2, y_u3, wsum = carry
        u1, u2, u3, u4 = rng.uniform4(pixel_id, frame, ci,
                                      seed ^ _DIM_CAND, sampler)
        if nl <= DENSE_LOOKUP_MAX:
            # dense searchsorted: a (R, L) compare + row-sum beats the
            # gather-based binary search at small L (same regime as the
            # one-hot lookup)
            li = jnp.sum(u1[..., None] > cdf, axis=-1).astype(jnp.int32)
        else:
            li = jnp.searchsorted(cdf, u1).astype(jnp.int32)
        li = jnp.clip(li, 0, nl - 1)
        row = _lookup(packed, li)
        phat, _, _, _ = _phat_row(row, u2, u3, point, n_unit, albedo)
        p = row[..., 15]
        w = jnp.where(active & (p > 0.0), phat / jnp.maximum(p, 1e-30), 0.0)
        new_wsum = wsum + w
        take = u4 * jnp.maximum(new_wsum, 1e-30) < w
        return (jnp.where(take, li, y_li), jnp.where(take, u2, y_u2),
                jnp.where(take, u3, y_u3), new_wsum), None

    z = jnp.zeros_like(point[..., 0])
    init = (jnp.zeros(point.shape[:-1], jnp.int32), z, z, z)
    (li, u2, u3, wsum), _ = jax.lax.scan(
        step, init, jnp.arange(m_candidates, dtype=jnp.int32))
    return li, u2, u3, wsum


def _finalize_w(packed, li, u2, u3, wsum, m, point, n_unit, albedo):
    """Contribution weight W = wsum / (m * phat(y)) — the RIS estimator's
    1/pdf proxy for the winning sample."""
    phat, _, _, _ = _phat_row(_lookup(packed, li), u2, u3, point, n_unit,
                              albedo)
    ok = (phat > 0.0) & (m > 0.0)
    return jnp.where(ok, wsum / jnp.maximum(m * phat, 1e-30), 0.0)


def _combine(packed, dst, srcs, point, n_unit, albedo, pixel_id, frame,
             seed, sampler="pcg"):
    """Merge reservoirs at the DESTINATION pixel (Bitterli Alg. 4).

    ``dst``/each ``src``: (li, u2, u3, W, m, valid).  Every source sample
    is re-weighted by the destination's target function — that is what
    makes a neighbor's (or last frame's) winner usable here.
    """
    d_li, d_u2, d_u3, d_W, d_m, d_valid = dst
    phat_d, _, _, _ = _phat_row(_lookup(packed, d_li), d_u2, d_u3, point,
                                n_unit, albedo)
    wsum = jnp.where(d_valid, phat_d * d_W * d_m, 0.0)
    m_tot = jnp.where(d_valid, d_m, 0.0)
    y_li, y_u2, y_u3 = d_li, d_u2, d_u3
    for tap, (s_li, s_u2, s_u3, s_W, s_m, s_valid) in enumerate(srcs):
        phat_s, _, _, _ = _phat_row(_lookup(packed, s_li), s_u2, s_u3,
                                    point, n_unit, albedo)
        w = jnp.where(s_valid, phat_s * s_W * s_m, 0.0)
        wsum = wsum + w
        u = rng.uniform4(pixel_id, frame, jnp.int32(tap),
                         seed ^ _DIM_PICK, sampler)[0]
        take = u * jnp.maximum(wsum, 1e-30) < w
        y_li = jnp.where(take, s_li, y_li)
        y_u2 = jnp.where(take, s_u2, y_u2)
        y_u3 = jnp.where(take, s_u3, y_u3)
        m_tot = m_tot + jnp.where(s_valid, s_m, 0.0)
    W = _finalize_w(packed, y_li, y_u2, y_u3, wsum, m_tot, point, n_unit,
                    albedo)
    return y_li, y_u2, y_u3, W, m_tot


def _gather2(img, iy, ix):
    h, w = img.shape[:2]
    flat = img.reshape(h * w, -1)
    idx = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
    out = flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))
    return out[..., 0] if img.ndim == 2 else out


@partial(jax.jit, static_argnames=("width", "height", "m_candidates",
                                   "spatial_taps", "spatial_radius",
                                   "sampler"))
def render_restir(scene: Scene, materials: MaterialTable,
                  lights: AreaLights, camera, width: int, height: int,
                  seed, frame=0, state: dict | None = None,
                  prev_camera=None, m_candidates: int = 16,
                  spatial_taps: int = 2, spatial_radius: int = 16,
                  intersector=None, background=(0.0, 0.0, 0.0), env=None,
                  textures=None, sampler: str = "pcg"):
    """One ReSTIR DI frame: direct lighting at diffuse primary hits, plus
    camera-visible emitters and the background/env on miss.

    Exactly one primary ray and one shadow ray per pixel; the effective
    light-sample count is ``m_candidates`` x temporal history (capped at
    ``M_CAP x m_candidates``) x ``spatial_taps``.  Indirect bounces are
    out of scope by design — compose with the path tracer for GI.

    ``state``: previous frame's reservoir state (``empty_reservoir_state``
    or the previous call's return) for temporal reuse; None disables it.
    ``prev_camera``: camera of the PREVIOUS frame (defaults to ``camera``)
    — reprojection handles camera motion in closed form; moving geometry
    is rejected by the depth/normal tests rather than tracked.

    Returns ``(img (H, W, 3), albedo_g, normal_g, new_state)``.
    """
    if lights is None or lights.count == 0:
        raise ValueError("render_restir needs a non-empty light table")
    if intersector is None:
        from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
        intersector = BruteForceIntersector()
    background = jnp.asarray(background, jnp.float32)
    frame = jnp.asarray(frame, jnp.int32)

    npix = width * height
    o, d = camera.generate_rays(width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    hit = intersector.intersect(scene, o, d, t_max=jnp.full((npix,), INF))

    point, n_unit, albedo, active, base, albedo_g, normal_g = _gbuffer(
        scene, materials, o, d, hit, textures, env, background)

    packed = _pack_lights(lights)
    li2, u22, u32, W2, m2, act2, t2, n2 = _resample(
        lights, packed, point, n_unit, albedo, active, hit.t, width,
        height, frame, seed, state, camera, prev_camera, m_candidates,
        spatial_taps, spatial_radius, sampler)

    # ---- shade the winner: ONE shadow ray per pixel ------------------------
    rgb, wdir, dist, live, Wf = _shade_terms(packed, li2, u22, u32, W2,
                                             point, n_unit, albedo, active)
    occluded = intersector.any_hit(
        scene, point + n_unit * 1e-3, wdir,
        t_min=1e-4, t_max=jnp.where(live, dist - 2e-3, 0.0))
    return _compose(base, rgb, Wf, live, occluded, li2, u22, u32, m2,
                    act2, t2, n2, albedo_g, normal_g, width, height)


def _gbuffer(scene, materials, o, d, hit, textures, env, background):
    """Shading inputs at the primary hits — pure lane math + table
    gathers, no rays.  Shared by :func:`render_restir` and the sharded
    path (``parallel.sharding.render_restir_sharded``)."""
    point, normal, _, material_id = isect.shading_frame(scene, o, d, hit)
    n_unit = normalize(normal)
    mtype, albedo, _, emission = materials.gather(material_id)
    if textures is not None:
        uv = isect.interpolate_uv(scene, hit)
        albedo = albedo * textures.sample(material_id, uv)

    miss_rgb = env.sample(d) if env is not None else background
    is_emitter = hit.is_hit & (mtype == EMISSIVE)
    base = jnp.where(~hit.is_hit[..., None], miss_rgb,
                     jnp.where(is_emitter[..., None], emission, 0.0))
    active = hit.is_hit & (mtype == ROUGH)

    albedo_g = jnp.where(hit.is_hit[..., None],
                         jnp.where(is_emitter[..., None], emission, albedo),
                         0.0)
    normal_g = jnp.where(hit.is_hit[..., None], n_unit, 0.0)
    return point, n_unit, albedo, active, base, albedo_g, normal_g


def _resample(lights, packed, point, n_unit, albedo, active, t, width,
              height, frame, seed, state, camera, prev_camera,
              m_candidates, spatial_taps, spatial_radius, sampler):
    """Initial candidates + temporal/spatial reuse + combine — everything
    between the G-buffer and the winner's shadow ray.  Pure lane math and
    small image gathers (no rays), so the sharded path runs it as ONE
    global program and lets GSPMD partition it.

    Returns image-shaped winner grids ``(li2, u22, u32, W2, m2)`` plus
    the validation taps ``(act2, t2, n2)`` the new state needs.
    """
    pixel_id = jnp.arange(width * height, dtype=jnp.int32)
    # ---- initial candidates (RIS) -----------------------------------------
    li, u2, u3, wsum = _initial_candidates(
        lights, packed, point, n_unit, albedo, active, pixel_id, frame,
        seed, m_candidates, sampler)
    m = jnp.where(active, jnp.float32(m_candidates), 0.0)
    W = _finalize_w(packed, li, u2, u3, wsum, m, point, n_unit, albedo)

    # image-shaped views for the reuse passes
    def im(x):
        return x.reshape((height, width) + x.shape[1:])

    li2, u22, u32, W2, m2 = im(li), im(u2), im(u3), im(W), im(m)
    point2, n2, alb2 = im(point), im(n_unit), im(albedo)
    t2, act2 = im(t), im(active)
    pid2 = im(pixel_id)

    srcs = []
    # ---- temporal reuse ----------------------------------------------------
    if state is not None:
        pc = camera if prev_camera is None else prev_camera
        from optix_ray_tracer_tpu.render.temporal import project_to_pixels
        px, py, in_front = project_to_pixels(pc, point2, width, height)
        ix = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1)
        iy = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1)
        inb = (px > -0.5) & (px < width - 0.5) & (py > -0.5) \
            & (py < height - 0.5)
        p_li = _gather2(state["li"], iy, ix)
        p_u2 = _gather2(state["u2"], iy, ix)
        p_u3 = _gather2(state["u3"], iy, ix)
        p_W = _gather2(state["W"], iy, ix)
        p_m = jnp.minimum(_gather2(state["m"], iy, ix),
                          M_CAP * m_candidates)
        p_t = _gather2(state["t"], iy, ix)
        p_n = _gather2(state["normal"], iy, ix)
        prev_dist = jnp.linalg.norm(point2 - pc.center, axis=-1)
        same = (jnp.abs(p_t - prev_dist)
                <= DEPTH_TOL * jnp.maximum(prev_dist, 1e-3)) \
            & (jnp.sum(p_n * n2, -1) > NORMAL_MIN)
        valid = act2 & in_front & inb & same & (p_m > 0.0)
        srcs.append((p_li, p_u2, p_u3, p_W, p_m, valid))

    # ---- spatial reuse -----------------------------------------------------
    for tap in range(spatial_taps):
        ua, ub = rng.uniform4(pid2, frame, jnp.int32(64 + tap),
                              seed ^ _DIM_REUSE, sampler)[:2]
        dx = jnp.round((ua * 2.0 - 1.0) * spatial_radius).astype(jnp.int32)
        dy = jnp.round((ub * 2.0 - 1.0) * spatial_radius).astype(jnp.int32)
        yy = jnp.arange(height, dtype=jnp.int32)[:, None] + dy
        xx = jnp.arange(width, dtype=jnp.int32)[None, :] + dx
        inb = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
        s_li = _gather2(li2, yy, xx)
        s_u2 = _gather2(u22, yy, xx)
        s_u3 = _gather2(u32, yy, xx)
        s_W = _gather2(W2, yy, xx)
        s_m = _gather2(m2, yy, xx)
        s_t = _gather2(t2, yy, xx)
        s_n = _gather2(n2, yy, xx)
        s_act = _gather2(act2.astype(jnp.float32), yy, xx) > 0.5
        same = (jnp.abs(s_t - t2) <= DEPTH_TOL * jnp.maximum(t2, 1e-3)) \
            & (jnp.sum(s_n * n2, -1) > NORMAL_MIN)
        valid = act2 & s_act & inb & same & (s_m > 0.0)
        srcs.append((s_li, s_u2, s_u3, s_W, s_m, valid))

    if srcs:
        li2, u22, u32, W2, m2 = _combine(
            packed, (li2, u22, u32, W2, m2, act2), srcs, point2, n2, alb2,
            pid2, frame, seed, sampler)

    return li2, u22, u32, W2, m2, act2, t2, n2


def _shade_terms(packed, li2, u22, u32, W2, point, n_unit, albedo, active):
    """Winner evaluation at the shading point: the full RGB integrand,
    shadow-ray direction/extent, and the live mask — everything the final
    occlusion query and :func:`_compose` need."""
    lif, u2f, u3f = li2.reshape(-1), u22.reshape(-1), u32.reshape(-1)
    Wf = W2.reshape(-1)
    phat_y, rgb, wdir, dist = _phat_row(_lookup(packed, lif), u2f, u3f,
                                        point, n_unit, albedo)
    live = active & (Wf > 0.0) & (phat_y > 0.0)
    return rgb, wdir, dist, live, Wf


def _compose(base, rgb, Wf, live, occluded, li2, u22, u32, m2, act2, t2,
             n2, albedo_g, normal_g, width, height):
    """Final image + new reservoir state from the shadow-ray verdict."""
    direct = jnp.where((live & ~occluded)[..., None], rgb * Wf[..., None],
                       0.0)
    img = (base + direct).reshape(height, width, 3)
    # visibility reuse (free — the winner's shadow ray is already paid):
    # a winner proven occluded is stored with W=0, so history and
    # neighbors never adopt a sample this pixel knows is shadowed
    W_store = jnp.where(occluded, 0.0, Wf).reshape(height, width)
    new_state = dict(li=li2, u2=u22, u3=u32, W=W_store,
                     m=jnp.where(act2, m2, 0.0),
                     t=jnp.where(act2, t2, INF), normal=n2)
    return (img, albedo_g.reshape(height, width, 3),
            normal_g.reshape(height, width, 3), new_state)


@partial(jax.jit, static_argnames=("width", "height", "spp",
                                   "m_candidates", "spatial_taps",
                                   "spatial_radius", "sampler"))
def render_restir_progressive(scene: Scene, materials: MaterialTable,
                              lights: AreaLights, camera, width: int,
                              height: int, spp: int = 1, seed=0,
                              m_candidates: int = 16,
                              spatial_taps: int = 2,
                              spatial_radius: int = 16, intersector=None,
                              background=(0.0, 0.0, 0.0), env=None,
                              textures=None, sampler: str = "pcg"):
    """``spp`` independent shadow rays per pixel with the reservoir state
    carried ACROSS samples (progressive ReSTIR): sample s reuses the
    resampled distribution of samples < s, so later samples draw from an
    ever-better proposal.  One jitted ``lax.scan`` — the product-facing
    entry (``integrator: "restir"`` in the config; models/common.py).

    Returns ``(img, albedo_g, normal_g)`` with img averaged over spp —
    the same contract as ``render_path``/``wavefront.render``.
    """
    state = empty_reservoir_state(width, height)

    def step(carry, f):
        st, acc, _, _ = carry
        img, alb, nrm, st = render_restir(
            scene, materials, lights, camera, width, height, seed=seed,
            frame=f, state=st, m_candidates=m_candidates,
            spatial_taps=spatial_taps, spatial_radius=spatial_radius,
            intersector=intersector, background=background, env=env,
            textures=textures, sampler=sampler)
        # guides are sample-invariant (pixel-center primaries): keep last
        return (st, acc + img, alb, nrm), None

    z3 = jnp.zeros((height, width, 3), jnp.float32)
    (state, acc, alb, nrm), _ = jax.lax.scan(
        step, (state, z3, z3, z3), jnp.arange(spp, dtype=jnp.int32))
    return acc / spp, alb, nrm


def render_restir_gi(scene: Scene, materials: MaterialTable,
                     lights: AreaLights, camera, width: int, height: int,
                     seed, frame=0, state: dict | None = None,
                     prev_camera=None, m_candidates: int = 16,
                     spatial_taps: int = 2, spatial_radius: int = 16,
                     max_depth: int = 8, intersector=None,
                     background=(0.0, 0.0, 0.0), env=None, textures=None,
                     clamp: float = 0.0, sampler: str = "pcg"):
    """Full light transport with ReSTIR direct: the reservoir pass owns
    the primary vertex's area-light direct lighting (one resampled shadow
    ray carrying ~M x history x taps effective light samples) and a
    ``trace_path(restir_direct=True)`` continuation owns everything else
    — indirect bounces, delta-primary transport, env NEE.  The partition
    is exact (see trace_path's docstring), so the sum is unbiased like
    the plain path tracer, but the direct term converges like ReSTIR.

    Same ray budget per sample as the path tracer (the primary wave is
    traced ONCE and shared; the bounce-0 NEE shadow ray moves from the
    path loop to the reservoir pass).  Returns
    ``(img, albedo_g, normal_g, new_state)`` like :func:`render_restir`.
    """
    from optix_ray_tracer_tpu.render.pathtracer import trace_path

    if lights is None or lights.count == 0:
        raise ValueError("render_restir needs a non-empty light table")
    if intersector is None:
        from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector
        intersector = BruteForceIntersector()
    background = jnp.asarray(background, jnp.float32)
    frame = jnp.asarray(frame, jnp.int32)

    npix = width * height
    pixel_id = jnp.arange(npix, dtype=jnp.int32)
    o, d = camera.generate_rays(width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    hit = intersector.intersect(scene, o, d, t_max=jnp.full((npix,), INF))

    point, n_unit, albedo, active, base, albedo_g, normal_g = _gbuffer(
        scene, materials, o, d, hit, textures, env, background)

    packed = _pack_lights(lights)
    li2, u22, u32, W2, m2, act2, t2, n2 = _resample(
        lights, packed, point, n_unit, albedo, active, hit.t, width,
        height, frame, seed, state, camera, prev_camera, m_candidates,
        spatial_taps, spatial_radius, sampler)

    rgb, wdir, dist, live, Wf = _shade_terms(packed, li2, u22, u32, W2,
                                             point, n_unit, albedo, active)
    occluded = intersector.any_hit(
        scene, point + n_unit * 1e-3, wdir,
        t_min=1e-4, t_max=jnp.where(live, dist - 2e-3, 0.0))
    img, alb_img, nrm_img, new_state = _compose(
        base, rgb, Wf, live, occluded, li2, u22, u32, m2, act2, t2, n2,
        albedo_g, normal_g, width, height)

    indirect, _, _ = trace_path(
        scene, materials, lights, o, d, pixel_id, frame,
        seed ^ _DIM_GI, background, max_depth=max_depth,
        intersector=intersector, env=env, textures=textures, clamp=clamp,
        sampler=sampler, restir_direct=True, first_hit=hit)
    img = img + indirect.reshape(height, width, 3)
    return img, alb_img, nrm_img, new_state


@partial(jax.jit, static_argnames=("width", "height", "spp",
                                   "m_candidates", "spatial_taps",
                                   "spatial_radius", "max_depth",
                                   "sampler"))
def render_restir_gi_progressive(scene: Scene, materials: MaterialTable,
                                 lights: AreaLights, camera, width: int,
                                 height: int, spp: int = 1, seed=0,
                                 m_candidates: int = 16,
                                 spatial_taps: int = 2,
                                 spatial_radius: int = 16,
                                 max_depth: int = 8, intersector=None,
                                 background=(0.0, 0.0, 0.0), env=None,
                                 textures=None, clamp: float = 0.0,
                                 sampler: str = "pcg"):
    """``spp`` samples of :func:`render_restir_gi` with the reservoir
    carried across samples — the product-facing entry
    (``integrator: "restir-gi"`` in the config; models/common.py).
    Returns ``(img, albedo_g, normal_g)`` averaged over spp."""
    state = empty_reservoir_state(width, height)

    def step(carry, f):
        st, acc, _, _ = carry
        img, alb, nrm, st = render_restir_gi(
            scene, materials, lights, camera, width, height, seed=seed,
            frame=f, state=st, m_candidates=m_candidates,
            spatial_taps=spatial_taps, spatial_radius=spatial_radius,
            max_depth=max_depth, intersector=intersector,
            background=background, env=env, textures=textures,
            clamp=clamp, sampler=sampler)
        return (st, acc + img, alb, nrm), None

    z3 = jnp.zeros((height, width, 3), jnp.float32)
    (state, acc, alb, nrm), _ = jax.lax.scan(
        step, (state, z3, z3, z3), jnp.arange(spp, dtype=jnp.int32))
    return acc / spp, alb, nrm
