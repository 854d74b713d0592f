"""Adaptive (variance-guided) progressive sampling.

The reference's noise strategy is fixed 1 spp + the AI denoiser
(`/root/reference/docs/technical-details.md:295-297`); this framework's
progressive mode accumulates uniform samples.  Ray traversal is the
dominant cost, so an end-to-end lever is issuing FEWER rays for the same
image quality.  This
module allocates each progressive batch to the pixels with the highest
estimated error instead of uniformly:

* per-pixel running moments (radiance sum + luminance sum-of-squares +
  sample count) give the variance of each pixel's mean estimate;
* batch selection ranks pixels by marginal variance reduction
  ``sigma_p / n_p`` (3x3-smoothed — the few-sample variance estimate is
  itself noisy) and traces the top K only;
* per-PIXEL sample counters key the counter-based RNG/QMC streams
  (``uniform4(pixel, sample, ...)``), so each pixel consumes exactly the
  same (pixel, sample) stream prefix it would under uniform rendering,
  and Sobol sequences keep their low-discrepancy structure per pixel.

The per-pixel mean over any FIXED count is unbiased; letting the count
depend on observed values has the standard adaptive-sampling stopping
bias, bounded here by the uniform warmup + the anti-starvation count
floor (every pixel keeps >= half the average count) and not measurable
above MC noise in the equal-budget tests.

Everything is static-shape XLA: K is a compile-time constant, selection is
one ``argsort`` over the priority map (measured ~16 ms/Mpixel — noise next
to seconds of tracing), accumulation is a unique-index ``scatter-add``.

Typical budget win (tests/test_adaptive.py, PERF.md): on scenes where the
noise is localized (flat background + noisy GI subject — the common case),
equal-ray-budget RMSE drops vs uniform sampling; the CLI exposes it as
``--progressive N --adaptive``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from optix_ray_tracer_tpu.utils import rng as rng_mod
from optix_ray_tracer_tpu.utils.color import (
    color_to_uint8, luminance as _luminance, write_png, write_ppm,
)

_DIM_LENS = 0x68E31DA4  # lens-sample dimension salt (render/pathtracer.py)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveFilm:
    """Per-pixel running moments for variance-guided accumulation.

    Flat ``(npix, ...)`` layout (pixel id = ``iy * width + ix``, row 0 =
    image top).  ``count`` is PER PIXEL — unlike :class:`film.Film` whose
    spp is global — because adaptive batches leave pixels at different
    sample depths."""
    accum: jax.Array          # (npix, 3) float32 radiance sum
    sumsq: jax.Array          # (npix,)  float32 luminance^2 sum
    count: jax.Array          # (npix,)  int32 samples per pixel
    albedo_accum: jax.Array   # (npix, 3)
    normal_accum: jax.Array   # (npix, 3)
    width: int = dataclasses.field(default=0, metadata=dict(static=True))
    height: int = dataclasses.field(default=0, metadata=dict(static=True))

    @staticmethod
    def create(width: int, height: int) -> "AdaptiveFilm":
        npix = width * height
        z3 = jnp.zeros((npix, 3), jnp.float32)
        return AdaptiveFilm(
            accum=z3, sumsq=jnp.zeros((npix,), jnp.float32),
            count=jnp.zeros((npix,), jnp.int32),
            albedo_accum=z3, normal_accum=z3,
            width=width, height=height)

    @property
    def total_samples(self) -> int:
        # one host fetch; sum in numpy int64 (jax x32 would overflow at
        # ~2^31 total samples = 2k spp on a 1M-pixel film)
        return int(np.asarray(self.count, np.int64).sum())

    def mean(self):
        inv = 1.0 / jnp.maximum(self.count.astype(jnp.float32), 1.0)
        return (self.accum * inv[:, None]).reshape(
            self.height, self.width, 3)

    def guide_means(self):
        inv = 1.0 / jnp.maximum(self.count.astype(jnp.float32), 1.0)
        shp = (self.height, self.width, 3)
        return ((self.albedo_accum * inv[:, None]).reshape(shp),
                (self.normal_accum * inv[:, None]).reshape(shp))

    def to_uint8(self) -> np.ndarray:
        return np.asarray(color_to_uint8(self.mean()))

    def save(self, path: str) -> None:
        img = self.to_uint8()
        if path.endswith(".ppm"):
            write_ppm(path, img)
        else:
            write_png(path, img)

    # ---- checkpoint / resume (same pattern as film.Film) ---------------

    def checkpoint(self, path: str, meta: dict | None = None) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path,
                 accum=np.asarray(self.accum),
                 sumsq=np.asarray(self.sumsq),
                 count=np.asarray(self.count),
                 albedo=np.asarray(self.albedo_accum),
                 normal=np.asarray(self.normal_accum),
                 width=self.width, height=self.height)
        if meta is not None:
            with open(path + ".json", "w") as f:
                json.dump(dict(meta, adaptive=True), f)

    @staticmethod
    def restore(path: str) -> "AdaptiveFilm":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            return AdaptiveFilm(
                accum=jnp.asarray(z["accum"]),
                sumsq=jnp.asarray(z["sumsq"]),
                count=jnp.asarray(z["count"]),
                albedo_accum=jnp.asarray(z["albedo"]),
                normal_accum=jnp.asarray(z["normal"]),
                width=int(z["width"]), height=int(z["height"]))


def error_map(film: AdaptiveFilm, relative: bool = False):
    """Per-pixel priority, smoothed 3x3.  Unsampled pixels rank first
    (+inf).

    Default ranking is the GREEDY-OPTIMAL one for mean-squared error:
    adding a sample to pixel p shrinks its mean's variance by
    ``sigma_p^2/n_p - sigma_p^2/(n_p+1) ~ sigma_p^2/n_p^2``, so ranking by
    ``sigma_p/n_p`` allocates each batch where it buys the most RMSE
    (the water-filling solution ``n_p ~ sigma_p`` in the large-batch
    limit).  ``relative=True`` divides by mean luminance — perceptual
    (tonemapped) weighting that favors dark regions."""
    n = jnp.maximum(film.count.astype(jnp.float32), 1.0)
    lum_mean = _luminance(film.accum) / n
    # UNBIASED sample variance (n-1 denominator): the /n estimator is
    # biased low — exactly 0 at n=1 — which froze lucky-first-sample
    # pixels at a wrong mean (measured: adaptive LOST to uniform past
    # ~24 spp before this + the count floor below)
    var = jnp.maximum(film.sumsq - n * lum_mean * lum_mean, 0.0) \
        / jnp.maximum(n - 1.0, 1.0)
    err = jnp.sqrt(var) / n
    if relative:
        err = err / (jnp.abs(lum_mean) + 0.05)
    err = jnp.nan_to_num(err, nan=0.0, posinf=1e30)
    # 3x3 box smooth on the image grid: a few-sample variance estimate is
    # noisy; neighbours share it
    e = err.reshape(film.height, film.width)
    p = jnp.pad(e, 1, mode="edge")
    e = sum(p[dy:dy + film.height, dx:dx + film.width]
            for dy in range(3) for dx in range(3)) * (1.0 / 9.0)
    err = e.reshape(-1)
    # anti-starvation floor: a pixel whose estimated sigma is wrong (too
    # low) must still be revisited, or its error never shrinks and its
    # variance estimate never corrects.  Pixels below HALF the average
    # count rank first (with unsampled pixels above them).
    n_mean = jnp.mean(film.count.astype(jnp.float32))
    err = jnp.where(film.count.astype(jnp.float32) < 0.5 * n_mean,
                    jnp.float32(1e32), err)
    return jnp.where(film.count == 0, jnp.float32(jnp.inf), err)


@partial(jax.jit, static_argnames=(
    "k", "max_depth", "jitter", "sampler", "integrator", "relative"))
def adaptive_batch(scene, materials, lights, camera, film: AdaptiveFilm,
                   k: int, seed: int = 0, background=(0.0, 0.0, 0.0),
                   max_depth: int = 8, intersector=None, env=None,
                   textures=None, jitter: bool = True,
                   sampler: str = "pcg", integrator: str = "path",
                   relative: bool = False) -> AdaptiveFilm:
    """Trace ONE sample for each of the ``k`` highest-error pixels and
    accumulate.  ``k = npix`` degenerates to a uniform 1-spp pass (every
    pixel selected once; use it for warmup).  ``integrator``: "path"
    (NEE+MIS, needs ``lights``) or "whitted" (reference protocol)."""
    background = jnp.asarray(background, jnp.float32)
    npix = film.width * film.height
    if not (0 < k <= npix):
        raise ValueError(f"k={k} out of range (npix={npix})")

    # ---- select ---------------------------------------------------------
    ids = jnp.argsort(-error_map(film, relative))[:k].astype(jnp.int32)
    samp = film.count[ids]          # per-PIXEL sample index -> RNG stream

    # ---- generate (subset camera rays, same streams as render_path) -----
    if jitter:
        u1, u2 = rng_mod.stratified_jitter(ids, samp, seed, sampler)
        jit_uv = jnp.stack([u1, u2], -1)
    else:
        jit_uv = None
    lens = None
    if float(camera.aperture) > 0.0:      # static: pruned for pinhole
        lens = rng_mod.random_in_unit_disk(
            ids, samp, jnp.int32(-2), seed ^ _DIM_LENS, sampler)
    o, d = camera.generate_rays_for_pixels(ids, film.width, film.height,
                                           jit_uv, lens)

    # ---- trace -----------------------------------------------------------
    if integrator == "path":
        from optix_ray_tracer_tpu.render.pathtracer import trace_path
        radiance, alb, nrm = trace_path(
            scene, materials, lights, o, d, ids, samp, seed, background,
            max_depth, intersector, env, textures, sampler=sampler)[:3]
    else:
        from optix_ray_tracer_tpu.render import wavefront
        radiance, alb, nrm = wavefront.trace(
            scene, materials, o, d, ids, samp, seed, background,
            max_depth, intersector, env, sampler=sampler)

    # ---- accumulate (ids unique -> deterministic scatter-add) ------------
    lum = _luminance(radiance)
    return AdaptiveFilm(
        accum=film.accum.at[ids].add(radiance),
        sumsq=film.sumsq.at[ids].add(lum * lum),
        count=film.count.at[ids].add(1),
        albedo_accum=film.albedo_accum.at[ids].add(alb),
        normal_accum=film.normal_accum.at[ids].add(nrm),
        width=film.width, height=film.height)


def render_adaptive(scene, materials, lights, camera, width: int,
                    height: int, total_spp: int, seed: int = 0,
                    background=(0.0, 0.0, 0.0), max_depth: int = 8,
                    intersector=None, env=None, textures=None,
                    warmup_spp: int = 4, batch_fraction: float = 0.25,
                    jitter: bool = True, sampler: str = "pcg",
                    integrator: str = "path", relative: bool = False,
                    film: AdaptiveFilm | None = None):
    """Render with a total ray budget of ``total_spp * npix`` samples:
    ``warmup_spp`` uniform passes seed the variance map, the remainder
    goes to the highest-error pixels in batches of
    ``batch_fraction * npix`` rays.  Returns the :class:`AdaptiveFilm`
    (callers take ``.mean()`` / ``.guide_means()``)."""
    npix = width * height
    if film is None:
        film = AdaptiveFilm.create(width, height)
    budget = total_spp * npix
    k_batch = max(1, int(npix * batch_fraction))
    kw = dict(seed=seed, background=background, max_depth=max_depth,
              intersector=intersector, env=env, textures=textures,
              jitter=jitter, sampler=sampler, integrator=integrator,
              relative=relative)
    while film.total_samples < budget:
        done = film.total_samples
        if done < warmup_spp * npix:
            k = npix
        else:
            # exact budget: the tail batch shrinks (one extra compile)
            k = min(k_batch, budget - done)
        film = adaptive_batch(scene, materials, lights, camera, film,
                              k=k, **kw)
    return film
