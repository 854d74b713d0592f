"""Learned denoiser — the AI-denoiser parity component.

The reference's entire image-quality strategy is a pretrained AI denoiser
(``optixDenoiserInvoke``, LDR model with albedo+normal guide layers,
src/Global/RendererImpl.cu:584-669).  This module is the counterpart: a small kernel-predicting CNN (KPCN family, Bako et al.
2017) trained IN-REPO on self-rendered noisy/clean pairs from this
renderer's own integrators (render/train_denoiser.py), with the weights
committed as a package asset.

Design (matmul-first):
  * Features: demodulated irradiance, albedo, normal (9 channels) —
    the same guide-layer contract as the OptiX denoiser and the a-trous
    filter (render/denoise.py).
  * Body: 4 dilated 3x3 convolutions (dilations 1/2/4/8, 48 channels)
    — receptive field ~31 px, all matmuls under XLA.
  * Head: per-pixel weights over 75 taps = three 5x5 kernels at
    dilations 1/3/9, one joint softmax.  This is exactly the a-trous
    sparse footprint with LEARNED edge-stopping: the output is a convex
    combination of input radiance taps, so the filter can never invent
    energy or shift color — robust far outside the training set.
  * Applied to DEMODULATED irradiance, remodulated by albedo after
    (guide-albedo mode), like render/denoise.py.

Everything is pure jnp — jit/scan/shard_map compatible, so the fused
animation chunk and the viewer can run it on device inside one dispatch.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_HIDDEN = 48
_DILATIONS = (1, 2, 4, 8)          # feature body
_TAP_DILATIONS = (1, 3, 9)         # predicted-kernel scales
_TAPS_PER_SCALE = 25               # 5x5
_N_TAPS = _TAPS_PER_SCALE * len(_TAP_DILATIONS)
_WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "denoiser_data",
                             "weights.npz")


def init_params(seed: int = 0) -> dict:
    """He-initialized parameter pytree (a flat dict of arrays)."""
    rng = np.random.default_rng(seed)
    sizes = [9] + [_HIDDEN] * len(_DILATIONS)
    params = {}
    for i, (cin, cout) in enumerate(zip(sizes[:-1], sizes[1:])):
        std = float(np.sqrt(2.0 / (9 * cin)))
        params[f"w{i}"] = rng.normal(0, std, (3, 3, cin, cout)) \
            .astype(np.float32)
        params[f"b{i}"] = np.zeros(cout, np.float32)
    std = float(np.sqrt(2.0 / (9 * _HIDDEN)))
    params["w_out"] = rng.normal(0, std, (3, 3, _HIDDEN, _N_TAPS)) \
        .astype(np.float32)
    # bias so the initial kernel starts near the identity tap (center of
    # scale 0): stabilizes early training
    b = np.zeros(_N_TAPS, np.float32)
    b[12] = 2.0
    params["b_out"] = b
    return params


def _conv(x, w, b, dilation: int):
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b


def _tap_offsets():
    """The 75 (dy, dx) a-trous-footprint offsets, scale-major."""
    offs = []
    for d in _TAP_DILATIONS:
        for dy in (-2 * d, -d, 0, d, 2 * d):
            for dx in (-2 * d, -d, 0, d, 2 * d):
                offs.append((dy, dx))
    return offs


def apply(params: dict, irradiance, albedo, normal):
    """Filter DEMODULATED irradiance.  All inputs (N, H, W, 3) or
    (H, W, 3); returns the same rank."""
    single = irradiance.ndim == 3
    if single:
        irradiance = irradiance[None]
        albedo = albedo[None]
        normal = normal[None]
    x = jnp.concatenate(
        [jnp.log1p(jnp.maximum(irradiance, 0.0)), albedo, normal], axis=-1)
    for i, d in enumerate(_DILATIONS):
        x = jax.nn.relu(_conv(x, params[f"w{i}"], params[f"b{i}"], d))
    logits = _conv(x, params["w_out"], params["b_out"], 1)  # (N,H,W,75)
    w = jax.nn.softmax(logits, axis=-1)
    # tap-by-tap accumulation: 75 fused roll-mul-adds, never materializes
    # an (N, H, W, 75, 3) stack (matters at 1080p full frames).  Taps
    # that would wrap around the image (jnp.roll is cyclic, but the
    # zero-padded conv features carry no cross-edge signal) are masked
    # out and the kernel renormalized over the surviving taps — still a
    # convex combination, now of in-bounds radiance only.
    H, W = irradiance.shape[1:3]
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    out = jnp.zeros_like(irradiance)
    wsum = jnp.zeros(irradiance.shape[:3] + (1,), irradiance.dtype)
    for i, (dy, dx) in enumerate(_tap_offsets()):
        valid = ((yy + dy >= 0) & (yy + dy < H)
                 & (xx + dx >= 0) & (xx + dx < W))
        wv = w[..., i:i + 1] * valid[None, ..., None]
        out = out + jnp.roll(irradiance, (-dy, -dx), axis=(1, 2)) * wv
        wsum = wsum + wv
    out = out / jnp.maximum(wsum, 1e-12)   # center tap is always valid
    return out[0] if single else out


def save_params(params: dict, path: str) -> None:
    np.savez_compressed(path, **{k: np.asarray(v)
                                 for k, v in params.items()})


def load_params(path: str) -> dict:
    with np.load(path) as z:
        return {k: jnp.asarray(z[k]) for k in z.files}


_DEFAULT = None
_DEFAULT_KEY = None


def default_params() -> dict | None:
    """The committed pretrained weights, or None if not trained yet.
    Cached per (path, mtime): retraining in-process is picked up."""
    global _DEFAULT, _DEFAULT_KEY
    if not os.path.exists(_WEIGHTS_FILE):
        return None
    key = (_WEIGHTS_FILE, os.path.getmtime(_WEIGHTS_FILE))
    if _DEFAULT is None or _DEFAULT_KEY != key:
        _DEFAULT = load_params(_WEIGHTS_FILE)
        _DEFAULT_KEY = key
    return _DEFAULT


def demod_albedo(albedo):
    """Albedo used for irradiance demodulation.

    Miss/sky pixels carry a ~zero albedo guide; dividing by the 1e-3
    floor there would inflate the background to ~1000x surface
    irradiance, poisoning both the convex-combination filter (one stray
    sky tap ruins a surface pixel) and any training loss.  Treat
    near-black albedo as 1 (filter raw radiance there) instead."""
    black = jnp.all(albedo < 1e-3, axis=-1, keepdims=True)
    return jnp.where(black, 1.0, jnp.maximum(albedo, 1e-3))


@jax.jit
def _denoise_neural_jit(color, albedo, normal, params):
    safe_albedo = demod_albedo(albedo)
    out = apply(params, color / safe_albedo, albedo, normal)
    return out * safe_albedo


def denoise_neural(color, albedo, normal, params=None):
    """Drop-in counterpart of render/denoise.py::denoise using the
    learned filter.  color/albedo/normal (H, W, 3) linear; returns
    filtered (H, W, 3) linear.

    Weights are resolved OUTSIDE the jit boundary and passed as a pytree
    argument: the compiled trace is shared across weight values, so
    retraining (or a monkeypatched weights path) takes effect on the
    next call instead of being baked into a stale compile."""
    if params is None:
        params = default_params()
        if params is None:
            raise FileNotFoundError(
                f"no pretrained denoiser weights at {_WEIGHTS_FILE}; run "
                "python -m optix_ray_tracer_tpu.render.train_denoiser")
    return _denoise_neural_jit(color, albedo, normal, params)


# keep the unjitted-call convention used inside fused scans
denoise_neural.__wrapped__ = \
    lambda color, albedo, normal, params=None: _denoise_neural_jit.__wrapped__(
        color, albedo, normal,
        params if params is not None else default_params())
