"""Stateless counter-based RNG for rendering.

The reference keeps one mutable ``curandState`` per pixel, seeded
``tid ^ clock64()`` (``src/Global/HostFunctions.cu:122-140``) — inherently
stateful and non-replayable.  This design replaces it with a pure
counter hash: every random number is a function of
``(pixel_id, sample_index, bounce, dimension, seed)``.  This makes sampling

* replayable (same seed => bit-identical frame, used by the determinism tests),
* shard-safe (a pixel's randoms don't depend on which chip computes it, so
  tile- and sample-sharding over a ``jax.sharding.Mesh`` is exact),
* stateless under jit (no carried RNG arrays in the bounce loop).

Hash: PCG4D (Jarzynski & Olano, JCGT 2020, "Hash Functions for GPU
Rendering") — 4 lanes of LCG + cross-lane mixing + xorshift; pure uint32
elementwise ops, no gathers.
"""

from __future__ import annotations

import jax.numpy as jnp

from optix_ray_tracer_tpu.utils.vecmath import PI

_U32 = jnp.uint32
_INV_2_24 = float(1.0 / (1 << 24))   # python float: a module-level jnp scalar
# becomes a hoisted runtime const buffer in every caller jaxpr, and jax
# 0.9 mis-counts such consts on the C++ fastpath after nested-jit traces
# ("Execution supplied 18 buffers but compiled program expected 20")


def pcg4d(a, b, c, d):
    """PCG4D hash: four uint32 streams in, four mixed uint32 streams out.

    Inputs broadcast against each other; any integer dtype is accepted
    (Python ints are wrapped mod 2^32).
    """
    import numpy as _np

    def _u32(v):
        if isinstance(v, int):
            return jnp.asarray(_np.uint32(v & 0xFFFFFFFF))
        return jnp.asarray(v).astype(_U32)

    x, y, z, w = _u32(a), _u32(b), _u32(c), _u32(d)

    mul = _U32(1664525)
    inc = _U32(1013904223)
    x = x * mul + inc
    y = y * mul + inc
    z = z * mul + inc
    w = w * mul + inc

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_unit_float(u):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (u >> 8).astype(jnp.float32) * _INV_2_24


def uniform4(pixel_id, sample, bounce, seed, mode: str = "pcg"):
    """Four U[0,1) floats per (pixel, sample, bounce, seed).

    ``mode`` selects the stream (a trace-time static): "pcg" — PCG4D
    pseudo-random (reference-parity default); "sobol" — Owen-scrambled
    Sobol over the SAMPLE index (utils/qmc.py), same purity contract,
    ~1/N^2 variance on smooth integrands.
    """
    if mode == "sobol":
        from optix_ray_tracer_tpu.utils.qmc import sobol_owen4
        return sobol_owen4(pixel_id, sample, bounce, seed)
    x, y, z, w = pcg4d(pixel_id, sample, bounce, seed)
    return _to_unit_float(x), _to_unit_float(y), _to_unit_float(z), _to_unit_float(w)


def uniform_in_range(u, lo, hi):
    return lo + (hi - lo) * u


def random_unit_vector(pixel_id, sample, bounce, seed, mode: str = "pcg"):
    """Uniform direction on the unit sphere (z/phi parameterization).

    Replaces the reference's rejection loop ``randomSpaceVector``
    (DeviceFunctions.cuh:569-583).  NOTE: the reference normalizes a uniform
    sample of the cube [-1,1]^3, which is *not* uniform on the sphere (it is
    biased toward cube diagonals); we use the exact uniform distribution —
    the images agree in expectation for Lambertian scatter up to this small
    directional bias, and our CPU oracle uses the same sampler so golden
    tests are exact.  Returns (..., 3) float32.
    """
    u1, u2, _, _ = uniform4(pixel_id, sample, bounce, seed, mode)
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * PI) * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def random_cosine_direction(pixel_id, sample, bounce, seed,
                            mode: str = "pcg"):
    """Cosine-weighted hemisphere sample about +z (for NEE/MIS shading).

    Counterpart of the reference's ``randomCosineVector``
    (DeviceFunctions.cuh:586-606), minus its non-unit-length quirk.
    """
    u1, u2, _, _ = uniform4(pixel_id, sample, bounce, seed, mode)
    phi = (2.0 * PI) * u1
    sq = jnp.sqrt(u2)
    return jnp.stack([jnp.cos(phi) * sq,
                      jnp.sin(phi) * sq,
                      jnp.sqrt(jnp.maximum(0.0, 1.0 - u2))], axis=-1)


def random_in_unit_disk(pixel_id, sample, bounce, seed,
                        mode: str = "pcg"):
    """Uniform point in the unit disk (polar method, rejection-free).

    Counterpart of ``randomPlaneVector`` (DeviceFunctions.cuh:560-567),
    used for depth-of-field lens sampling.
    Returns (..., 2).
    """
    u1, u2, _, _ = uniform4(pixel_id, sample, bounce, seed, mode)
    r = jnp.sqrt(u1)
    phi = (2.0 * PI) * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def stratified_jitter(pixel_id, sample, seed, mode: str = "pcg"):
    """Pixel-filter jitter (u1, u2) stratified over a fixed 4x4 subpixel
    grid cycled by sample index.

    The cell depends only on the GLOBAL sample index, so progressive
    batches and sharded renders continue the same stratum sequence
    (bit-identical under any mesh shape, like all counter-RNG draws).
    Within-cell offsets come from the usual PCG4D stream, so any spp is
    unbiased; spp >= 16 gets full stratification per cycle.
    """
    if mode == "sobol":
        # Sobol's joint 2D (0,1) property IS pixel-filter stratification
        # at every power-of-two prefix — no explicit grid needed
        u1, u2, _, _ = uniform4(pixel_id, sample, jnp.int32(-1), seed,
                                mode)
        return u1, u2
    u1, u2, _, _ = uniform4(pixel_id, sample, jnp.int32(-1), seed)
    cell = jnp.asarray(sample, jnp.int32) % 16
    cx = (cell % 4).astype(jnp.float32)
    cy = (cell // 4).astype(jnp.float32)
    return (cx + u1) * 0.25, (cy + u2) * 0.25
