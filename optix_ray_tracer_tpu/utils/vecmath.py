"""Batched 3-vector math for the renderer core.

Counterpart of the reference's device math library
(``include/Global/DeviceFunctions.cuh:230-546``): instead of float3 operator
overloads on scalars-in-registers, every op here is written over arrays whose
last axis is the component axis, so they vectorize across whole ray batches
and fuse under XLA.

All functions are shape-polymorphic over leading axes: ``(..., 3)``.
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches FLOAT_ZERO_VALUE / FLOAT_INFINITY_VALUE
# (reference include/Global/DeviceFunctions.cuh:18-19).
EPS = 1e-6
INF = 1e16
PI = 3.1415926  # reference uses this truncated constant (DeviceFunctions.cuh:20)


def vec3(x, y, z, dtype=jnp.float32):
    """Stack three scalars-or-arrays into a (..., 3) vector."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(v, keepdims: bool = False):
    return jnp.sum(v * v, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return jnp.sqrt(length_squared(v, keepdims=keepdims))


def normalize(v, eps: float = 0.0):
    """Safe normalize.

    The reference's ``normalize`` divides by sqrt(lengthSquared) and relies on
    callers to guard degenerate vectors (DeviceFunctions.cuh:397-404).  Here a
    tiny floor keeps the op NaN-free under jit; exact zero vectors map to zero.
    """
    n2 = length_squared(v, keepdims=True)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, 1e-30)), 0.0)
    return v * inv


def reflect(v, n):
    """Mirror reflection, matches metal BSDF in reference shader/Shader.cu:183-185."""
    return v - 2.0 * dot(v, n, keepdims=True) * n


def refract(uv, n, eta_ratio):
    """Snell refraction (for the dielectric BSDF extension).

    ``uv`` must be unit length, ``n`` the outward unit normal,
    ``eta_ratio = eta_incident / eta_transmitted``.
    """
    cos_theta = jnp.minimum(-dot(uv, n, keepdims=True), 1.0)
    r_perp = eta_ratio * (uv + cos_theta * n)
    r_par = -jnp.sqrt(jnp.abs(1.0 - length_squared(r_perp, keepdims=True))) * n
    return r_perp + r_par


def schlick_fresnel(cosine, ref_idx):
    """Schlick's reflectance approximation for dielectrics."""
    r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def rotate_about_axis(v, axis, radians):
    """Rodrigues rotation (reference DeviceFunctions.cuh rotate-about-axis)."""
    axis = normalize(axis)
    c = jnp.cos(radians)[..., None] if jnp.ndim(radians) else jnp.cos(radians)
    s = jnp.sin(radians)[..., None] if jnp.ndim(radians) else jnp.sin(radians)
    return v * c + cross(axis, v) * s + axis * dot(axis, v, keepdims=True) * (1.0 - c)


def is_finite(v):
    return jnp.all(jnp.isfinite(v), axis=-1)


def degrees_to_radians(deg):
    return deg * (PI / 180.0)


def radians_to_degrees(rad):
    return rad * (180.0 / PI)
