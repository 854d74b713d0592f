"""Batched ray-primitive intersection kernels.

These replace the OptiX built-in sphere / triangle intersectors the reference
relies on (``RendererImpl.cu:294-314`` loads
``OPTIX_PRIMITIVE_TYPE_SPHERE/TRIANGLE`` IS modules) with dense, regular
batches: a block of rays against a block of primitives, element-wise math
with reductions.

Two layers:

* ``ray_sphere_block`` / ``ray_triangle_block``: (R, C) all-pairs tests used
  by both the brute-force path and BVH leaf tests.
* ``intersect_scene_bruteforce``: lax.scan over primitive chunks keeping the
  running nearest hit — the reference oracle every accelerated path is
  golden-tested against.

Hit payloads are SoA; ``PRIM_NONE/SPHERE/TRIANGLE`` tags replace OptiX's
SBT-offset-based program selection.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.scene.geometry import Scene
from optix_ray_tracer_tpu.utils.vecmath import INF, dot

PRIM_NONE = 0
PRIM_SPHERE = 1
PRIM_TRIANGLE = 2

# Default ray epsilon.  The reference traces with tMin = FLOAT_ZERO_VALUE =
# 1e-6 (shader/Shader.cu:234, DeviceFunctions.cuh:18); we default to 1e-3
# because float32 hit points on kilometer-scale geometry (the config.json
# ground sphere has radius 1000) need a larger self-intersection guard than
# OptiX's watertight hardware traversal did.
DEFAULT_T_MIN = 1e-3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Nearest-hit record for a ray batch (all (R,) or noted)."""
    t: jax.Array          # hit distance, INF if miss
    prim_type: jax.Array  # int32 PRIM_*
    prim_id: jax.Array    # int32 index within its primitive array
    u: jax.Array          # triangle barycentric u (sphere: 0)
    v: jax.Array          # triangle barycentric v (sphere: 0)

    @property
    def is_hit(self):
        return self.prim_type != PRIM_NONE

    @staticmethod
    def none(batch_shape) -> "Hit":
        return Hit(t=jnp.full(batch_shape, INF, jnp.float32),
                   prim_type=jnp.zeros(batch_shape, jnp.int32),
                   prim_id=jnp.zeros(batch_shape, jnp.int32),
                   u=jnp.zeros(batch_shape, jnp.float32),
                   v=jnp.zeros(batch_shape, jnp.float32))


def _per_ray_bound(t, nrays):
    """Normalize a scalar-or-(R,) ray bound to shape (R, 1) for (R, C) ops."""
    t = jnp.asarray(t, jnp.float32)
    return jnp.broadcast_to(t.reshape(-1, 1) if t.ndim else t, (nrays, 1)) \
        if t.ndim <= 1 else t


def ray_sphere_block(o, d, centers, radii, t_min, t_max):
    """All-pairs ray/sphere test.

    o, d: (R, 3); centers: (C, 3); radii: (C,).  t_min/t_max may be scalars
    or per-ray (R,) bounds (shadow rays bound t_max by the light distance).
    Returns t of shape (R, C) with INF where there is no hit in
    (t_min, t_max).  Nearest-root-else-far semantics match the classic
    quadratic solve used by OptiX's builtin sphere primitive and RTIOW.
    """
    t_min = _per_ray_bound(t_min, o.shape[0])
    t_max = _per_ray_bound(t_max, o.shape[0])
    oc = o[:, None, :] - centers[None, :, :]          # (R, C, 3)
    # d is unit length, so a == 1; keep the general form for safety.
    a = jnp.sum(d * d, axis=-1)[:, None]              # (R, 1)
    half_b = jnp.sum(oc * d[:, None, :], axis=-1)     # (R, C)
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    disc = half_b * half_b - a * c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_disc) * inv_a
    t_far = (-half_b + sqrt_disc) * inv_a
    near_ok = (t_near > t_min) & (t_near < t_max)
    far_ok = (t_far > t_min) & (t_far < t_max)
    t = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, INF))
    return jnp.where(disc > 0.0, t, INF)


def ray_triangle_block(o, d, v0, e1, e2, t_min, t_max, eps: float = 1e-9):
    """All-pairs Moller-Trumbore.

    o, d: (R, 3); v0, e1, e2: (C, 3) (first vertex + two edges).
    Returns (t, u, v) of shape (R, C); t is INF where there is no hit.
    Backface culling is OFF (the reference shades both faces and flips the
    normal by sign of dot(dir, n), shader/Shader.cu:133-153).
    """
    t_min = _per_ray_bound(t_min, o.shape[0])
    t_max = _per_ray_bound(t_max, o.shape[0])
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])           # (R, C, 3)
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)             # (R, C)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    ok = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max))
    return jnp.where(ok, t, INF), u, v


def _nearest_from_block(t_block):
    """argmin over the chunk axis -> (best_t, best_idx)."""
    best_idx = jnp.argmin(t_block, axis=-1)
    best_t = jnp.take_along_axis(t_block, best_idx[:, None], axis=-1)[:, 0]
    return best_t, best_idx.astype(jnp.int32)


def _merge(hit: Hit, t, ptype, pid, u, v) -> Hit:
    closer = t < hit.t
    return Hit(
        t=jnp.where(closer, t, hit.t),
        prim_type=jnp.where(closer, ptype, hit.prim_type),
        prim_id=jnp.where(closer, pid, hit.prim_id),
        u=jnp.where(closer, u, hit.u),
        v=jnp.where(closer, v, hit.v))


def _pad_to_chunks(arr, chunk, axis=0, fill=0.0):
    n = arr.shape[axis]
    padded = ((n + chunk - 1) // chunk) * chunk
    if padded == n:
        return arr
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, padded - n)
    return jnp.pad(arr, pad_widths, constant_values=fill)


@partial(jax.jit, static_argnames=("chunk",))
def intersect_scene_bruteforce(scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                               t_max=INF, chunk: int = 512) -> Hit:
    """Nearest hit by streaming all primitives past all rays.

    lax.scan over primitive chunks keeps peak memory at (R, chunk) while XLA
    pipelines the chunk loads from device memory.  This is the correctness oracle; the
    BVH engines (``ops/traverse.py``, ``ops/gpu_traverse.py``) must agree
    with it up to exact fp ties.
    """
    shape = o.shape[:-1]
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    hit = Hit.none((o2.shape[0],))
    # bound peak memory: the (R, chunk, 3) block intermediates must stay
    # ~<=0.5 GB regardless of wavefront size (1M rays x 512 chunk would
    # materialize 6 GB and OOM the chip)
    chunk = min(chunk, max(32, (1 << 24) // max(o2.shape[0], 1)))

    if scene.sphere_count > 0:
        centers = _pad_to_chunks(scene.spheres.centers, chunk)
        # NaN radius padding: the discriminant becomes NaN, every comparison
        # fails, and the padded slot can never produce a hit.
        radii = _pad_to_chunks(scene.spheres.radii, chunk, fill=float("nan"))
        nchunks = centers.shape[0] // chunk

        def sphere_step(h, blk):
            cs, rs, base = blk
            t = ray_sphere_block(o2, d2, cs, rs, t_min, t_max)
            bt, bi = _nearest_from_block(t)
            return _merge(h, bt, jnp.int32(PRIM_SPHERE), base + bi,
                          jnp.zeros_like(bt), jnp.zeros_like(bt)), None

        blocks = (centers.reshape(nchunks, chunk, 3),
                  radii.reshape(nchunks, chunk),
                  jnp.arange(nchunks, dtype=jnp.int32) * chunk)
        hit, _ = jax.lax.scan(sphere_step, hit, blocks)

    if scene.triangle_count > 0:
        verts = _pad_to_chunks(scene.triangles.vertices, chunk)
        v0 = verts[:, 0]
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        nchunks = v0.shape[0] // chunk

        def tri_step(h, blk):
            bv0, be1, be2, base = blk
            t, u, v = ray_triangle_block(o2, d2, bv0, be1, be2, t_min, t_max)
            bt, bi = _nearest_from_block(t)
            gather = bi[:, None]
            bu = jnp.take_along_axis(u, gather, axis=-1)[:, 0]
            bv = jnp.take_along_axis(v, gather, axis=-1)[:, 0]
            return _merge(h, bt, jnp.int32(PRIM_TRIANGLE), base + bi, bu, bv), None

        blocks = (v0.reshape(nchunks, chunk, 3),
                  e1.reshape(nchunks, chunk, 3),
                  e2.reshape(nchunks, chunk, 3),
                  jnp.arange(nchunks, dtype=jnp.int32) * chunk)
        hit, _ = jax.lax.scan(tri_step, hit, blocks)

    return jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]), hit)


def shading_frame(scene: Scene, o, d, hit: Hit):
    """Reconstruct hit point + shading normal for a batch of hits.

    Semantics of the reference closest-hit normal reconstruction
    (``shader/Shader.cu:121-162``): spheres use the analytic outward normal
    (hit - center)/radius; triangles barycentrically interpolate vertex
    normals w*n1 + u*n2 + v*n3; both flip the normal against the ray
    direction (two-sided shading).

    Returns (point (R,3), normal (R,3) UN-normalized like the reference,
    front_face (R,), material_id (R,)).
    """
    point = o + hit.t[..., None] * d

    sph_id = jnp.clip(hit.prim_id, 0, max(scene.sphere_count - 1, 0))
    tri_id = jnp.clip(hit.prim_id, 0, max(scene.triangle_count - 1, 0))

    if scene.sphere_count > 0:
        centers = scene.spheres.centers[sph_id]
        radii = scene.spheres.radii[sph_id]
        n_sphere = (point - centers) / jnp.maximum(radii, 1e-30)[..., None]
        m_sphere = scene.spheres.material_id[sph_id]
    else:
        n_sphere = jnp.zeros_like(point)
        m_sphere = jnp.zeros(hit.t.shape, jnp.int32)

    if scene.triangle_count > 0:
        n123 = scene.triangles.normals[tri_id]       # (R, 3, 3)
        w = (1.0 - hit.u - hit.v)[..., None]
        n_tri = (w * n123[..., 0, :] + hit.u[..., None] * n123[..., 1, :]
                 + hit.v[..., None] * n123[..., 2, :])
        m_tri = scene.triangles.material_id[tri_id]
    else:
        n_tri = jnp.zeros_like(point)
        m_tri = jnp.zeros(hit.t.shape, jnp.int32)

    is_tri = hit.prim_type == PRIM_TRIANGLE
    normal = jnp.where(is_tri[..., None], n_tri, n_sphere)
    material_id = jnp.where(is_tri, m_tri, m_sphere)

    front_face = dot(d, normal) < 0.0
    normal = jnp.where(front_face[..., None], normal, -normal)
    return point, normal, front_face, material_id


def intersect_any_bruteforce(scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                             t_max=INF, chunk: int = 512):
    """Shadow-ray (any-hit) query: True where something blocks (t_min,t_max).

    The reference has no shadow rays (background-lit Whitted tracer); NEE
    path tracing needs them, and the bench counts them as rays.
    """
    hit = intersect_scene_bruteforce(scene, o, d, t_min, t_max, chunk=chunk)
    return hit.is_hit


def interpolate_uv(scene: Scene, hit: Hit):
    """Barycentric-interpolated texture coordinates at triangle hits.

    Returns (R, 2); zeros for sphere hits/misses or untextured scenes.
    """
    if scene.triangles.uvs is None or scene.triangle_count == 0:
        return jnp.zeros(hit.t.shape + (2,), jnp.float32)
    tri_id = jnp.clip(hit.prim_id, 0, scene.triangle_count - 1)
    uv3 = scene.triangles.uvs[tri_id]                    # (R, 3, 2)
    w = (1.0 - hit.u - hit.v)[..., None]
    uv = (w * uv3[..., 0, :] + hit.u[..., None] * uv3[..., 1, :]
          + hit.v[..., None] * uv3[..., 2, :])
    return jnp.where((hit.prim_type == PRIM_TRIANGLE)[..., None], uv, 0.0)
