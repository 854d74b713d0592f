"""BVH traversal in plain XLA — the portable twin of the GPU kernel.

The reference's per-ray hardware traversal (``optixTrace`` inside
``shader/Shader.cu:46-92``) becomes a vectorized stack-based walk: every ray
carries a small node stack; ``vmap`` turns the per-ray while-loop into a
lockstep masked loop across a chunk of the wavefront, so every lane runs
until the slowest lane of its chunk finishes.

Leaf hits dispatch by primitive-id range (spheres first, then triangles) —
the index-tag scheme that replaces OptiX SBT offsets.

``_traverse_batch`` is the engine's path off the GPU (CPU tests, ``--cpu``;
``gpu_traverse.trace_xla``); on the GPU the per-ray Pallas kernel of
``ops/gpu_traverse.py`` walks the same LBVH.  :class:`BVHIntersector` is a
cross-check for tests only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.ops.bvh import LBVH, build_scene_lbvh
from optix_ray_tracer_tpu.ops.intersect import (
    DEFAULT_T_MIN, Hit, PRIM_NONE, PRIM_SPHERE, PRIM_TRIANGLE,
    intersect_scene_bruteforce,
)
from optix_ray_tracer_tpu.scene.geometry import Scene
from optix_ray_tracer_tpu.utils.vecmath import INF

STACK_DEPTH = 64


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test; o/inv_d (3,), boxes (..., 3). Returns hit mask + entry t."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.max(tlo, axis=-1), t_min)
    t_exit = jnp.minimum(jnp.min(thi, axis=-1), t_max)
    return t_enter <= t_exit, t_enter


def _make_leaf_tester(scene: Scene, t_min):
    """Returns test(pid_sorted_space, o, d, best) -> updated best tuple.

    best = (t, prim_type, prim_id, u, v)."""
    S = scene.sphere_count
    T = scene.triangle_count

    def test(pid, o, d, best):
        best_t, b_type, b_id, b_u, b_v = best

        is_sphere = pid < S
        # --- sphere test (masked) ---
        if S > 0:
            sid = jnp.clip(pid, 0, S - 1)
            center = scene.spheres.centers[sid]
            radius = scene.spheres.radii[sid]
            oc = o - center
            half_b = jnp.dot(oc, d)
            c = jnp.dot(oc, oc) - radius * radius
            disc = half_b * half_b - c
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            t_near = -half_b - sq
            t_far = -half_b + sq
            t_s = jnp.where((t_near > t_min) & (t_near < best_t), t_near,
                            jnp.where((t_far > t_min) & (t_far < best_t),
                                      t_far, INF))
            t_s = jnp.where((disc > 0.0) & is_sphere, t_s, INF)
        else:
            t_s = INF

        # --- triangle test (masked) ---
        if T > 0:
            tid = jnp.clip(pid - S, 0, T - 1)
            tri = scene.triangles.vertices[tid]
            v0 = tri[0]
            e1 = tri[1] - tri[0]
            e2 = tri[2] - tri[0]
            pvec = jnp.cross(d, e2)
            det = jnp.dot(e1, pvec)
            inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
            tvec = o - v0
            u = jnp.dot(tvec, pvec) * inv_det
            qvec = jnp.cross(tvec, e1)
            v = jnp.dot(d, qvec) * inv_det
            t_t = jnp.dot(e2, qvec) * inv_det
            ok = ((jnp.abs(det) > 1e-9) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t_t > t_min) & (t_t < best_t)
                  & ~is_sphere)
            t_t = jnp.where(ok, t_t, INF)
        else:
            t_t, u, v = INF, 0.0, 0.0

        sphere_wins = t_s < best_t
        tri_wins = t_t < jnp.minimum(t_s, best_t)
        new_t = jnp.minimum(best_t, jnp.minimum(t_s, t_t))
        new_type = jnp.where(tri_wins, PRIM_TRIANGLE,
                             jnp.where(sphere_wins, PRIM_SPHERE, b_type))
        new_id = jnp.where(tri_wins, pid - S,
                           jnp.where(sphere_wins, pid, b_id))
        new_u = jnp.where(tri_wins, u, jnp.where(sphere_wins, 0.0, b_u))
        new_v = jnp.where(tri_wins, v, jnp.where(sphere_wins, 0.0, b_v))
        return (new_t, new_type, new_id, new_u, new_v)

    return test


def _traverse_single(bvh: LBVH, leaf_test, o, d, t_min, t_max, any_hit: bool):
    """Per-ray stack traversal (vmapped by the caller)."""
    n = bvh.num_prims
    n_internal = n - 1
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d,
                      jnp.sign(d) * 1e12 + jnp.where(d == 0.0, 1e12, 0.0))

    stack = jnp.zeros((STACK_DEPTH,), jnp.int32)
    best = (jnp.float32(t_max), jnp.int32(PRIM_NONE), jnp.int32(0),
            jnp.float32(0.0), jnp.float32(0.0))
    # stack starts holding the root (node 0)
    state = (stack, jnp.int32(1), best)

    def cond(state):
        _, sp, best = state
        not_done = sp > 0
        if any_hit:
            not_done &= best[1] == PRIM_NONE
        return not_done

    def body(state):
        stack, sp, best = state
        node = stack[sp - 1]
        sp = sp - 1

        is_leaf = node >= n_internal

        # --- leaf: test the primitive ---
        pid_sorted = jnp.clip(node - n_internal, 0, n - 1)
        pid = bvh.prim_index[pid_sorted]
        leaf_best = leaf_test(pid, o, d, best)
        best = jax.tree.map(
            lambda new, old: jnp.where(is_leaf, new, old), leaf_best, best)

        # --- internal: test children boxes, push hits (near child last) ---
        node_c = jnp.minimum(node, max(n_internal - 1, 0))
        l = bvh.left[node_c]
        r = bvh.right[node_c]
        lhit, lt = ray_aabb(o, inv_d, bvh.node_min[l], bvh.node_max[l],
                            t_min, best[0])
        rhit, rt = ray_aabb(o, inv_d, bvh.node_min[r], bvh.node_max[r],
                            t_min, best[0])
        # order: push far child first so the near child pops first
        near_is_left = lt <= rt
        first = jnp.where(near_is_left, r, l)    # pushed first (far)
        second = jnp.where(near_is_left, l, r)   # pushed last (near)
        first_hit = jnp.where(near_is_left, rhit, lhit)
        second_hit = jnp.where(near_is_left, lhit, rhit)

        push1 = (~is_leaf) & first_hit
        stack = stack.at[jnp.where(push1, sp, STACK_DEPTH - 1)].set(
            jnp.where(push1, first, stack[STACK_DEPTH - 1]))
        sp = sp + push1.astype(jnp.int32)
        push2 = (~is_leaf) & second_hit
        stack = stack.at[jnp.where(push2, sp, STACK_DEPTH - 1)].set(
            jnp.where(push2, second, stack[STACK_DEPTH - 1]))
        sp = sp + push2.astype(jnp.int32)
        return stack, sp, best

    _, _, best = jax.lax.while_loop(cond, body, state)
    t, ptype, pid, u, v = best
    missed = ptype == PRIM_NONE
    return Hit(t=jnp.where(missed, INF, t), prim_type=ptype, prim_id=pid,
               u=u, v=v)


# Rays per lockstep sub-batch.  Larger launches are split with lax.map,
# which bounds the (R, STACK_DEPTH) live stack memory.
TRAVERSE_CHUNK = 16384


@partial(jax.jit, static_argnames=("any_hit",))
def _traverse_batch(bvh: LBVH, scene: Scene, o, d, t_min, t_max,
                    any_hit: bool = False) -> Hit:
    n = o.shape[0]
    # t bounds may be scalars or per-ray (shadow rays bound by light distance)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    def one(oo, dd, lo, hi):
        leaf_test = _make_leaf_tester(scene, lo)
        return _traverse_single(bvh, leaf_test, oo, dd, lo, hi,
                                any_hit=any_hit)

    vmapped = jax.vmap(one)

    if n <= TRAVERSE_CHUNK:
        return vmapped(o, d, t_min, t_max)
    pad = (-n) % TRAVERSE_CHUNK
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    # padded rays get direction +z and are discarded after
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=0.0)
    d_p = d_p.at[n:, 2].set(1.0) if pad else d_p
    lo_p = jnp.pad(t_min, (0, pad))
    hi_p = jnp.pad(t_max, (0, pad), constant_values=1.0)
    nchunks = (n + pad) // TRAVERSE_CHUNK
    chunks = (o_p.reshape(nchunks, TRAVERSE_CHUNK, 3),
              d_p.reshape(nchunks, TRAVERSE_CHUNK, 3),
              lo_p.reshape(nchunks, TRAVERSE_CHUNK),
              hi_p.reshape(nchunks, TRAVERSE_CHUNK))
    hits = jax.lax.map(lambda c: vmapped(*c), chunks)
    return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:])[:n], hits)


import dataclasses


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVHIntersector:
    """Plain XLA walk of one LBVH over spheres and triangles together.

    The product does not use it: the render loops take the engine of
    ``ops/gpu_traverse.py``, whose off-GPU path walks a triangle-only tree
    after a dense sphere test.  Tests use this one as an independent
    cross-check of that engine and of the integrators.

    BVH arrays are jit arguments (not baked constants), so one compiled
    trace serves every frame of a dynamic scene.  ``bvh=None`` (tiny
    scenes, < 2 primitives) falls back to brute force — the None is part of
    the pytree structure, so jit specializes on it.
    """
    bvh: LBVH | None

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF) -> Hit:
        if self.bvh is None:
            return intersect_scene_bruteforce(scene, o, d, t_min, t_max)
        shape = o.shape[:-1]
        t_min = jnp.asarray(t_min, jnp.float32).reshape(-1) \
            if jnp.ndim(t_min) else t_min
        t_max = jnp.asarray(t_max, jnp.float32).reshape(-1) \
            if jnp.ndim(t_max) else t_max
        hit = _traverse_batch(self.bvh, scene, o.reshape(-1, 3),
                              d.reshape(-1, 3), t_min, t_max)
        return jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]), hit)

    # Keep the plain-callable form for use as ``intersect_fn``.
    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF) -> Hit:
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        if self.bvh is None:
            from optix_ray_tracer_tpu.ops.intersect import intersect_any_bruteforce
            return intersect_any_bruteforce(scene, o, d, t_min, t_max)
        shape = o.shape[:-1]
        t_min = jnp.asarray(t_min, jnp.float32).reshape(-1) \
            if jnp.ndim(t_min) else t_min
        t_max = jnp.asarray(t_max, jnp.float32).reshape(-1) \
            if jnp.ndim(t_max) else t_max
        hit = _traverse_batch(self.bvh, scene, o.reshape(-1, 3),
                              d.reshape(-1, 3), t_min, t_max, any_hit=True)
        return hit.is_hit.reshape(shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BruteForceIntersector:
    """Pytree-compatible brute-force intersector (the oracle)."""

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF) -> Hit:
        return intersect_scene_bruteforce(scene, o, d, t_min, t_max)

    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF) -> Hit:
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        from optix_ray_tracer_tpu.ops.intersect import intersect_any_bruteforce
        return intersect_any_bruteforce(scene, o, d, t_min, t_max)


def make_intersector(scene: Scene, use_bvh: bool = True):
    """The test cross-check for a scene: :class:`BVHIntersector` over all
    its primitives, or brute force (``use_bvh=False`` or < 2 primitives).
    The render loops use ``models.common.choose_intersector`` instead."""
    total = scene.sphere_count + scene.triangle_count
    if not use_bvh or total < 2:
        return BVHIntersector(bvh=None) if total < 2 else BruteForceIntersector()
    return BVHIntersector(bvh=build_scene_lbvh(scene))
