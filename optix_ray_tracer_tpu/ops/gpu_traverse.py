"""Per-ray BVH traversal: the intersection engine for triangle scenes.

The reference traverses per ray: every thread walks the acceleration
structure for its own ray (``optixTrace`` in ``shader/Shader.cu:46-92``; on
a card without RT cores OptiX runs that walk in software on the SMs).  This
engine does the same on the GPU with one Pallas kernel (Triton route) in
which each lane owns one ray:

* the LBVH of ``ops/bvh.py`` over the scene's triangles, with each internal
  node's two child boxes and child ids packed in one 64-byte row, so a visit
  is one node fetch;
* an ordered walk: the nearer hit child continues in registers, the farther
  one goes on a per-lane stack in device memory;
* a leaf holds one triangle and is tested as soon as its box is hit, with
  the arithmetic of ``ray_triangle_block`` (``ops/intersect.py``);
* the scene's analytic spheres (a handful of config extras) are tested
  densely first and bound the walk, in the order in which the brute-force
  oracle merges them (spheres win exact ties);
* shadow rays (``any_hit``) stop at their first hit.

Off the GPU the same BVH is walked by the plain XLA traversal
(``ops/traverse.py``).  Tests run the kernel itself with ``interpret=True``.

Acceleration-structure policy follows the reference (``RendererImpl.cu:
30-242``): build once per file (:func:`rebuild`), refit every frame on the
fixed topology (:func:`refit`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from optix_ray_tracer_tpu.ops.bvh import (
    LBVH, build_lbvh, fit_aabbs, scene_primitive_bounds,
)
from optix_ray_tracer_tpu.ops.intersect import (
    DEFAULT_T_MIN, Hit, PRIM_NONE, PRIM_SPHERE, PRIM_TRIANGLE,
    ray_sphere_block,
)
from optix_ray_tracer_tpu.ops.traverse import STACK_DEPTH, _traverse_batch
from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres
from optix_ray_tracer_tpu.utils.vecmath import INF

#: rays per kernel program (one ray per thread: 2 warps)
BLOCK = 64
NUM_WARPS = 2
_ROW = 16     # floats per node row and per leaf row (64 bytes)


def node_table(bvh: LBVH):
    """(n-1, 16) float32: left box (min, max), right box, then the two
    child ids bit-cast to float32."""
    l, r = bvh.left, bvh.right
    ids = jax.lax.bitcast_convert_type(jnp.stack([l, r], 1), jnp.float32)
    pad = jnp.zeros((l.shape[0], _ROW - 14), jnp.float32)
    return jnp.concatenate([bvh.node_min[l], bvh.node_max[l],
                            bvh.node_min[r], bvh.node_max[r], ids, pad], 1)


def leaf_table(bvh: LBVH, vertices):
    """(n, 16) float32 in sorted-leaf order: v0, e1 = v1 - v0, e2 = v2 - v0
    (the oracle's edge arithmetic, so the kernel's t matches it)."""
    v = vertices[bvh.prim_index]
    pad = jnp.zeros((v.shape[0], _ROW - 9), jnp.float32)
    return jnp.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                            pad], 1)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _gather(ref, row, col, mask, other=0.0):
    return plt.load(ref.at[row, col], mask=mask, other=other)


def _slab(o, inv_d, bmin, bmax, t_min, t_max):
    """Ray/box slab test on per-lane scalars; returns (hit, t_enter)."""
    lo = [None] * 3
    hi = [None] * 3
    for k in range(3):
        t0 = (bmin[k] - o[k]) * inv_d[k]
        t1 = (bmax[k] - o[k]) * inv_d[k]
        lo[k] = jnp.minimum(t0, t1)
        hi[k] = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.maximum(jnp.maximum(lo[0], lo[1]), lo[2]), t_min)
    t_exit = jnp.minimum(jnp.minimum(jnp.minimum(hi[0], hi[1]), hi[2]), t_max)
    return t_enter <= t_exit, t_enter


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _triangle(o, d, v0, e1, e2, t_min, t_max, eps=1e-9):
    """Moller-Trumbore with ``ray_triangle_block``'s operation order."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max))
    return ok, t, u, v


def _kernel(o_ref, d_ref, lo_ref, hi_ref, nodes_ref, leaves_ref, sph_ref,
            t_ref, kind_ref, idx_ref, u_ref, v_ref, stack_ref, *,
            rpad: int, n_internal: int, n_spheres: int, any_hit: bool):
    ray = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    o = tuple(o_ref[k, ray] for k in range(3))
    d = tuple(d_ref[k, ray] for k in range(3))
    t_min = lo_ref[ray]
    t_max = hi_ref[ray]
    inv_d = tuple(
        jnp.where(jnp.abs(x) > 1e-12, 1.0 / x,
                  jnp.sign(x) * 1e12 + jnp.where(x == 0.0, 1e12, 0.0))
        for x in d)

    zero_i = jnp.zeros((BLOCK,), jnp.int32)
    zero_f = jnp.zeros((BLOCK,), jnp.float32)
    best_t = jnp.full((BLOCK,), INF, jnp.float32)
    kind = zero_i
    idx = zero_i

    if n_spheres:
        # ray_sphere_block's arithmetic, nearest root else far root
        a = _dot(d, d)
        inv_a = 1.0 / a

        def sphere(s, carry):
            best_t, kind, idx = carry
            oc = tuple(o[k] - sph_ref[s, k] for k in range(3))
            r = sph_ref[s, 3]
            half_b = _dot(oc, d)
            c = _dot(oc, oc) - r * r
            disc = half_b * half_b - a * c
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            t_near = (-half_b - sq) * inv_a
            t_far = (-half_b + sq) * inv_a
            ts = jnp.where((t_near > t_min) & (t_near < t_max), t_near,
                           jnp.where((t_far > t_min) & (t_far < t_max),
                                     t_far, INF))
            ts = jnp.where(disc > 0.0, ts, INF)
            closer = ts < best_t
            return (jnp.where(closer, ts, best_t),
                    jnp.where(closer, PRIM_SPHERE, kind),
                    jnp.where(closer, s, idx))

        best_t, kind, idx = jax.lax.fori_loop(0, n_spheres, sphere,
                                              (best_t, kind, idx))

    alive = t_max > t_min
    if any_hit:
        alive = alive & (kind == PRIM_NONE)
    bound = jnp.minimum(best_t, t_max)

    def leaf(child, go, state):
        bound, kind, idx, u, v = state
        k = child - n_internal
        row = [_gather(leaves_ref, k, c, go) for c in range(9)]
        ok, t, tu, tv = _triangle(o, d, row[0:3], row[3:6], row[6:9],
                                  t_min, bound)
        ok = ok & go
        return (jnp.where(ok, t, bound),
                jnp.where(ok, PRIM_TRIANGLE, kind),
                jnp.where(ok, k, idx),
                jnp.where(ok, tu, u), jnp.where(ok, tv, v))

    def cond(carry):
        return jnp.max(carry[2].astype(jnp.int32)) > 0

    def body(carry):
        node, sp, alive, *state = carry
        row = [_gather(nodes_ref, node, c, alive) for c in range(12)]
        ids = [jax.lax.bitcast_convert_type(
            _gather(nodes_ref, node, 12 + c, alive), jnp.int32)
            for c in range(2)]
        left, right = ids
        l_hit, l_t = _slab(o, inv_d, row[0:3], row[3:6], t_min, state[0])
        r_hit, r_t = _slab(o, inv_d, row[6:9], row[9:12], t_min, state[0])
        l_hit = l_hit & alive
        r_hit = r_hit & alive
        l_leaf = left >= n_internal
        r_leaf = right >= n_internal
        state = leaf(left, l_hit & l_leaf, state)
        state = leaf(right, r_hit & r_leaf, state)
        bound = state[0]
        l_go = l_hit & ~l_leaf & (l_t <= bound)
        r_go = r_hit & ~r_leaf & (r_t <= bound)
        both = l_go & r_go
        near_left = l_t <= r_t
        far = jnp.where(near_left, right, left)
        push = both & (sp < STACK_DEPTH)
        plt.store(stack_ref.at[sp * rpad + ray], far, mask=push)
        sp = sp + push.astype(jnp.int32)
        nxt = jnp.where(both, jnp.where(near_left, left, right),
                        jnp.where(l_go, left, right))
        descend = l_go | r_go
        pop = alive & ~descend & (sp > 0)
        popped = plt.load(stack_ref.at[jnp.maximum(sp - 1, 0) * rpad + ray],
                          mask=pop, other=0)
        sp = sp - pop.astype(jnp.int32)
        node = jnp.where(descend, nxt, popped)
        alive = descend | pop
        if any_hit:
            alive = alive & (state[1] == PRIM_NONE)
        return (node, sp, alive, *state)

    carry = (zero_i, zero_i, alive, bound, kind, idx, zero_f, zero_f)
    _, _, _, bound, kind, idx, u, v = jax.lax.while_loop(cond, body, carry)
    t_ref[ray] = jnp.where(kind == PRIM_NONE, INF, bound)
    kind_ref[ray] = kind
    idx_ref[ray] = idx
    u_ref[ray] = u
    v_ref[ray] = v


@partial(jax.jit, static_argnames=("any_hit", "interpret"))
def trace_kernel(nodes, leaves, prim_index, spheres: Spheres, o, d, t_min,
                 t_max, *, any_hit: bool = False,
                 interpret: bool = False) -> Hit:
    """Launch the traversal kernel on (R, 3) rays with per-ray (R,) bounds.

    Pads R to a multiple of :data:`BLOCK` with dead rays (t_max = t_min),
    lays rays out per component, and maps sorted-leaf hits back to
    triangle ids."""
    n = o.shape[0]
    rpad = -(-max(n, 1) // BLOCK) * BLOCK
    pad = rpad - n
    o_t = jnp.pad(o, ((0, pad), (0, 0))).T
    d_t = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0).T
    lo = jnp.pad(t_min, (0, pad))
    hi = jnp.pad(t_max, (0, pad))
    n_spheres = spheres.count
    sph = (jnp.concatenate([spheres.centers, spheres.radii[:, None]], 1)
           if n_spheres else jnp.zeros((1, 4), jnp.float32))
    f32 = jax.ShapeDtypeStruct((rpad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((rpad,), jnp.int32)
    kernel = partial(_kernel, rpad=rpad, n_internal=nodes.shape[0],
                     n_spheres=n_spheres, any_hit=any_hit)
    t, kind, idx, u, v, _ = pl.pallas_call(
        kernel,
        out_shape=(f32, i32, i32, f32, f32,
                   jax.ShapeDtypeStruct((STACK_DEPTH * rpad,), jnp.int32)),
        grid=(rpad // BLOCK,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="bvh_traverse",
    )(o_t, d_t, lo, hi, nodes, leaves, sph)
    tri = kind == PRIM_TRIANGLE
    prim_id = jnp.where(tri, prim_index[jnp.where(tri, idx, 0)], idx)
    return Hit(t=t[:n], prim_type=kind[:n], prim_id=prim_id[:n], u=u[:n],
               v=v[:n])


def trace_xla(bvh: LBVH, scene: Scene, o, d, t_min, t_max,
              any_hit: bool = False) -> Hit:
    """The plain XLA twin: spheres densely first, then the triangle LBVH
    walk of ``ops/traverse.py`` bounded by the sphere hit."""
    tris = Scene(spheres=Spheres.empty(), triangles=scene.triangles)
    if scene.sphere_count == 0:
        return _traverse_batch(bvh, tris, o, d, t_min, t_max, any_hit=any_hit)
    ts = ray_sphere_block(o, d, scene.spheres.centers, scene.spheres.radii,
                          t_min, t_max)                         # (R, S)
    si = jnp.argmin(ts, axis=-1).astype(jnp.int32)
    st = jnp.take_along_axis(ts, si[:, None], -1)[:, 0]
    hit = _traverse_batch(bvh, tris, o, d, t_min, jnp.minimum(t_max, st),
                          any_hit=any_hit)
    sph = ~hit.is_hit & (st < INF)
    zero = jnp.zeros_like(hit.u)
    return Hit(t=jnp.where(sph, st, hit.t),
               prim_type=jnp.where(sph, PRIM_SPHERE, hit.prim_type),
               prim_id=jnp.where(sph, si, hit.prim_id),
               u=jnp.where(sph, zero, hit.u), v=jnp.where(sph, zero, hit.v))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _per_ray(t, n):
    """Scalar or per-ray (any shape) bound -> (n,) float32."""
    t = jnp.asarray(t, jnp.float32)
    return jnp.broadcast_to(t.reshape(-1) if t.ndim else t, (n,))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TraversalIntersector:
    """Triangle LBVH + its kernel tables, as a pytree of jit arguments.

    ``interpret`` (static) runs the kernel in Pallas interpret mode; tests
    set it.  Otherwise the platform decides at lowering time: the kernel
    on CUDA, the plain XLA walk of the same BVH everywhere else.
    """
    bvh: LBVH
    nodes: jax.Array
    leaves: jax.Array
    interpret: bool = dataclasses.field(default=False,
                                        metadata=dict(static=True))

    @property
    def num_tris(self) -> int:
        return self.bvh.num_prims

    def _query(self, scene: Scene, o, d, t_min, t_max, any_hit: bool) -> Hit:
        shape = o.shape[:-1]
        o2 = o.reshape(-1, 3).astype(jnp.float32)
        d2 = d.reshape(-1, 3).astype(jnp.float32)
        lo, hi = (_per_ray(t, o2.shape[0]) for t in (t_min, t_max))

        def kernel(o2, d2, lo, hi, interpret=False):
            return trace_kernel(self.nodes, self.leaves, self.bvh.prim_index,
                                scene.spheres, o2, d2, lo, hi,
                                any_hit=any_hit, interpret=interpret)

        def xla(o2, d2, lo, hi):
            return trace_xla(self.bvh, scene, o2, d2, lo, hi, any_hit=any_hit)

        hit = self._dispatch(kernel, xla, o2, d2, lo, hi)
        return jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]), hit)

    def _dispatch(self, kernel, xla, *args) -> Hit:
        if self.interpret:
            return kernel(*args, interpret=True)
        return jax.lax.platform_dependent(*args, cuda=kernel, default=xla)

    def intersect(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                  t_max=INF) -> Hit:
        return self._query(scene, o, d, t_min, t_max, any_hit=False)

    def __call__(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN,
                 t_max=INF) -> Hit:
        return self.intersect(scene, o, d, t_min, t_max)

    def any_hit(self, scene: Scene, o, d, t_min=DEFAULT_T_MIN, t_max=INF):
        return self._query(scene, o, d, t_min, t_max, any_hit=True).is_hit


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class XlaTwin(TraversalIntersector):
    """The engine with its plain XLA walk (:func:`trace_xla`) on every
    platform, the GPU included: what the kernel is timed against."""

    def _dispatch(self, kernel, xla, *args) -> Hit:
        return xla(*args)


def xla_twin(engine: TraversalIntersector) -> XlaTwin:
    """``engine`` as its off-GPU path, runnable on the card."""
    return XlaTwin(bvh=engine.bvh, nodes=engine.nodes, leaves=engine.leaves)


def _tables(bvh: LBVH, scene: Scene, interpret: bool) -> TraversalIntersector:
    return TraversalIntersector(
        bvh=bvh, nodes=node_table(bvh),
        leaves=leaf_table(bvh, scene.triangles.vertices),
        interpret=interpret)


def build(scene: Scene, interpret: bool = False) -> TraversalIntersector:
    """Fresh LBVH over the scene's triangles (>= 2); jittable."""
    if scene.triangle_count < 2:
        raise ValueError("the traversal engine needs >= 2 triangles; "
                         "smaller scenes use brute force")
    tris = Scene(spheres=Spheres.empty(), triangles=scene.triangles)
    return _tables(build_lbvh(*scene_primitive_bounds(tris)), scene,
                   interpret)


@jax.jit
def refit(prev: TraversalIntersector, scene: Scene) -> TraversalIntersector:
    """Per-frame refit: the previous topology with boxes refitted to the
    scene's current vertices (the updateIAS/refit analog,
    ``RendererImpl.cu:210-242``)."""
    bvh = prev.bvh
    v = scene.triangles.vertices[bvh.prim_index]
    node_min, node_max = fit_aabbs(bvh.left, bvh.right, jnp.min(v, axis=1),
                                   jnp.max(v, axis=1))
    bvh = LBVH(node_min=node_min, node_max=node_max, left=bvh.left,
               right=bvh.right, prim_index=bvh.prim_index)
    return _tables(bvh, scene, prev.interpret)


@jax.jit
def rebuild(prev: TraversalIntersector, scene: Scene) -> TraversalIntersector:
    """Per-file rebuild on device (fresh Morton order), same shapes as
    ``prev`` so one compiled render serves every file."""
    return build(scene, prev.interpret)
