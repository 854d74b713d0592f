"""On-device LBVH build — the replacement for OptiX acceleration structures.

The reference delegates BVH construction to opaque OptiX builders
(``optixAccelBuild`` with compaction, ``src/Global/RendererImpl.cu:30-172``)
and traversal to RT cores.  Here a *linear BVH* is built entirely on device
with XLA primitives:

1. primitive AABBs + centroids                         (vectorized)
2. 30-bit Morton codes of centroids in scene bounds    (vectorized)
3. radix sort of codes                                 (XLA ``sort``)
4. Karras-style parallel hierarchy construction        (Karras, HPG 2012:
   "Maximizing Parallelism in the Construction of BVHs, Octrees, and k-d
   Trees" — every internal node found independently via longest-common-
   prefix binary searches; no sequential insertion)
5. bottom-up AABB fitting by fixed-point iteration     (level passes)

Everything is jittable: builds run per file and refits (step 5 alone, on
the fixed topology) per frame, the reference's policy
(RendererImpl.cu:210-242).

Node layout (unified array of 2n-1 nodes):
  index 0 .. n-2   : internal nodes
  index n-1 .. 2n-2: leaves; leaf k (node n-1+k) holds sorted primitive k
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.scene.geometry import Scene
from optix_ray_tracer_tpu.utils.vecmath import INF


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LBVH:
    """Flat LBVH over a primitive soup.

    node_min/max: (2n-1, 3) — AABBs for every node (internal + leaf)
    left/right:   (n-1,)    — child node indices (into the unified array)
    prim_index:   (n,)      — sorted-leaf-order -> original primitive id
    """
    node_min: jax.Array
    node_max: jax.Array
    left: jax.Array
    right: jax.Array
    prim_index: jax.Array

    @property
    def num_prims(self) -> int:
        return self.prim_index.shape[0]


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------

def _expand_bits_10(v):
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes(points, lo, hi):
    """30-bit Morton codes for (N, 3) points inside AABB [lo, hi]."""
    extent = jnp.maximum(hi - lo, 1e-30)
    q = jnp.clip((points - lo) / extent, 0.0, 1.0)
    grid = jnp.minimum((q * 1024.0).astype(jnp.uint32), 1023)
    return ((_expand_bits_10(grid[..., 0]) << 2)
            | (_expand_bits_10(grid[..., 1]) << 1)
            | _expand_bits_10(grid[..., 2]))


# ---------------------------------------------------------------------------
# Primitive bounds
# ---------------------------------------------------------------------------

def scene_primitive_bounds(scene: Scene):
    """AABBs + centroids for the unified primitive soup.

    Primitive ids: [0, S) spheres, [S, S+T) triangles — the index tagging
    that replaces the reference's SBT-offset dispatch.
    Returns (mins (P,3), maxs (P,3), centroids (P,3)).
    """
    parts_min, parts_max, parts_c = [], [], []
    if scene.sphere_count > 0:
        c = scene.spheres.centers
        r = scene.spheres.radii[..., None]
        parts_min.append(c - r)
        parts_max.append(c + r)
        parts_c.append(c)
    if scene.triangle_count > 0:
        v = scene.triangles.vertices
        parts_min.append(jnp.min(v, axis=1))
        parts_max.append(jnp.max(v, axis=1))
        parts_c.append(jnp.mean(v, axis=1))
    mins = jnp.concatenate(parts_min, 0)
    maxs = jnp.concatenate(parts_max, 0)
    cents = jnp.concatenate(parts_c, 0)
    return mins, maxs, cents


# ---------------------------------------------------------------------------
# Karras hierarchy
# ---------------------------------------------------------------------------

def _delta_fn(codes, n):
    """delta(i, j): common-prefix length between sorted keys i and j,
    with the index appended as tiebreak (Karras sec. 4: conceptually augment
    each key with its index so all keys are distinct).  Out-of-range -> -1."""
    def delta(i, j):
        in_range = (j >= 0) & (j <= n - 1)
        j_c = jnp.clip(j, 0, n - 1)
        ci = codes[i]
        cj = codes[j_c]
        same = ci == cj
        x = jnp.where(same,
                      i.astype(jnp.uint32) ^ j_c.astype(jnp.uint32),
                      ci ^ cj)
        base = jnp.where(same, 32, 0)
        d = base + jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)
        return jnp.where(in_range, d, -1)
    return delta


def build_hierarchy(codes):
    """Parallel Karras construction over sorted morton codes (n >= 2).

    Returns (left, right) child arrays of length n-1; children are unified
    node indices (< n-1 internal, >= n-1 leaf)."""
    n = codes.shape[0]
    delta = _delta_fn(codes, n)
    i = jnp.arange(n - 1, dtype=jnp.int32)

    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # upper bound for range length: double until prefix drops to <= delta_min
    def grow(carry, _):
        lmax = carry
        cond = delta(i, i + lmax * d) > delta_min
        return jnp.where(cond, lmax * 2, lmax), None
    lmax, _ = jax.lax.scan(grow, jnp.full_like(i, 2), None, length=32)

    # binary search the exact other end j = i + l*d
    def shrink(carry, shift):
        l = carry
        t = lmax >> shift
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        return jnp.where(cond, l + t, l), None
    shifts = jnp.arange(1, 33, dtype=jnp.int32)
    l, _ = jax.lax.scan(shrink, jnp.zeros_like(i), shifts)
    j = i + l * d
    delta_node = delta(i, j)

    # binary search the split position
    def split_step(carry, shift):
        s, t_prev = carry
        t = (l + (1 << shift) - 1) >> shift  # ceil(l / 2^shift)
        cond = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        return (jnp.where(cond, s + t, s), t), None
    (s, _), _ = jax.lax.scan(split_step, (jnp.zeros_like(i), l),
                             jnp.arange(1, 33, dtype=jnp.int32))
    gamma = i + s * d + jnp.minimum(d, 0)

    n_internal = n - 1
    left_is_leaf = jnp.minimum(i, j) == gamma
    right_is_leaf = jnp.maximum(i, j) == gamma + 1
    left = jnp.where(left_is_leaf, gamma + n_internal, gamma)
    right = jnp.where(right_is_leaf, gamma + 1 + n_internal, gamma + 1)
    return left, right


def fit_aabbs(left, right, leaf_min, leaf_max, max_passes: int = 64):
    """Bottom-up AABB fitting by fixed-point iteration.

    Each pass recomputes every internal node's box as the union of its
    children's current boxes; after depth(t) passes the tree is exact.  LBVH
    depth is bounded by the augmented key length (30 morton bits + 32 index
    tiebreak), so 64 passes always converge; the while_loop exits early for
    the (typical) ~2*log2(n) depth."""
    n = leaf_min.shape[0]
    n_internal = n - 1
    node_min = jnp.concatenate(
        [jnp.full((n_internal, 3), INF, jnp.float32), leaf_min], 0)
    node_max = jnp.concatenate(
        [jnp.full((n_internal, 3), -INF, jnp.float32), leaf_max], 0)

    def body(state):
        node_min, node_max, it, changed = state
        lmin = node_min[left]
        lmax = node_max[left]
        rmin = node_min[right]
        rmax = node_max[right]
        new_min = jnp.minimum(lmin, rmin)
        new_max = jnp.maximum(lmax, rmax)
        changed = jnp.any(new_min != node_min[:n_internal]) | \
            jnp.any(new_max != node_max[:n_internal])
        node_min = node_min.at[:n_internal].set(new_min)
        node_max = node_max.at[:n_internal].set(new_max)
        return node_min, node_max, it + 1, changed

    def cond(state):
        _, _, it, changed = state
        return (it < max_passes) & changed

    node_min, node_max, _, _ = jax.lax.while_loop(
        cond, body, (node_min, node_max, jnp.int32(0), jnp.bool_(True)))
    return node_min, node_max


@jax.jit
def build_lbvh(prim_min, prim_max, centroids) -> LBVH:
    """Full LBVH build from primitive bounds.  n >= 2 required."""
    n = centroids.shape[0]
    scene_lo = jnp.min(prim_min, axis=0)
    scene_hi = jnp.max(prim_max, axis=0)
    codes = morton_codes(centroids, scene_lo, scene_hi)

    order = jnp.argsort(codes)
    codes_sorted = codes[order]
    left, right = build_hierarchy(codes_sorted)
    node_min, node_max = fit_aabbs(left, right,
                                   prim_min[order], prim_max[order])
    return LBVH(node_min=node_min, node_max=node_max, left=left, right=right,
                prim_index=order.astype(jnp.int32))


def build_scene_lbvh(scene: Scene) -> LBVH:
    mins, maxs, cents = scene_primitive_bounds(scene)
    return build_lbvh(mins, maxs, cents)


# ---------------------------------------------------------------------------
# Validation helpers (used by property tests)
# ---------------------------------------------------------------------------

def lbvh_depth(bvh: LBVH) -> int:
    """Levels of internal nodes on the longest root-to-leaf path — the
    most entries a per-ray traversal stack can hold (host side)."""
    import numpy as np
    n_internal = bvh.num_prims - 1
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    frontier = np.zeros(1, np.int64) if n_internal > 0 else np.zeros(0)
    depth = 0
    while frontier.size:
        depth += 1
        kids = np.concatenate([left[frontier], right[frontier]])
        frontier = kids[kids < n_internal]
    return depth


def validate_lbvh(bvh: LBVH) -> dict:
    """Host-side structural checks: every leaf reachable exactly once and
    every child box contained in its parent box."""
    import numpy as np
    n = bvh.num_prims
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)

    visits = np.zeros(2 * n - 1, np.int64)
    containment_ok = True
    stack = [0] if n > 1 else []
    while stack:
        node = stack.pop()
        visits[node] += 1
        if node < n - 1:
            for ch in (left[node], right[node]):
                containment_ok &= bool(
                    (nmin[node] <= nmin[ch] + 1e-5).all()
                    and (nmax[node] >= nmax[ch] - 1e-5).all())
                stack.append(int(ch))
    leaf_visits = visits[n - 1:]
    return dict(
        all_leaves_once=bool((leaf_visits == 1).all()),
        internals_once=bool((visits[:n - 1] <= 1).all()),
        containment=containment_ok,
        permutation=bool(
            np.sort(np.asarray(bvh.prim_index)).tolist() == list(range(n))),
    )
