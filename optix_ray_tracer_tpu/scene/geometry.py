"""Scene geometry as static-shape SoA arrays.

The replacement for OptiX GAS inputs (``RendererImpl.cu:113-172`` builds
sphere/triangle GAS from SOA device arrays): geometry stays plain
device-resident arrays that intersection kernels read; acceleration is a
separate, optional LBVH index (``ops/bvh.py``) over the same arrays.

All arrays are float32; triangle vertices/normals are packed (T, 3, 3).
Counts are static under jit — dynamic scenes pad to capacity and mask.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from optix_ray_tracer_tpu.utils.transforms import (
    apply_transform_point, apply_transform_vector, srt_transform,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Spheres:
    """centers (S, 3), radii (S,), material_id (S,) int32."""
    centers: jax.Array
    radii: jax.Array
    material_id: jax.Array

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), jnp.float32),
                       jnp.zeros((0,), jnp.int32))

    @staticmethod
    def from_list(spheres: list[tuple]) -> "Spheres":
        """spheres: [(center, radius, material_id), ...]."""
        if not spheres:
            return Spheres.empty()
        c = np.asarray([s[0] for s in spheres], np.float32)
        r = np.asarray([s[1] for s in spheres], np.float32)
        m = np.asarray([s[2] for s in spheres], np.int32)
        return Spheres(jnp.asarray(c), jnp.asarray(r), jnp.asarray(m))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Triangles:
    """vertices (T, 3, 3), normals (T, 3, 3) per-vertex shading normals,
    material_id (T,) int32, uvs (T, 3, 2) optional texture coordinates
    (None when the scene is untextured).

    Shading normals are barycentric-interpolated at hit time exactly like the
    reference triangle closest-hit (``shader/Shader.cu:139-152``)."""
    vertices: jax.Array
    normals: jax.Array
    material_id: jax.Array
    uvs: jax.Array | None = None

    @property
    def count(self) -> int:
        return self.vertices.shape[0]

    @staticmethod
    def empty() -> "Triangles":
        z = jnp.zeros((0, 3, 3), jnp.float32)
        return Triangles(z, z, jnp.zeros((0,), jnp.int32))

    @staticmethod
    def from_arrays(vertices, normals=None, material_id=0,
                    uvs=None) -> "Triangles":
        vertices = jnp.asarray(vertices, jnp.float32).reshape(-1, 3, 3)
        if normals is None:
            normals = face_normals_as_vertex_normals(vertices)
        else:
            normals = jnp.asarray(normals, jnp.float32).reshape(-1, 3, 3)
        mid = jnp.broadcast_to(jnp.asarray(material_id, jnp.int32),
                               (vertices.shape[0],))
        if uvs is not None:
            uvs = jnp.asarray(uvs, jnp.float32).reshape(-1, 3, 2)
        return Triangles(vertices, normals, mid, uvs)

    def transformed(self, transform) -> "Triangles":
        """Bake a (3, 4) affine into world-space triangles (flatten-instancing)."""
        v = apply_transform_point(transform, self.vertices)
        # normals transform by the inverse-transpose; for rigid SRT with
        # uniform scale the linear part works up to normalization, which the
        # shading path performs anyway.  Use inverse-transpose to be exact.
        linear = transform[..., :, :3]
        inv_t = jnp.linalg.inv(linear).T
        n = jnp.einsum('ij,...j->...i', inv_t, self.normals)
        return Triangles(v, n, self.material_id, self.uvs)

    def concat(self, other: "Triangles") -> "Triangles":
        if (self.uvs is None) != (other.uvs is None):
            uvs = jnp.concatenate([
                self.uvs if self.uvs is not None
                else jnp.zeros((self.count, 3, 2), jnp.float32),
                other.uvs if other.uvs is not None
                else jnp.zeros((other.count, 3, 2), jnp.float32)], 0)
        elif self.uvs is not None:
            uvs = jnp.concatenate([self.uvs, other.uvs], 0)
        else:
            uvs = None
        return Triangles(
            jnp.concatenate([self.vertices, other.vertices], 0),
            jnp.concatenate([self.normals, other.normals], 0),
            jnp.concatenate([self.material_id, other.material_id], 0),
            uvs)


def face_normals_as_vertex_normals(vertices):
    """Per-face geometric normals replicated to the 3 vertices.

    Matches the STL path of the reference, which recomputes cell (face)
    normals via vtkPolyDataNormals (``src/Util/VTKReaderImpl.cpp:254-321``).
    """
    e1 = vertices[:, 1] - vertices[:, 0]
    e2 = vertices[:, 2] - vertices[:, 0]
    n = jnp.cross(e1, e2)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    return jnp.broadcast_to(n[:, None, :], vertices.shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """A renderable world: spheres + triangles + a material table reference.

    This is the flat (single-level) representation used by the brute-force
    and single-BVH paths; instanced scenes (Time mode) either flatten into it
    per frame or use the two-level TLAS path in ``ops/traverse.py``.
    """
    spheres: Spheres
    triangles: Triangles

    @property
    def sphere_count(self) -> int:
        return self.spheres.count

    @property
    def triangle_count(self) -> int:
        return self.triangles.count


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Instances:
    """Two-level scene instancing — replacement for the OptiX IAS
    (``RendererImpl.cu:174-242``).

    transforms:    (I, 3, 4) object->world affines
    inv_transforms:(I, 3, 4) world->object affines (precomputed for traversal)
    shape_id:      (I,) int32 index into a shape library
    material_id:   (I,) int32 material row for every instance
    """
    transforms: jax.Array
    inv_transforms: jax.Array
    shape_id: jax.Array
    material_id: jax.Array

    @property
    def count(self) -> int:
        return self.shape_id.shape[0]

    @staticmethod
    def from_srt(shift, rotate_deg, scale, shape_id, material_id) -> "Instances":
        from optix_ray_tracer_tpu.utils.transforms import invert_transform
        t = srt_transform(jnp.asarray(shift, jnp.float32),
                          jnp.asarray(rotate_deg, jnp.float32),
                          jnp.asarray(scale, jnp.float32))
        return Instances(t, invert_transform(t),
                         jnp.asarray(shape_id, jnp.int32),
                         jnp.asarray(material_id, jnp.int32))


@dataclasses.dataclass(frozen=True)
class ShapeLibrary:
    """A library of triangle meshes sharing one packed buffer.

    Replacement for Time mode's per-STL-shape GAS library built exactly once
    (``src/Global/RendererTime.cu:176-182``): shapes are concatenated into a
    single (T, 3, 3) buffer with (offset, count) ranges so one BVH per shape
    (or one global BVH over instanced AABBs) can index it.
    """
    vertices: jax.Array      # (T, 3, 3) packed
    normals: jax.Array       # (T, 3, 3)
    offsets: np.ndarray      # (num_shapes,) int64 — static, host-side
    counts: np.ndarray       # (num_shapes,) int64 — static, host-side

    @staticmethod
    def from_meshes(meshes: list[tuple[np.ndarray, np.ndarray]]) -> "ShapeLibrary":
        """meshes: list of (vertices (t,3,3), normals (t,3,3))."""
        if not meshes:
            z = jnp.zeros((0, 3, 3), jnp.float32)
            return ShapeLibrary(z, z, np.zeros(0, np.int64), np.zeros(0, np.int64))
        counts = np.asarray([m[0].shape[0] for m in meshes], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        v = jnp.asarray(np.concatenate([np.asarray(m[0], np.float32) for m in meshes], 0))
        n = jnp.asarray(np.concatenate([np.asarray(m[1], np.float32) for m in meshes], 0))
        return ShapeLibrary(v, n, offsets, counts)

    @property
    def num_shapes(self) -> int:
        return len(self.counts)

    def shape(self, i: int) -> Triangles:
        lo = int(self.offsets[i])
        hi = lo + int(self.counts[i])
        return Triangles(self.vertices[lo:hi], self.normals[lo:hi],
                         jnp.zeros((hi - lo,), jnp.int32))

    def flatten_instances(self, instances: Instances,
                          max_triangles: int | None = None) -> Triangles:
        """Bake instances into world-space triangles.

        The per-frame cost is one gather + one batched affine — fully fused
        by XLA; this replaces the reference's CPU transform-update +
        H2D copy + IAS refit per frame (``RendererMesh.cu:379-397``).
        The gather uses a static per-instance triangle budget (the max shape
        size) so the output shape is jit-stable; slots beyond a shape's
        count become degenerate (zero-area) triangles that never hit.
        """
        if self.num_shapes == 0 or instances.count == 0:
            return Triangles.empty()
        budget = int(max_triangles if max_triangles is not None else self.counts.max())
        offsets = jnp.asarray(self.offsets, jnp.int32)
        counts = jnp.asarray(self.counts, jnp.int32)

        shape_ids = instances.shape_id                    # (I,)
        base = offsets[shape_ids]                         # (I,)
        cnt = counts[shape_ids]                           # (I,)
        tri_idx = base[:, None] + jnp.arange(budget, dtype=jnp.int32)[None, :]
        valid = jnp.arange(budget, dtype=jnp.int32)[None, :] < cnt[:, None]
        tri_idx = jnp.where(valid, tri_idx, 0)

        v = self.vertices[tri_idx]                        # (I, B, 3, 3)
        n = self.normals[tri_idx]
        t = instances.transforms[:, None]                 # (I, 1, 3, 4)
        v = apply_transform_point(t[..., None, :, :], v)
        n = apply_transform_vector(t[..., None, :, :], n)
        v = jnp.where(valid[..., None, None], v, 0.0)     # degenerate padding
        mid = jnp.broadcast_to(instances.material_id[:, None], valid.shape)
        return Triangles(v.reshape(-1, 3, 3), n.reshape(-1, 3, 3),
                         mid.reshape(-1).astype(jnp.int32))
