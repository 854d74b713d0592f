"""Debug/validation mode — the ``debug-mode`` config flag made real.

The reference maps ``debug-mode`` to GPU validation layers: OptiX
validation mode (``src/Global/RendererImpl.cu:14``), Vulkan validation
layers + debug messenger (``SDL_VKWindow.cu:354-402``), D3D debug devices.
The equivalents here are:

* ``jax_debug_nans`` — every jitted computation re-runs eagerly on NaN
  production and raises at the producing primitive (the analog of an
  OptiX validation-mode abort on bad values);
* acceleration-structure validation on every build/refit — every leaf
  reachable once and every child box inside its parent's (the analog of
  OptiX validation mode's AS checks).

Enabled once per process from the config flag (``__main__``), checked by
the frontends' intersector builders.
"""

from __future__ import annotations

from optix_ray_tracer_tpu.utils.logging import LOG, RendererError

#: process-wide flag, set by :func:`enable_debug_mode`
DEBUG_MODE = False


def enable_debug_mode() -> None:
    """Turn on validation (RendererImpl.cu:14 analog).  Idempotent."""
    global DEBUG_MODE
    if DEBUG_MODE:
        return
    import jax

    jax.config.update("jax_debug_nans", True)
    DEBUG_MODE = True
    LOG.info("debug-mode: jax_debug_nans on, accel validation on")


def validate_accel(intersector, scene) -> None:
    """Assert the traversal engine fits the scene it is about to trace:

    * its LBVH is well formed (every leaf reachable exactly once, every
      child box inside its parent's);
    * every leaf box bounds the scene's current triangle, and every row of
      the kernel's leaf table holds that triangle's v0, e1, e2 — a refit
      that did not run fails here;
    * every row of the kernel's node table holds its children's boxes and
      ids.

    Raises :class:`RendererError` on a violation (the OptiX
    validation-mode AS-check analog).  Host-side; only runs in debug
    mode, so the cost is opt-in."""
    import numpy as np

    from optix_ray_tracer_tpu.ops.bvh import validate_lbvh

    bvh = intersector.bvh
    report = validate_lbvh(bvh)
    report["triangle_count"] = scene.triangle_count == bvh.num_prims
    if report["triangle_count"]:
        def close(x, y):
            return bool(np.allclose(x, y, rtol=1e-6, atol=1e-6))

        n_internal = bvh.num_prims - 1
        v = np.asarray(scene.triangles.vertices)[np.asarray(bvh.prim_index)]
        nmin, nmax = np.asarray(bvh.node_min), np.asarray(bvh.node_max)
        left, right = np.asarray(bvh.left), np.asarray(bvh.right)
        report["leaf_boxes"] = (close(nmin[n_internal:], v.min(1))
                                and close(nmax[n_internal:], v.max(1)))
        report["leaf_table"] = close(
            np.asarray(intersector.leaves)[:, :9],
            np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1))
        nodes = np.asarray(intersector.nodes)
        ids = np.ascontiguousarray(nodes[:, 12:14]).view(np.int32)
        report["node_table"] = (
            close(nodes[:, :12], np.concatenate(
                [nmin[left], nmax[left], nmin[right], nmax[right]], 1))
            and bool((ids == np.stack([left, right], 1)).all()))
    bad = [k for k, ok in report.items() if not ok]
    if bad:
        raise RendererError(f"accel validation failed: {bad} (debug-mode)")
    LOG.debug("accel validation ok: %d triangles", intersector.num_tris)


def maybe_validate_accel(intersector, scene) -> None:
    """Debug-mode hook called by the frontends on every build/refit."""
    if not DEBUG_MODE or intersector is None:
        return
    validate_accel(intersector, scene)
