"""The per-ray traversal engine (ops/gpu_traverse.py) against the
brute-force oracle.

Both of its paths run here: the Pallas kernel itself in interpret mode
(``interpret=True``) and the plain XLA twin that the engine lowers to off
the GPU.  Nearest hits must agree on primitive id and type except on exact
fp ties (distances equal to 1e-5 relative + 1e-6); any-hit results must be
equal.  Sizes stay small (<= 256 rays, <= 1k triangles) because the
interpreter is slow.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optix_ray_tracer_tpu.ops import gpu_traverse
from optix_ray_tracer_tpu.ops.intersect import (
    PRIM_SPHERE, PRIM_TRIANGLE, intersect_scene_bruteforce,
)
from optix_ray_tracer_tpu.scene.camera import Camera
from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles

INF = 1e16
SCENES = ("triangles", "triangles_spheres", "degenerate", "two_triangles")
WAVES = ("camera", "point_shadow", "sun_shadow", "random", "surface",
         "dead_lanes", "odd_count")
ENGINES = ("kernel", "xla")


@functools.lru_cache(maxsize=None)
def make_scene(name: str) -> Scene:
    from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles

    rng = np.random.default_rng(3)
    if name == "two_triangles":
        v = np.asarray([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                        [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float32)
        return Scene(spheres=Spheres.empty(),
                     triangles=Triangles.from_arrays(v))
    v, _ = sphere_with_n_triangles(500)
    c = rng.uniform(-1.6, 1.6, (120, 1, 3))
    loose = (c + rng.normal(0.0, 0.2, (120, 3, 3))).astype(np.float32)
    v = np.concatenate([v, loose]).astype(np.float32)
    if name == "degenerate":
        k = np.arange(len(v)) % 3
        v = v.copy()
        v[k == 0, 1] = v[k == 0, 0]                          # repeated vertex
        v[k == 1, 2] = 2.0 * v[k == 1, 1] - v[k == 1, 0]     # collinear
    spheres = Spheres.empty()
    if name == "triangles_spheres":
        spheres = Spheres.from_list([((0.0, 0.0, -101.0), 100.0, 0),
                                     ((0.6, 0.6, 1.1), 0.3, 0),
                                     ((0.0, 0.0, 0.0), 0.5, 0)])
    return Scene(spheres=spheres, triangles=Triangles.from_arrays(v))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def make_wave(scene_name: str, wave: str):
    """(o, d, t_min, t_max, any_hit) for one wave class."""
    scene = make_scene(scene_name)
    rng = np.random.default_rng(7)
    cam = Camera.look_at((3.0, 0.4, 0.8), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o_c, d_c = (np.asarray(a).reshape(-1, 3)
                for a in cam.generate_rays(16, 12))
    n = o_c.shape[0]
    ones = np.ones(n, np.float32)
    if wave == "camera":
        return o_c, d_c, 1e-3 * ones, INF * ones, False
    if wave in ("random", "dead_lanes", "odd_count"):
        m = 67 if wave == "odd_count" else 200
        o = rng.uniform(-1.8, 1.8, (m, 3)).astype(np.float32)
        d = _unit(rng.normal(size=(m, 3)))
        t_max = np.full(m, INF, np.float32)
        if wave == "dead_lanes":
            t_max[::2] = 0.0
        return o, d, np.full(m, 1e-3, np.float32), t_max, False
    hit = intersect_scene_bruteforce(scene, jnp.asarray(o_c),
                                     jnp.asarray(d_c))
    t = np.where(np.asarray(hit.is_hit), np.asarray(hit.t), 2.0)
    p = (o_c + t[:, None] * d_c).astype(np.float32)
    if wave == "point_shadow":
        to_light = np.asarray([2.0, 2.0, 2.5], np.float32) - p
        dist = np.linalg.norm(to_light, axis=-1).astype(np.float32)
        wl = _unit(to_light)
        return p + 1e-3 * wl, wl, 1e-4 * ones, dist - 2e-3, True
    if wave == "sun_shadow":
        sun = np.broadcast_to(_unit(np.asarray([0.3, 0.4, 0.866])), p.shape)
        return p + 1e-3 * sun, np.ascontiguousarray(sun), 1e-4 * ones, \
            INF * ones, True
    assert wave == "surface"
    # rays starting ON the surface (no offset): the t_min guard decides
    return p, _unit(rng.normal(size=p.shape)), 1e-3 * ones, INF * ones, False


def make_engine(scene: Scene, engine: str):
    return gpu_traverse.build(scene, interpret=(engine == "kernel"))


def assert_nearest_agrees(hit, ref):
    t, t_ref = np.asarray(hit.t), np.asarray(ref.t)
    same = (np.asarray(hit.prim_id) == np.asarray(ref.prim_id)) \
        & (np.asarray(hit.prim_type) == np.asarray(ref.prim_type))
    tie = np.abs(t - t_ref) <= 1e-5 * np.abs(t_ref) + 1e-6
    assert (same | tie).all(), f"{int((~(same | tie)).sum())} rays disagree"
    hit_mask = np.asarray(ref.is_hit) & same
    # same primitive: t to float32 round-off of the two operation orders
    # (the radius-100 ground sphere's quadratic cancels ~4 digits)
    np.testing.assert_allclose(t[hit_mask], t_ref[hit_mask], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(hit.u)[hit_mask],
                               np.asarray(ref.u)[hit_mask], atol=1e-4)
    np.testing.assert_allclose(np.asarray(hit.v)[hit_mask],
                               np.asarray(ref.v)[hit_mask], atol=1e-4)
    assert (t[~np.asarray(ref.is_hit)] >= INF).all()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("scene_name", SCENES)
def test_matches_bruteforce(scene_name, wave, engine):
    scene = make_scene(scene_name)
    o, d, t_min, t_max, any_hit = (jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in make_wave(scene_name, wave))
    eng = make_engine(scene, engine)
    ref = intersect_scene_bruteforce(scene, o, d, t_min, t_max)
    if any_hit:
        got = eng.any_hit(scene, o, d, t_min=t_min, t_max=t_max)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(ref.is_hit))
    else:
        assert_nearest_agrees(eng.intersect(scene, o, d, t_min, t_max), ref)
    if wave == "dead_lanes":
        h = eng.intersect(scene, o, d, t_min, t_max)
        assert not np.asarray(h.is_hit)[::2].any()


def _moved(scene: Scene) -> Scene:
    v = scene.triangles.vertices
    v = v + 0.1 * jnp.sin(3.0 * v[..., jnp.array([2, 0, 1])]) \
        + jnp.asarray([0.05, -0.02, 0.03])
    return Scene(spheres=scene.spheres,
                 triangles=dataclasses.replace(scene.triangles, vertices=v))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("update", ("refit", "rebuild"))
def test_update_after_motion(update, engine):
    """Per-frame refit keeps the topology and refits the boxes; per-file
    rebuild re-sorts; both must track moved vertices exactly."""
    scene = make_scene("triangles_spheres")
    eng = make_engine(scene, engine)
    moved = _moved(scene)
    new = getattr(gpu_traverse, update)(eng, moved)
    assert new.interpret == eng.interpret
    if update == "refit":
        np.testing.assert_array_equal(np.asarray(new.bvh.left),
                                      np.asarray(eng.bvh.left))
    o, d, t_min, t_max, _ = (jnp.asarray(a) if isinstance(a, np.ndarray)
                             else a for a in make_wave("triangles_spheres",
                                                       "random"))
    ref = intersect_scene_bruteforce(moved, o, d, t_min, t_max)
    assert_nearest_agrees(new.intersect(moved, o, d, t_min, t_max), ref)
    # the stale engine really is stale: the motion changes some hits
    old = eng.intersect(moved, o, d, t_min, t_max)
    assert (np.asarray(old.prim_id) != np.asarray(ref.prim_id)).any()


@pytest.mark.parametrize("engine", ENGINES)
def test_wrapper_shapes_and_bounds(engine):
    """Leading ray dims are kept, scalar and per-ray bounds both work, and
    the hit record has the oracle's dtypes."""
    scene = make_scene("triangles")
    eng = make_engine(scene, engine)
    o, d, *_ = make_wave("triangles", "random")
    o = jnp.asarray(o[:60]).reshape(4, 15, 3)
    d = jnp.asarray(d[:60]).reshape(4, 15, 3)
    hit = eng.intersect(scene, o, d)
    assert hit.t.shape == hit.prim_id.shape == hit.u.shape == (4, 15)
    assert hit.t.dtype == jnp.float32 and hit.prim_id.dtype == jnp.int32
    assert hit.prim_type.dtype == jnp.int32
    per_ray = eng.intersect(scene, o, d, t_max=jnp.full((4, 15), INF))
    np.testing.assert_array_equal(np.asarray(per_ray.prim_id),
                                  np.asarray(hit.prim_id))
    blocked = eng.any_hit(scene, o, d, t_max=0.5)
    assert blocked.shape == (4, 15) and blocked.dtype == jnp.bool_
    ref = intersect_scene_bruteforce(scene, o, d, t_max=0.5)
    np.testing.assert_array_equal(np.asarray(blocked),
                                  np.asarray(ref.is_hit))


def test_kernel_pads_to_block():
    """Ray counts off the block size pad with dead lanes that are cut off
    again; one ray and one block plus one agree with the oracle."""
    scene = make_scene("triangles")
    eng = make_engine(scene, "kernel")
    o, d, *_ = make_wave("triangles", "random")
    for n in (1, gpu_traverse.BLOCK + 1):
        oo, dd = jnp.asarray(o[:n]), jnp.asarray(d[:n])
        hit = eng.intersect(scene, oo, dd)
        assert hit.t.shape == (n,)
        assert_nearest_agrees(hit, intersect_scene_bruteforce(scene, oo, dd))


@pytest.mark.parametrize("engine", ENGINES)
def test_sphere_wins_exact_tie(engine):
    """A triangle lying in the tangent plane of a sphere is hit at the
    same t as the sphere: the oracle merges spheres first, so the sphere
    wins, and the engine tests spheres first with the same rule."""
    v = np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]],
                    [[-1, -1, 3], [1, -1, 3], [0, 1, 3]]], np.float32)
    scene = Scene(spheres=Spheres.from_list([((0, 0, 0.0), 1.0, 0)]),
                  triangles=Triangles.from_arrays(v))
    o = jnp.asarray([[0.0, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    ref = intersect_scene_bruteforce(scene, o, d)
    hit = make_engine(scene, engine).intersect(scene, o, d)
    assert int(ref.prim_type[0]) == PRIM_TRIANGLE    # the z=3 triangle
    assert int(hit.prim_type[0]) == PRIM_TRIANGLE
    o2 = jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32)
    ref2 = intersect_scene_bruteforce(scene, o2, d)
    hit2 = make_engine(scene, engine).intersect(scene, o2, d)
    assert int(ref2.prim_type[0]) == int(hit2.prim_type[0]) == PRIM_SPHERE
    assert float(hit2.t[0]) == float(ref2.t[0]) == 1.0


def test_tables_layout():
    """Node rows hold both child boxes and the child ids bit-exactly; leaf
    rows hold v0 and the two edges in sorted-leaf order."""
    scene = make_scene("two_triangles")
    eng = gpu_traverse.build(scene)
    nodes = np.asarray(eng.nodes)
    bvh = eng.bvh
    assert nodes.shape == (1, 16)
    ids = nodes[:, 12:14].view(np.int32)
    np.testing.assert_array_equal(ids[:, 0], np.asarray(bvh.left))
    np.testing.assert_array_equal(ids[:, 1], np.asarray(bvh.right))
    left = int(bvh.left[0])
    np.testing.assert_array_equal(nodes[0, 0:3], np.asarray(bvh.node_min)[left])
    v = np.asarray(scene.triangles.vertices)[np.asarray(bvh.prim_index)]
    leaves = np.asarray(eng.leaves)
    np.testing.assert_array_equal(leaves[:, 0:3], v[:, 0])
    np.testing.assert_array_equal(leaves[:, 3:6], v[:, 1] - v[:, 0])
    np.testing.assert_array_equal(leaves[:, 6:9], v[:, 2] - v[:, 0])


def test_lbvh_depth_fits_stack():
    from optix_ray_tracer_tpu.ops.bvh import lbvh_depth
    from optix_ray_tracer_tpu.ops.traverse import STACK_DEPTH

    assert lbvh_depth(gpu_traverse.build(make_scene("two_triangles")).bvh) \
        == 1
    depth = lbvh_depth(gpu_traverse.build(make_scene("triangles")).bvh)
    assert 10 <= depth <= STACK_DEPTH


def test_too_small_for_a_bvh():
    """One triangle has no BVH: build refuses, the render loops take brute
    force (None)."""
    from optix_ray_tracer_tpu.models.common import choose_intersector

    v = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    scene = Scene(spheres=Spheres.empty(), triangles=Triangles.from_arrays(v))
    with pytest.raises(ValueError):
        gpu_traverse.build(scene)
    assert choose_intersector(scene) is None


def test_choose_intersector_picks_engine():
    """One rule on every backend: any scene with a BVH gets the traversal
    engine (its platform decides kernel or XLA twin at lowering time)."""
    from optix_ray_tracer_tpu.models import common

    for name in ("two_triangles", "triangles_spheres"):
        inter = common.choose_intersector(make_scene(name))
        assert isinstance(inter, gpu_traverse.TraversalIntersector)
        assert not inter.interpret
    scene = make_scene("triangles")
    inter = common.choose_intersector(scene)
    refit = common.refit_or_choose(inter, _moved(scene))
    rebuilt = common.rebuild_or_choose(inter, _moved(scene))
    for new in (refit, rebuilt):
        assert isinstance(new, gpu_traverse.TraversalIntersector)
        assert new.num_tris == inter.num_tris
    smaller = common.rebuild_or_choose(inter, make_scene("two_triangles"))
    assert smaller.num_tris == 2


def test_fused_chunk_refits_the_engine(monkeypatch):
    """The fused animation scan refits the per-file engine inside the
    scan, and renders the same frame as brute force."""
    from optix_ray_tracer_tpu.models.fused import fused_chunk
    from optix_ray_tracer_tpu.scene.materials import MaterialBuilder

    calls = []
    real_refit = gpu_traverse.refit
    monkeypatch.setattr(gpu_traverse, "refit",
                        lambda prev, scene: calls.append(1)
                        or real_refit(prev, scene))
    mb = MaterialBuilder()
    mb.add_rough((0.7, 0.6, 0.5))
    mats = mb.build()
    t8 = np.zeros((8, 3, 3), np.float32)
    t8[:, 1, 0] = 0.4
    t8[:, 2, 1] = 0.4
    t8 += np.linspace(-1.0, 1.0, 8, dtype=np.float32)[:, None, None]
    n8 = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (8, 3, 1))
    fd = dict(vertices=jnp.asarray(t8), normals=jnp.asarray(n8),
              tri_particle=jnp.zeros(8, jnp.int32),
              tri_valid=jnp.ones(8, bool),
              velocities=jnp.asarray([[0.1, 0.0, 0.0]], jnp.float32),
              particle_mat=jnp.zeros(1, jnp.int32),
              duration=jnp.float32(1.0), inv_frame_count=jnp.float32(0.5),
              particle_shift=jnp.zeros(3, jnp.float32),
              particle_scale=jnp.float32(1.0))
    cam = Camera.look_at((0.0, 0.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    scene0 = Scene(spheres=Spheres.empty(),
                   triangles=Triangles.from_arrays(t8, n8))
    engine = gpu_traverse.build(scene0)
    outs = []
    for base in (engine, None):
        outs.append(np.asarray(fused_chunk(
            fd, jnp.arange(2, dtype=jnp.float32),
            jnp.arange(2, dtype=jnp.int32), base, mats, cam,
            Spheres.empty(), Triangles.empty(), None, None, None,
            jnp.asarray([0.7, 0.8, 0.9], jnp.float32), mode="mesh",
            width=16, height=12, spp=1, integrator="whitted",
            do_denoise=False, max_depth=3, has_extras=False)[0]))
    assert calls, "the fused scan did not refit the engine"
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)


@pytest.mark.parametrize("query", ("intersect", "any_hit"))
def test_xla_twin_is_the_off_gpu_path(query):
    """``xla_twin`` (what the kernel is timed against on the card) stays a
    twin as a jit argument and gives the engine's own off-GPU results."""
    scene = make_scene("triangles_spheres")
    eng = make_engine(scene, "xla")
    twin = gpu_traverse.xla_twin(eng)
    leaves, tree = jax.tree.flatten(twin)
    assert type(tree.unflatten(leaves)) is gpu_traverse.XlaTwin
    o, d, *_ = (jnp.asarray(a) for a in make_wave("triangles_spheres",
                                                   "random"))
    run = jax.jit(lambda e, o, d: getattr(e, query)(scene, o, d))
    for got, want in zip(jax.tree.leaves(run(twin, o, d)),
                         jax.tree.leaves(run(eng, o, d))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("env_set", (True, False))
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program leaves the cache
    where jax reads it from the environment; without it the cache goes to
    the fixed path in the checkout."""
    from optix_ray_tracer_tpu.utils import jitcache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert jitcache.enable_compilation_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jitcache.enable_compilation_cache() == \
            jitcache.DEFAULT_CACHE_DIR
        assert updates["jax_compilation_cache_dir"] == \
            jitcache.DEFAULT_CACHE_DIR
        assert os.path.isdir(jitcache.DEFAULT_CACHE_DIR)
        root = os.path.dirname(os.path.dirname(jitcache.__file__))
        assert os.path.dirname(jitcache.DEFAULT_CACHE_DIR) == \
            os.path.dirname(root)


@pytest.mark.gpu
@pytest.mark.parametrize("wave", ("camera", "point_shadow", "random"))
def test_kernel_on_gpu(gpu, wave):
    """The compiled kernel on the card against the oracle."""
    scene = make_scene("triangles_spheres")
    o, d, t_min, t_max, any_hit = (jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in make_wave("triangles_spheres", wave))
    eng = gpu_traverse.build(scene)
    ref = intersect_scene_bruteforce(scene, o, d, t_min, t_max)
    if any_hit:
        np.testing.assert_array_equal(
            np.asarray(eng.any_hit(scene, o, d, t_min=t_min, t_max=t_max)),
            np.asarray(ref.is_hit))
    else:
        assert_nearest_agrees(eng.intersect(scene, o, d, t_min, t_max), ref)


@pytest.mark.gpu
def test_kernel_is_what_runs_on_gpu(gpu):
    """On the card the engine lowers to the Triton kernel, not the XLA
    twin."""
    scene = make_scene("triangles")
    eng = gpu_traverse.build(scene)
    o, d, *_ = make_wave("triangles", "random")
    def lowered(e):
        return jax.jit(lambda e, o, d: e.intersect(scene, o, d).t).lower(
            e, jnp.asarray(o), jnp.asarray(d)).as_text().lower()

    assert "triton" in lowered(eng)
    assert "triton" not in lowered(gpu_traverse.xla_twin(eng))
