"""The five BASELINE.md benchmark configurations as ready-made scenes.

1. single-sphere + ground Lambertian, 256x256, 16 spp   (CPU-verifiable)
2. multi-sphere specular + dielectric, depth-8 Whitted
3. triangle-mesh (bunny-class) LBVH build + traversal, diffuse
4. Cornell Box area-light NEE+MIS, 1024x1024, 1024 spp
5. Sponza-class mesh (100k+ tris) with textures + HDR env, 1080p wavefront

Each builder returns a dict with everything the runner needs; ``run()``
executes one config end-to-end and reports timing + throughput.
"""

from __future__ import annotations

import time

import numpy as np

from optix_ray_tracer_tpu.io.meshgen import box, quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.scene.camera import Camera
from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder


def config1_sphere_ground():
    """Lambertian sphere + ground plane (reference-style background light)."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    red = mb.add_rough((0.65, 0.05, 0.05))
    scene = Scene(
        spheres=Spheres.from_list([((0, 0, -1000.5), 1000.0, ground),
                                   ((0, 0, 0), 0.5, red)]),
        triangles=Triangles.empty())
    cam = Camera.look_at((5.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    return dict(name="sphere_ground", scene=scene, materials=mb.build(),
                camera=cam, width=256, height=256, spp=16, max_depth=5,
                integrator="whitted", background=(0.7, 0.8, 0.9))


def config2_whitted_spheres():
    """Specular + dielectric sphere field, depth 8 (RTIOW-style)."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.5, 0.5, 0.5))
    glass = mb.add_dielectric(1.5)
    metal = mb.add_metal((0.7, 0.6, 0.5), 0.0)
    fuzzy = mb.add_metal((0.8, 0.8, 0.9), 0.3)
    diffuse = mb.add_rough((0.4, 0.2, 0.1))
    rows = [((0, 0, -1000.5), 1000.0, ground),
            ((0, 0, 0), 0.5, glass),
            ((0, -1.1, 0), 0.5, diffuse),
            ((0, 1.1, 0), 0.5, metal)]
    rng = np.random.default_rng(3)
    for _ in range(20):
        p = rng.uniform([-3, -3, -0.4], [1.5, 3, -0.3])
        rows.append((tuple(p), 0.1,
                     int(rng.choice([glass, metal, fuzzy, diffuse]))))
    scene = Scene(spheres=Spheres.from_list(rows), triangles=Triangles.empty())
    cam = Camera.look_at((5.0, 0.0, 0.6), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    return dict(name="whitted_spheres", scene=scene, materials=mb.build(),
                camera=cam, width=512, height=512, spp=16, max_depth=8,
                integrator="whitted", background=(0.7, 0.8, 0.9))


def config3_mesh_diffuse(n_tris: int = 70_000):
    """Bunny-class mesh (procedural stand-in unless an OBJ is provided),
    LBVH build + traversal, diffuse shading."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.6, 0.6, 0.6))
    body = mb.add_rough((0.7, 0.55, 0.35))
    # bunny stand-in: two blended tessellated spheres (body + head)
    v1, n1 = sphere_with_n_triangles(int(n_tris * 0.7), (0, 0, 0), 0.5)
    v2, n2 = sphere_with_n_triangles(n_tris - int(n_tris * 0.7),
                                     (0.25, 0, 0.45), 0.3)
    tris = Triangles.from_arrays(np.concatenate([v1, v2]),
                                 np.concatenate([n1, n2]), body)
    scene = Scene(
        spheres=Spheres.from_list([((0, 0, -1000.5), 1000.0, ground)]),
        triangles=tris)
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.1), (0.0, 0.0, 1.0))
    return dict(name="mesh_diffuse", scene=scene, materials=mb.build(),
                camera=cam, width=1024, height=1024, spp=4, max_depth=5,
                integrator="whitted", background=(0.7, 0.8, 0.9))


def config3_bunny(obj_path: str):
    """Config 3 with a real OBJ (e.g. the Stanford bunny) when available."""
    from optix_ray_tracer_tpu.io.obj import obj_to_scene
    tris, materials, _ = obj_to_scene(obj_path)
    scene = Scene(spheres=Spheres.empty(), triangles=tris)
    v = np.asarray(tris.vertices).reshape(-1, 3)
    center = v.mean(0)
    size = (v.max(0) - v.min(0)).max()
    cam = Camera.look_at(center + np.asarray([2.5 * size, 0, 0.5 * size]),
                         center, (0.0, 0.0, 1.0))
    return dict(name="bunny", scene=scene, materials=materials, camera=cam,
                width=1024, height=1024, spp=4, max_depth=5,
                integrator="whitted", background=(0.7, 0.8, 0.9))


def config4_cornell():
    from optix_ray_tracer_tpu.scene.cornell import build_cornell_box
    from optix_ray_tracer_tpu.scene.lights import collect_area_lights
    scene, materials, camera = build_cornell_box()
    lights = collect_area_lights(scene, materials)
    return dict(name="cornell", scene=scene, materials=materials,
                camera=camera, lights=lights, width=1024, height=1024,
                spp=1024, max_depth=8, integrator="path",
                background=(0.0, 0.0, 0.0))


def config5_sponza_class(n_cols: int = 8):
    """Sponza-class architectural scene, procedural (no asset shipping):
    a colonnaded atrium — floor, walls, columns of stacked tessellated
    drums — ~100k+ triangles, checker-textured floor, sun-sky HDR env.
    """
    from optix_ray_tracer_tpu.render.envmap import gradient_sky
    from optix_ray_tracer_tpu.scene.textures import build_texture_set, checker_texture

    mb = MaterialBuilder()
    floor_mat = mb.add_rough((0.9, 0.9, 0.9))
    wall_mat = mb.add_rough((0.75, 0.70, 0.62))
    column_mat = mb.add_rough((0.82, 0.80, 0.75))
    vs, ns, ms, uvs = [], [], [], []

    def add(vn, mat, uv=None):
        v, n = vn
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), mat, np.int32))
        uvs.append(uv if uv is not None
                   else np.zeros((len(v), 3, 2), np.float32))

    # floor 20 x 10 with planar uvs
    fv, fn = quad([-10, -5, 0], [10, -5, 0], [10, 5, 0], [-10, 5, 0])
    fuv = (fv[..., :2] + [10, 5]) / [20, 10]
    add((fv, fn), floor_mat, fuv.astype(np.float32))
    # side walls + end walls
    add(quad([-10, -5, 0], [-10, -5, 6], [10, -5, 6], [10, -5, 0]), wall_mat)
    add(quad([-10, 5, 0], [10, 5, 0], [10, 5, 6], [-10, 5, 6]), wall_mat)
    add(quad([-10, -5, 0], [-10, 5, 0], [-10, 5, 6], [-10, -5, 6]), wall_mat)

    # two rows of columns: stacked sphere drums (tessellated => triangle mass)
    per_col = max(110_000 // (2 * n_cols * 4), 800)
    for i in range(n_cols):
        x = -8.0 + i * (16.0 / max(n_cols - 1, 1))
        for y in (-3.0, 3.0):
            for k in range(4):
                v, n = sphere_with_n_triangles(per_col, (x, y, 0.6 + k * 1.1),
                                               0.55)
                add((v, n), column_mat)

    tris = Triangles.from_arrays(np.concatenate(vs), np.concatenate(ns),
                                 np.concatenate(ms), np.concatenate(uvs))
    scene = Scene(spheres=Spheres.empty(), triangles=tris)
    textures = build_texture_set([checker_texture(256, tiles=20)],
                                 [floor_mat] + [-1] * (len(mb) - 1))
    # fix binding: texture 0 -> material floor_mat
    mat_tex = [-1] * len(mb)
    mat_tex[floor_mat] = 0
    textures = build_texture_set([checker_texture(256, tiles=20)], mat_tex)
    env = gradient_sky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.9995)
    # NB: in the UVW model |target - center| sets the FOV
    # (tan(half-fov) = 1/|W|); keep the target ~1.5 units out for ~35 deg
    cam = Camera.look_at((-9.0, 0.0, 2.0), (-7.6, 0.25, 1.95), (0.0, 0.0, 1.0))
    return dict(name="sponza_class", scene=scene, materials=mb.build(),
                camera=cam, width=1920, height=1088, spp=4, max_depth=6,
                integrator="path", lights=None, env=env, textures=textures,
                background=(0.0, 0.0, 0.0))


ALL_CONFIGS = {
    1: config1_sphere_ground,
    2: config2_whitted_spheres,
    3: config3_mesh_diffuse,
    4: config4_cornell,
    5: config5_sponza_class,
}


def run(config: dict, spp: int | None = None, width: int | None = None,
        height: int | None = None, seed: int = 0, intersector="auto"):
    """Execute a benchmark config; returns ((img, albedo, normal), stats).

    ``intersector="auto"`` takes the production policy
    (``models.common.choose_intersector``: the traversal engine, or brute
    force below its size threshold); any intersector pytree (or None =
    brute force) overrides it.  ``render_s`` ends in
    ``block_until_ready`` and includes compilation on a first call."""

    from optix_ray_tracer_tpu.models.common import choose_intersector
    from optix_ray_tracer_tpu.render import pathtracer, wavefront

    scene = config["scene"]
    w = width or config["width"]
    h = height or config["height"]
    s = spp or config["spp"]

    t0 = time.perf_counter()
    if isinstance(intersector, str):
        intersector = choose_intersector(scene)
    build_s = time.perf_counter() - t0

    kwargs = dict(width=w, height=h, spp=s, seed=seed,
                  max_depth=config["max_depth"], intersector=intersector)
    t0 = time.perf_counter()
    if config["integrator"] == "path":
        img, alb, nrm = pathtracer.render_path(
            scene, config["materials"], config.get("lights"),
            config["camera"], background=config["background"],
            env=config.get("env"), textures=config.get("textures"), **kwargs)
    else:
        img, alb, nrm = wavefront.render(
            scene, config["materials"], config["camera"],
            background=config["background"], env=config.get("env"), **kwargs)
    img.block_until_ready()
    render_s = time.perf_counter() - t0

    stats = dict(name=config["name"], width=w, height=h, spp=s,
                 triangles=scene.triangle_count, spheres=scene.sphere_count,
                 build_s=build_s, render_s=render_s,
                 spp_per_sec=s / render_s,
                 mpaths_per_sec=w * h * s / render_s / 1e6)
    return (img, alb, nrm), stats
