"""Shared frontend plumbing: config -> materials / extra geometry / camera.

Mirrors the commit-phase steps both reference frontends share
(``RendererMesh.cu:169-253`` / ``RendererTime.cu:153-290``): map material
data, build extra geometry, bake the color ramp, configure the camera.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from optix_ray_tracer_tpu.io.config import ConfigError, RendererConfig
from optix_ray_tracer_tpu.scene.camera import Camera
from optix_ray_tracer_tpu.scene.geometry import Spheres, Triangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu.utils.colorramp import bake_color_ramp


@dataclasses.dataclass(frozen=True)
class MaterialBases:
    """Row bases of each config material list in the packed table."""
    rough: int
    metal: int
    dielectric: int
    emissive: int
    material_offset: int      # base of the baked particle ramp

    def resolve(self, mat_type: str, mat_index: int) -> int:
        base = {"ROUGH": self.rough, "METAL": self.metal,
                "DIELECTRIC": self.dielectric,
                "EMISSIVE": self.emissive}[mat_type]
        return base + mat_index


def build_materials(config: RendererConfig, particle_count: int):
    """Materials = config roughs ++ metals ++ dielectrics ++ emissives ++
    baked particle ramp.

    Layout matches the reference's global material array: rough indices come
    first, metal indices after, then ``materialOffset`` is the base of the
    per-particle ramp materials (RendererMesh.cu:223-233, ColorRamp baking
    keyed by max cell count).  Dielectric/emissive lists are extensions —
    reference configs have none, so their offsets are unchanged.

    Returns (MaterialTable, MaterialBases).
    """
    mb = MaterialBuilder()
    for albedo in config.roughs:
        mb.add_rough(albedo)
    metal_base = len(config.roughs)
    for albedo, fuzz in config.metals:
        mb.add_metal(albedo, fuzz)
    dielectric_base = len(mb)
    for ior in config.dielectrics:
        mb.add_dielectric(ior)
    emissive_base = len(mb)
    for emission in config.emissives:
        mb.add_emissive(emission)
    material_offset = len(mb)
    if particle_count > 0:
        ramp = bake_color_ramp(config.particle_material_preset, particle_count)
        mb.add_ramp(ramp)
    return mb.build(), MaterialBases(
        rough=0, metal=metal_base, dielectric=dielectric_base,
        emissive=emissive_base, material_offset=material_offset)


def build_extra_spheres(config: RendererConfig, bases: MaterialBases) -> Spheres:
    """Config ``spheres`` with their static SRT transforms pre-applied
    (parseSphereData precomputes the transforms, ProgramArgumentParser.cu:4-39;
    the default Main.cu callback then writes them onto instance 0)."""
    rows = []
    for s in config.spheres:
        center, radius = s.world_center_radius()
        rows.append((center, radius, bases.resolve(s.mat_type, s.mat_index)))
    return Spheres.from_list(rows)


def build_extra_triangles(config: RendererConfig,
                          bases: MaterialBases) -> Triangles:
    """Static extra meshes from config ``meshes`` (OBJ files with optional
    SRT + material override) — the triangle analog of the reference's
    extra-geometry spheres (its ``triangles`` key is declared but unused,
    docs/configuration.md:232-236; here it is real)."""
    import jax.numpy as jnp

    from optix_ray_tracer_tpu.io.obj import read_obj
    from optix_ray_tracer_tpu.utils.transforms import srt_transform

    if not config.meshes:
        return Triangles.empty()
    vs, ns, ms = [], [], []
    for m in config.meshes:
        mesh = read_obj(config.resolve(str(m["obj"])))
        v = np.asarray(mesh.vertices, np.float32)      # (T, 3, 3)
        n = np.asarray(mesh.normals, np.float32)
        t = np.asarray(srt_transform(
            tuple(m.get("shift", (0, 0, 0))),
            tuple(m.get("rotate", (0, 0, 0))),
            tuple(m.get("scale", (1, 1, 1)))), np.float32)
        v = v @ t[:, :3].T + t[:, 3]
        rot = t[:, :3]
        # normals: inverse-transpose rotation (uniform scale: rot works)
        n = n @ np.linalg.inv(rot).astype(np.float32)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(norm, 1e-12)
        mat_type = str(m.get("mat-type", "ROUGH"))
        if mat_type not in ("ROUGH", "METAL", "DIELECTRIC", "EMISSIVE"):
            raise ConfigError(f"mesh mat-type '{mat_type}' unknown")
        mat = bases.resolve(mat_type, int(m.get("mat-index", 0)))
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), mat, np.int32))
    return Triangles.from_arrays(np.concatenate(vs), np.concatenate(ns),
                                 np.concatenate(ms))


def build_envmap(config: RendererConfig):
    """Config ``envmap`` -> EnvMap (or None)."""
    if config.envmap is None:
        return None
    from optix_ray_tracer_tpu.render import envmap as env_mod

    spec = config.envmap
    if "file" in spec:
        return env_mod.read_hdr(config.resolve(str(spec["file"])))
    if spec.get("type") == "constant":
        return env_mod.constant_env(tuple(spec.get("color", (0.7, 0.8, 0.9))))
    kwargs = {}
    if "sun-direction" in spec:
        kwargs["sun_dir"] = tuple(spec["sun-direction"])
    if "sun-cos" in spec:
        kwargs["sun_cos"] = float(spec["sun-cos"])
    if "zenith" in spec:
        kwargs["zenith"] = tuple(spec["zenith"])
    if "horizon" in spec:
        kwargs["horizon"] = tuple(spec["horizon"])
    return env_mod.gradient_sky(**kwargs)


def build_textures(config: RendererConfig, bases: MaterialBases,
                   num_materials: int):
    """Config ``textures`` -> TextureSet (or None): each entry binds an
    image (or procedural checker) to one material row."""
    if not config.textures_cfg:
        return None
    from optix_ray_tracer_tpu.scene.textures import (
        build_texture_set, checker_texture, load_texture,
    )

    images = []
    mat_tex = [-1] * num_materials
    for i, t in enumerate(config.textures_cfg):
        if t.get("checker"):
            tiles = int(t.get("tiles", 8))
            images.append(checker_texture(int(t.get("size", 256)),
                                          tiles=tiles))
        else:
            images.append(load_texture(config.resolve(str(t["file"]))))
        mat = bases.resolve(str(t.get("mat-type", "ROUGH")),
                            int(t.get("mat-index", 0)))
        mat_tex[mat] = i
    return build_texture_set(images, mat_tex)


def camera_from_config(config: RendererConfig) -> Camera:
    ld = config.loop_data
    return Camera.look_at(ld.camera_center, ld.camera_target,
                          ld.up_direction, aperture=ld.aperture,
                          focus_dist=ld.focus_distance)


def frame_count_for_file(duration: float, fps: int, render_speed_ratio: int) -> int:
    """frames per animation segment = duration * fps * renderSpeedRatio
    (RendererMesh.cu:370-371)."""
    return max(1, int(duration * float(fps * render_speed_ratio)))


def pad_stack(arrays: list[np.ndarray], pad_value=0.0) -> np.ndarray:
    """Stack variable-length leading-dim arrays padded to the max length —
    the static-shape discipline that lets one compiled render serve every
    animation file."""
    if not arrays:
        return np.zeros((0, 0), np.float32)
    max_len = max(a.shape[0] for a in arrays)
    out = np.full((len(arrays), max_len) + arrays[0].shape[1:], pad_value,
                  arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


#: the fewest triangles the traversal engine takes; measured on the card
#: (PERF.md), its kernel beat brute force at every size from 8 triangles up,
#: so no larger cut-over is set
MIN_BVH_TRIANGLES = 2


def choose_intersector(scene):
    """Per-file intersector for the render loops: the per-ray traversal
    engine (``ops/gpu_traverse.py``), or None (brute force) for scenes too
    small for a BVH to pay.  One rule on every platform; the engine itself
    runs its kernel on the GPU and the plain XLA walk elsewhere."""
    from optix_ray_tracer_tpu.ops import gpu_traverse
    from optix_ray_tracer_tpu.utils.debug import maybe_validate_accel

    if scene.triangle_count < MIN_BVH_TRIANGLES:
        return None
    intersector = gpu_traverse.build(scene)
    maybe_validate_accel(intersector, scene)
    return intersector


def _same_shape(prev, scene) -> bool:
    from optix_ray_tracer_tpu.ops.gpu_traverse import TraversalIntersector

    return (isinstance(prev, TraversalIntersector)
            and scene.triangle_count == prev.num_tris)


def refit_or_choose(prev, scene):
    """Per-frame intersector: device-side refit of ``prev`` when the
    triangle count is unchanged, a fresh choice otherwise — the
    reference's policy of building per file and refitting per frame
    (RendererImpl.cu:210-242)."""
    from optix_ray_tracer_tpu.ops import gpu_traverse
    from optix_ray_tracer_tpu.utils.debug import maybe_validate_accel

    if not _same_shape(prev, scene):
        return choose_intersector(scene)
    intersector = gpu_traverse.refit(prev, scene)
    maybe_validate_accel(intersector, scene)
    return intersector


def rebuild_or_choose(prev, scene):
    """Per-file intersector: device-side rebuild (fresh Morton order, same
    shapes, so one compiled render serves every file) when the triangle
    count is unchanged, a fresh choice otherwise — the buildGAS-per-file
    analog."""
    from optix_ray_tracer_tpu.ops import gpu_traverse
    from optix_ray_tracer_tpu.utils.debug import maybe_validate_accel

    if not _same_shape(prev, scene):
        return choose_intersector(scene)
    intersector = gpu_traverse.rebuild(prev, scene)
    maybe_validate_accel(intersector, scene)
    return intersector


def render_frame(config: RendererConfig, scene, materials, camera,
                 width: int, height: int, spp: int, seed: int,
                 intersector, env=None, textures=None, lights=None,
                 denoise_override: bool | None = None,
                 denoiser_override: str | None = None,
                 sample_offset: int = 0):
    """One frame through the configured integrator + denoiser.

    The shared hot-loop step of both frontends (startRender step 10-11
    parity: optixLaunch + denoiseOutput, RendererMesh.cu:416-419 +
    RendererImpl.cu:680-734).  Returns (img, albedo, normal) with ``img``
    already denoised when enabled (``denoise_override`` is the Tab-bypass
    analog: None = follow config).
    """
    from optix_ray_tracer_tpu.render import pathtracer, wavefront

    if config.integrator == "path":
        img, alb, nrm = pathtracer.render_path(
            scene, materials, lights, camera, width=width, height=height,
            spp=spp, seed=seed, background=config.background,
            max_depth=config.max_depth, intersector=intersector,
            env=env, textures=textures,
            sampler=getattr(config, "sampler", "pcg"),
            sample_offset=sample_offset)
    elif config.integrator in ("restir", "restir-gi"):
        # ReSTIR DI: one shadow ray per pixel per sample, reservoir state
        # carried across the spp samples (render/restir.py); "restir-gi"
        # adds the path-traced indirect continuation.  sample_offset
        # folds into the seed so progressive batches draw fresh candidate
        # streams.
        from optix_ray_tracer_tpu.render import restir
        if lights is None or lights.count == 0:
            raise ValueError(
                f"integrator '{config.integrator}' needs emissive "
                "materials in the scene (it resamples area-light "
                "candidates)")
        kw = dict(
            spp=spp, seed=seed ^ (int(sample_offset) * 0x9E3779B9),
            background=config.background, intersector=intersector,
            env=env, textures=textures,
            sampler=getattr(config, "sampler", "pcg"))
        if config.integrator == "restir-gi":
            img, alb, nrm = restir.render_restir_gi_progressive(
                scene, materials, lights, camera, width=width,
                height=height, max_depth=config.max_depth, **kw)
        else:
            img, alb, nrm = restir.render_restir_progressive(
                scene, materials, lights, camera, width=width,
                height=height, **kw)
    else:
        img, alb, nrm = wavefront.render(
            scene, materials, camera, width, height, spp=spp, seed=seed,
            background=config.background, max_depth=config.max_depth,
            intersector=intersector, env=env,
            sampler=getattr(config, "sampler", "pcg"),
            sample_offset=sample_offset)
    img = apply_denoiser(img, alb, nrm, config, denoise_override,
                         denoiser_override)
    return img, alb, nrm


def apply_denoiser(img, alb, nrm, config, denoise_override=None,
                   denoiser_override=None):
    """The denoiser tail of :func:`render_frame`, reusable by callers
    that drive an integrator directly (the viewer's ReSTIR path)."""
    do_denoise = (config.denoise if denoise_override is None
                  else denoise_override)
    if denoiser_override is not None:
        import types
        denoiser = resolve_denoiser(
            types.SimpleNamespace(denoiser=denoiser_override))
    else:
        denoiser = resolve_denoiser(config)
    if do_denoise and denoiser == "neural":
        from optix_ray_tracer_tpu.render.neural_denoise import (
            denoise_neural,
        )
        img = denoise_neural(img, alb, nrm)
    elif do_denoise:
        from optix_ray_tracer_tpu.render.denoise import denoise
        img = denoise(img, alb, nrm)
    return img


_warned_no_weights = False


def resolve_denoiser(config) -> str:
    """``config.denoiser``, degraded to "atrous" (with one warning per
    process) when the pretrained neural weights asset is absent."""
    if getattr(config, "denoiser", "atrous") != "neural":
        return "atrous"
    from optix_ray_tracer_tpu.render import neural_denoise
    if neural_denoise.default_params() is None:
        global _warned_no_weights
        if not _warned_no_weights:
            import logging
            logging.getLogger("optix_ray_tracer_tpu").warning(
                "denoise='neural' requested but no pretrained weights at"
                " %s; falling back to the a-trous filter",
                neural_denoise._WEIGHTS_FILE)
            _warned_no_weights = True
        return "atrous"
    return "neural"


def collect_lights(config: RendererConfig, scene, materials):
    """Area lights for the path/restir integrators, auto-collected from
    EMISSIVE triangles (static extras; particle ramp materials are never
    emissive)."""
    if config.integrator not in ("path", "restir", "restir-gi"):
        return None
    from optix_ray_tracer_tpu.scene.lights import collect_area_lights
    return collect_area_lights(scene, materials)
