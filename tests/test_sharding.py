"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The key property: the image is BIT-IDENTICAL under every mesh shape
(1x1, 8x1 tile, 1x8 sample, 4x2 mixed) because the RNG keys off global
(pixel, sample) counters — the determinism the reference's clock-seeded
cuRAND could never give (HostFunctions.cu:122-140).
"""

import numpy as np
import jax
import pytest

from optix_ray_tracer_tpu.parallel.sharding import make_mesh, render_sharded
from optix_ray_tracer_tpu.render import wavefront
from optix_ray_tracer_tpu.scene.camera import Camera
from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _scene():
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    red = mb.add_rough((0.65, 0.05, 0.05))
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.1)
    mats = mb.build()
    scene = Scene(
        spheres=Spheres.from_list([
            ((0.0, 0.0, -100.5), 100.0, ground),
            ((0.0, 0.0, 0.0), 0.5, red),
            ((0.0, 1.2, 0.3), 0.5, metal)]),
        triangles=Triangles.empty())
    cam = Camera.look_at((5.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    return scene, mats, cam


W, H, SPP, SEED = 32, 24, 8, 7


@pytest.fixture(scope="module")
def reference_image():
    scene, mats, cam = _scene()
    img, _, _ = wavefront.render(scene, mats, cam, W, H, spp=SPP, seed=SEED)
    return np.asarray(img)


class TestSharding:
    @pytest.mark.parametrize("tile,sample", [(1, 1), (8, 1), (1, 8), (4, 2),
                                             (2, 4)])
    def test_matches_single_device(self, reference_image, tile, sample):
        scene, mats, cam = _scene()
        mesh = make_mesh(tile=tile, sample=sample)
        img = render_sharded(scene, mats, cam, W, H, SPP, mesh, seed=SEED)
        np.testing.assert_allclose(np.asarray(img), reference_image,
                                   atol=1e-6,
                                   err_msg=f"mesh ({tile},{sample})")

    def test_invalid_divisibility(self):
        scene, mats, cam = _scene()
        mesh = make_mesh(tile=8, sample=1)
        with pytest.raises(ValueError):
            render_sharded(scene, mats, cam, W, 30, SPP, mesh)  # 30 % 8 != 0

    def test_output_is_row_sharded(self):
        scene, mats, cam = _scene()
        mesh = make_mesh(tile=8, sample=1)
        img = render_sharded(scene, mats, cam, W, H, SPP, mesh, seed=SEED)
        assert img.shape == (H, W, 3)
        # sharding metadata present (named sharding along rows)
        assert img.sharding is not None


class TestPathSharding:
    @pytest.mark.slow
    def test_cornell_matches_single_device(self):
        from optix_ray_tracer_tpu.parallel.sharding import render_path_sharded
        from optix_ray_tracer_tpu.render.pathtracer import render_path
        from optix_ray_tracer_tpu.scene.cornell import build_cornell_box
        from optix_ray_tracer_tpu.scene.lights import collect_area_lights

        scene, mats, cam = build_cornell_box(with_blocks=False)
        lights = collect_area_lights(scene, mats)
        ref, _, _ = render_path(scene, mats, lights, cam, 16, 16, spp=8,
                                seed=3)
        for tile, sample in ((4, 2), (8, 1)):
            mesh = make_mesh(tile=tile, sample=sample)
            img = render_path_sharded(scene, mats, lights, cam, 16, 16, 8,
                                      mesh, seed=3)
            np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                       atol=1e-6,
                                       err_msg=f"mesh ({tile},{sample})")

    def test_env_nee_matches_single_device(self):
        """Env importance sampling (sampling-table pytree leaves + the
        env-NEE shadow wave) under shard_map: sharded == single-device."""
        from optix_ray_tracer_tpu.parallel.sharding import render_path_sharded
        from optix_ray_tracer_tpu.render.envmap import gradient_sky
        from optix_ray_tracer_tpu.render.pathtracer import render_path
        from optix_ray_tracer_tpu.scene.camera import Camera
        from optix_ray_tracer_tpu.scene.geometry import (
            Scene, Spheres, Triangles,
        )
        from optix_ray_tracer_tpu.scene.materials import MaterialBuilder

        mb = MaterialBuilder()
        g = mb.add_rough((0.7, 0.7, 0.7))
        scene = Scene(spheres=Spheres.from_list([((0, 0, -100.5), 100.0, g)]),
                      triangles=Triangles.empty())
        cam = Camera.look_at((3.5, 0, 0.6), (0, 0, 0), (0, 0, 1))
        env = gradient_sky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.9995)
        mats = mb.build()
        ref, _, _ = render_path(scene, mats, None, cam, 16, 16, spp=4,
                                seed=5, env=env, max_depth=3)
        mesh = make_mesh(tile=4, sample=2)
        img = render_path_sharded(scene, mats, None, cam, 16, 16, 4, mesh,
                                  seed=5, env=env, max_depth=3)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-6)

    @pytest.mark.slow
    def test_sobol_sampler_shard_invariant(self):
        """The Owen-Sobol stream keys on global (pixel, sample) counters
        exactly like PCG, so sampler="sobol" must also be bit-stable
        across mesh shapes (and actually reach the sharded path)."""
        from optix_ray_tracer_tpu.parallel.sharding import render_path_sharded
        from optix_ray_tracer_tpu.render.pathtracer import render_path
        from optix_ray_tracer_tpu.scene.cornell import build_cornell_box
        from optix_ray_tracer_tpu.scene.lights import collect_area_lights

        scene, mats, cam = build_cornell_box(with_blocks=False)
        lights = collect_area_lights(scene, mats)
        ref, _, _ = render_path(scene, mats, lights, cam, 16, 16, spp=8,
                                seed=3, sampler="sobol")
        ref_pcg, _, _ = render_path(scene, mats, lights, cam, 16, 16,
                                    spp=8, seed=3, sampler="pcg")
        assert not np.allclose(np.asarray(ref), np.asarray(ref_pcg))
        mesh = make_mesh(tile=4, sample=2)
        img = render_path_sharded(scene, mats, lights, cam, 16, 16, 8,
                                  mesh, seed=3, sampler="sobol")
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-6)


class TestMarchSharding:
    """The PRODUCTION intersector (the traversal engine) under shard_map,
    beside the brute-force path."""

    @pytest.mark.slow
    def test_triangle_scene_march_matches_single_device(self):
        from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
        from optix_ray_tracer_tpu.ops import gpu_traverse

        mb = MaterialBuilder()
        ground = mb.add_rough((0.70, 0.60, 0.50))
        body = mb.add_rough((0.65, 0.05, 0.05))
        mats = mb.build()
        v, n = sphere_with_n_triangles(2048, center=(0, 0, 0), radius=0.5)
        scene = Scene(
            spheres=Spheres.from_list([((0, 0, -100.5), 100.0, ground)]),
            triangles=Triangles.from_arrays(v, n, body))
        cam = Camera.look_at((4.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
        intersector = gpu_traverse.build(scene)

        ref, _, _ = wavefront.render(scene, mats, cam, W, H, spp=8, seed=11,
                                     intersector=intersector)
        for tile, sample in ((4, 2), (8, 1), (1, 8)):
            mesh = make_mesh(tile=tile, sample=sample)
            img = render_sharded(scene, mats, cam, W, H, 8, mesh, seed=11,
                                 intersector=intersector)
            np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                       atol=1e-6,
                                       err_msg=f"mesh ({tile},{sample})")


class TestReSTIRSharded:
    """render_restir_sharded: the hybrid shard_map(rays) + GSPMD(resample)
    pipeline matches render_restir exactly — image AND carried reservoir
    state — under every tile count, including cross-band spatial taps and
    temporal reprojection."""

    @staticmethod
    def _light_scene():
        from optix_ray_tracer_tpu.scene.lights import collect_area_lights

        mb = MaterialBuilder()
        floor_m = mb.add_rough((0.7, 0.7, 0.7))
        em = mb.add_emissive((25.0, 22.0, 18.0))
        em2 = mb.add_emissive((2.0, 6.0, 9.0))
        quads = []

        def quad(cx, cy, z, half):
            a = [cx - half, cy - half, z]; b = [cx + half, cy - half, z]
            c = [cx + half, cy + half, z]; d = [cx - half, cy + half, z]
            return [[a, b, c], [a, c, d]]

        verts = quad(0.0, 0.0, 0.0, 4.0); mats = [floor_m, floor_m]
        verts += quad(-1.0, 0.5, 2.0, 0.25); mats += [em, em]
        verts += quad(1.2, -0.8, 2.0, 0.3); mats += [em2, em2]
        v = np.asarray(verts, np.float32)
        n = np.zeros_like(v); n[:, :, 2] = 1.0
        scene = Scene(spheres=Spheres.empty(),
                      triangles=Triangles.from_arrays(
                          v, n, np.asarray(mats, np.int32)))
        materials = mb.build()
        lights = collect_area_lights(scene, materials)
        cam = Camera.look_at((0.0, 0.0, 7.0), (0.0, 0.0, 6.0),
                             (0.0, 1.0, 0.0))
        return scene, materials, lights, cam

    def test_matches_single_device(self):
        from optix_ray_tracer_tpu.parallel.sharding import (
            render_restir_sharded,
        )
        from optix_ray_tracer_tpu.render import restir

        scene, materials, lights, cam = self._light_scene()
        # two frames: frame 1 exercises temporal reprojection + spatial
        # taps ACROSS band boundaries (radius 16 on 6-row bands at tile=4)
        ref_state = restir.empty_reservoir_state(W, H)
        refs = []
        for f in range(2):
            img, alb, nrm, ref_state = restir.render_restir(
                scene, materials, lights, cam, W, H, seed=3, frame=f,
                state=ref_state, m_candidates=8, spatial_taps=2,
                spatial_radius=16)
            refs.append(np.asarray(img))

        for tile in (4, 8):
            mesh = make_mesh(tile=tile, sample=1)
            st = restir.empty_reservoir_state(W, H)
            for f in range(2):
                img, alb, nrm, st = render_restir_sharded(
                    scene, materials, lights, cam, W, H, mesh, seed=3,
                    frame=f, state=st, m_candidates=8, spatial_taps=2,
                    spatial_radius=16)
                np.testing.assert_allclose(
                    np.asarray(img), refs[f], atol=1e-6,
                    err_msg=f"tile={tile} frame={f}")
            for k in ref_state:
                np.testing.assert_allclose(
                    np.asarray(st[k]), np.asarray(ref_state[k]), atol=1e-6,
                    err_msg=f"state[{k}] tile={tile}")

    def test_rejects_sample_axis(self):
        from optix_ray_tracer_tpu.parallel.sharding import (
            render_restir_sharded,
        )
        scene, materials, lights, cam = self._light_scene()
        mesh = make_mesh(tile=2, sample=2)
        with pytest.raises(ValueError, match="sample"):
            render_restir_sharded(scene, materials, lights, cam, W, H,
                                  mesh, seed=3)


def _reference_time_data():
    import json
    import os

    REF = "/root/reference/files"
    if not os.path.isdir(REF):
        pytest.skip("reference data not mounted")
    from optix_ray_tracer_tpu.io.config import parse_config_dict
    from optix_ray_tracer_tpu.models import renderer_time

    with open(f"{REF}/config.json") as f:
        raw = json.load(f)
    raw["series-name"] = "particle-short.vtk.series"
    raw["series-path"] = REF
    raw["stl-path"] = f"{REF}/shape/separated/"
    raw["loop-data"]["window-width"] = 32
    raw["loop-data"]["window-height"] = 24
    raw["loop-data"]["fps"] = 2
    raw["loop-data"]["render-speed-ratio"] = 50
    cfg = parse_config_dict(raw, base_dir=REF)
    return renderer_time.commit(cfg)


class TestShardedAnimation:
    """The CLI --shard product path (parallel/animation.py)."""

    @pytest.mark.slow
    def test_fused_sharded_matches_single_device(self):
        """Default route: the FUSED sharded chunk scan (one shard_map
        around refit+render+temporal+denoise).

        The exactness contract: every band traces its rays with the same
        per-ray engine as the full frame, so frames are bit-identical
        (tile=3: 8-row bands, asserted array_equal).  tile=8 (3-row
        bands) is held to 1-ulp relative tolerance with a bounded
        mismatch count."""
        from optix_ray_tracer_tpu.models import renderer_time
        from optix_ray_tracer_tpu.parallel.animation import (
            render_frames_sharded,
        )

        data = _reference_time_data()
        plain = [(fi, k, np.asarray(f.mean()))
                 for fi, k, f in renderer_time.render_frames(
                     data, width=32, height=24, spp=1, max_frames=3)]

        # same-engine case: bit-identical
        mesh = make_mesh(tile=3)
        sharded = [(fi, k, np.asarray(f.mean()))
                   for fi, k, f in render_frames_sharded(
                       data, "time", 32, 24, 1, mesh, max_frames=3)]
        assert [(a, b) for a, b, _ in sharded] == \
            [(a, b) for a, b, _ in plain]
        for (_, _, fa), (_, _, fb) in zip(sharded, plain):
            np.testing.assert_array_equal(fa, fb)

        # engine-fallback case: 1-ulp fp-tie tolerance, few pixels
        mesh8 = make_mesh(tile=8)
        sharded8 = [(fi, k, np.asarray(f.mean()))
                    for fi, k, f in render_frames_sharded(
                        data, "time", 32, 24, 1, mesh8, max_frames=3)]
        for (_, _, fa), (_, _, fb) in zip(sharded8, plain):
            np.testing.assert_allclose(fa, fb, rtol=1e-6, atol=1e-7)
            frac = np.mean(fa != fb)
            assert frac < 0.01, f"{frac:.4f} of pixels differ (>1%)"

    @pytest.mark.slow
    def test_perframe_fallback_sharded_match(self):
        """An update_fn hook forces the per-frame fallback on both sides
        (no fused scan, no temporal history): sharded matches the
        single-device per-frame loop."""
        from optix_ray_tracer_tpu.models import renderer_time
        from optix_ray_tracer_tpu.parallel.animation import (
            render_frames_sharded,
        )

        data = _reference_time_data()
        renderer_time.set_update_fn(data, lambda s, k: None)
        try:
            mesh = make_mesh(tile=8)
            sharded = [(fi, k, np.asarray(f.mean()))
                       for fi, k, f in render_frames_sharded(
                           data, "time", 32, 24, 1, mesh, max_frames=2)]
            plain = [(fi, k, np.asarray(f.mean()))
                     for fi, k, f in renderer_time.render_frames(
                         data, width=32, height=24, spp=1, max_frames=2)]
        finally:
            data.update_fn = None
        assert [(a, b) for a, b, _ in sharded] == \
            [(a, b) for a, b, _ in plain]
        for (_, _, fa), (_, _, fb) in zip(sharded, plain):
            np.testing.assert_allclose(fa, fb, atol=1e-6)

    @pytest.mark.slow
    def test_fused_sharded_sample_axis_path_integrator(self):
        """Mixed (tile, sample) mesh through the fused scan with the
        PATH integrator: sample partial sums merge with a psum, so
        equality is up to fp accumulation order."""
        from optix_ray_tracer_tpu.models import renderer_time
        from optix_ray_tracer_tpu.parallel.animation import (
            render_frames_sharded,
        )

        data = _reference_time_data()
        data.config.integrator = "path"
        try:
            mesh = make_mesh(tile=4, sample=2)
            sharded = [np.asarray(f.mean())
                       for _, _, f in render_frames_sharded(
                           data, "time", 32, 24, 2, mesh, max_frames=2)]
            plain = [np.asarray(f.mean())
                     for _, _, f in renderer_time.render_frames(
                         data, width=32, height=24, spp=2, max_frames=2)]
        finally:
            data.config.integrator = "whitted"
        for fa, fb in zip(sharded, plain):
            np.testing.assert_allclose(fa, fb, atol=1e-5)
