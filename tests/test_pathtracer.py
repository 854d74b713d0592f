"""Path-tracer tests: NEE+MIS correctness, Cornell Box, packet intersector,
film accumulation/checkpointing."""

import numpy as np
import jax.numpy as jnp
import pytest

from optix_ray_tracer_tpu.ops.traverse import make_intersector
from optix_ray_tracer_tpu.ops import gpu_traverse
from optix_ray_tracer_tpu.render import wavefront
from optix_ray_tracer_tpu.render.film import Film
from optix_ray_tracer_tpu.render.pathtracer import render_path
from optix_ray_tracer_tpu.scene.camera import Camera
from optix_ray_tracer_tpu.scene.cornell import build_cornell_box
from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles
from optix_ray_tracer_tpu.scene.lights import collect_area_lights, sample_lights
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder


class TestLights:
    def test_collect_from_cornell(self):
        scene, mats, _ = build_cornell_box()
        lights = collect_area_lights(scene, mats)
        assert lights is not None
        assert lights.count == 2  # light quad = 2 triangles
        np.testing.assert_allclose(float(lights.total_area), 0.3 * 0.3,
                                   rtol=1e-5)

    def test_no_lights_returns_none(self):
        mb = MaterialBuilder()
        m = mb.add_rough((0.5, 0.5, 0.5))
        tris = Triangles.from_arrays(
            np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32),
            material_id=m)
        scene = Scene(spheres=Spheres.empty(), triangles=tris)
        assert collect_area_lights(scene, mb.build()) is None

    def test_sample_pdf_inverse_square(self):
        scene, mats, _ = build_cornell_box(with_blocks=False)
        lights = collect_area_lights(scene, mats)
        # shading point straight under the light center
        p_near = jnp.asarray([[0.5, 0.9, 0.5]])
        p_far = jnp.asarray([[0.5, 0.2, 0.5]])
        pid = jnp.asarray([7], jnp.int32)
        _, dist_n, pdf_n, _, _ = sample_lights(lights, p_near, pid, 0, 0, 1)
        _, dist_f, pdf_f, _, _ = sample_lights(lights, p_far, pid, 0, 0, 1)
        # same (u) sample => same light point; pdf scales ~ dist^2 / cos
        assert float(pdf_f[0]) > float(pdf_n[0])


def _quad(x0, x1, y0, y1, z, mat, up):
    """Axis-aligned horizontal quad at height z as two triangles.
    up=True faces +z (floor), False faces -z (ceiling light)."""
    a, b, c, d = [x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]
    tris = [[a, b, c], [a, c, d]] if up else [[a, c, b], [a, d, c]]
    nz = 1.0 if up else -1.0
    v = np.asarray(tris, np.float32)
    n = np.tile(np.asarray([0.0, 0.0, nz], np.float32), (2, 3, 1))
    return v, n, np.asarray([mat, mat], np.int32)


def _two_light_scene():
    """Diffuse floor under two emissive panels of very unequal power:
    a small bright one (area 0.04, L=80) and a large dim one (area 4,
    L=0.4).  Two thirds of the flux comes from the panel that
    area-weighted selection picks ~1% of the time."""
    mb = MaterialBuilder()
    floor_m = mb.add_rough((0.7, 0.7, 0.7))
    bright = mb.add_emissive((80.0, 80.0, 80.0))
    dim = mb.add_emissive((0.4, 0.4, 0.4))
    parts = [
        _quad(-3, 3, -3, 3, 0.0, floor_m, up=True),
        _quad(-1.1, -0.9, -0.1, 0.1, 2.0, bright, up=False),
        _quad(0.0, 2.0, -1.0, 1.0, 2.0, dim, up=False),
    ]
    v = np.concatenate([p[0] for p in parts])
    n = np.concatenate([p[1] for p in parts])
    m = np.concatenate([p[2] for p in parts])
    scene = Scene(spheres=Spheres.empty(),
                  triangles=Triangles.from_arrays(v, n, m))
    cam = Camera.look_at((0.0, -4.0, 1.2), (0.0, 0.0, 0.6), (0.0, 0.0, 1.0))
    return scene, mb.build(), cam


class TestPowerWeightedLights:
    def test_selection_tables(self):
        scene, mats, _ = _two_light_scene()
        lights = collect_area_lights(scene, mats)
        assert lights.count == 4
        area = np.asarray(lights.area)
        emission = np.asarray(lights.emission)
        lum = emission @ np.asarray([0.2126, 0.7152, 0.0722])
        weight = area * lum
        sel = weight / weight.sum()
        np.testing.assert_allclose(np.asarray(lights.cdf), np.cumsum(sel),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(lights.pdf_scale),
                                   sel / area, rtol=1e-5)
        # dense triangle->light map: light row at the light triangles,
        # -1 elsewhere
        tli = np.asarray(lights.tri_light_idx)
        assert tli.shape == (scene.triangle_count,)
        np.testing.assert_array_equal(tli[np.asarray(lights.tri_id)],
                                      np.arange(lights.count))
        mask = np.ones(scene.triangle_count, bool)
        mask[np.asarray(lights.tri_id)] = False
        assert (tli[mask] == -1).all()
        # the small bright panel (2/3 of the flux) gets 2/3 selection mass
        np.testing.assert_allclose(sel[:2].sum(), 2.0 / 3.0, rtol=1e-5)

    def test_area_fallback_matches_old_behavior(self):
        scene, mats, _ = _two_light_scene()
        lights = collect_area_lights(scene, mats, power_weighted=False)
        np.testing.assert_allclose(
            np.asarray(lights.pdf_scale),
            np.full(4, 1.0 / float(lights.total_area)), rtol=1e-5)

    def test_lower_variance_same_mean(self):
        """Equal-spp RMSE vs a converged truth: power-weighted selection
        must beat area-weighted on the unequal-power scene, and both must
        agree in the mean (pdf consistency)."""
        scene, mats, cam = _two_light_scene()
        bi = make_intersector(scene)
        l_pow = collect_area_lights(scene, mats)
        l_area = collect_area_lights(scene, mats, power_weighted=False)
        truth, _, _ = render_path(scene, mats, l_pow, cam, 16, 16,
                                  spp=768, seed=1, intersector=bi,
                                  max_depth=3)
        img_p, _, _ = render_path(scene, mats, l_pow, cam, 16, 16,
                                  spp=8, seed=7, intersector=bi, max_depth=3)
        img_a, _, _ = render_path(scene, mats, l_area, cam, 16, 16,
                                  spp=8, seed=7, intersector=bi, max_depth=3)
        t = np.asarray(truth)
        rmse_p = float(np.sqrt(((np.asarray(img_p) - t) ** 2).mean()))
        rmse_a = float(np.sqrt(((np.asarray(img_a) - t) ** 2).mean()))
        # measured 11-14x across seeds; assert a conservative 3x
        assert rmse_p < rmse_a / 3.0, (rmse_p, rmse_a)
        # mean agreement: a 768-spp area-weighted render converges to the
        # same image (both estimators are unbiased)
        truth_a, _, _ = render_path(scene, mats, l_area, cam, 16, 16,
                                    spp=768, seed=3, intersector=bi,
                                    max_depth=3)
        ta = np.asarray(truth_a)
        rel = np.abs(t - ta) / (t + 0.05)
        assert rel.mean() < 0.1, rel.mean()


class TestCornell:
    @pytest.fixture(scope="class")
    def setup(self):
        scene, mats, cam = build_cornell_box()
        lights = collect_area_lights(scene, mats)
        bi = make_intersector(scene)
        return scene, mats, lights, cam, bi

    def test_render_statistics(self, setup):
        scene, mats, lights, cam, bi = setup
        img, alb, nrm = render_path(scene, mats, lights, cam, 48, 48,
                                    spp=16, seed=3, intersector=bi)
        a = np.asarray(img)
        assert not np.isnan(a).any()
        assert (a >= 0).all()
        # light panel region is the brightest thing in view
        top = a[2:8, 18:30].mean()
        floor = a[40:46, 18:30].mean()
        assert top > floor
        # red wall on the left, green on the right
        left = a[20:28, 2:6]
        right = a[20:28, 42:46]
        assert left[..., 0].mean() > left[..., 1].mean()
        assert right[..., 1].mean() > right[..., 0].mean()

    @pytest.mark.slow
    def test_nee_and_bsdf_only_agree(self, setup):
        """MIS consistency: the NEE+MIS estimator and the BSDF-only
        estimator must converge to the same mean image — the strongest
        single test of the sampling weights."""
        scene, mats, lights, cam, bi = setup
        img_nee, _, _ = render_path(scene, mats, lights, cam, 24, 24,
                                    spp=192, seed=5, intersector=bi)
        img_bsdf, _, _ = render_path(scene, mats, None, cam, 24, 24,
                                     spp=768, seed=11, intersector=bi,
                                     max_depth=8)
        a = np.asarray(img_nee).mean(axis=-1)
        b = np.asarray(img_bsdf).mean(axis=-1)
        # ignore the light panel itself (delta-bright, slow convergence)
        mask = a < 2.0
        rel = np.abs(a - b)[mask] / (a[mask] + 0.05)
        assert rel.mean() < 0.15, f"mean rel diff {rel.mean():.3f}"

    def test_deterministic(self, setup):
        scene, mats, lights, cam, bi = setup
        a, _, _ = render_path(scene, mats, lights, cam, 16, 16, spp=4,
                              seed=9, intersector=bi)
        b, _, _ = render_path(scene, mats, lights, cam, 16, 16, spp=4,
                              seed=9, intersector=bi)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.slow
    def test_shadows_exist(self, setup):
        scene, mats, lights, cam, bi = setup
        img, _, _ = render_path(scene, mats, lights, cam, 64, 64, spp=32,
                                seed=2, intersector=bi)
        a = np.asarray(img).mean(-1)
        # the region under the short block (right side, below it) is darker
        # than the open floor next to it
        open_floor = a[56:62, 6:16].mean()
        assert open_floor > 0.01


class TestMarchVsBVHImage:
    """Two accelerated intersectors (the plain XLA LBVH walk with spheres
    in the tree vs the production traversal kernel, in interpret mode)
    must produce the same image."""

    @pytest.mark.slow
    def test_matches_binary_bvh_image(self):
        from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
        v, n = sphere_with_n_triangles(2000)
        mb = MaterialBuilder()
        m = mb.add_rough((0.6, 0.3, 0.2))
        mats = mb.build()
        scene = Scene(
            spheres=Spheres.from_list([((0, 0, -100.5), 100.0, m)]),
            triangles=Triangles.from_arrays(v, n, m))
        cam = Camera.look_at((3, 0, 0.3), (0, 0, 0), (0, 0, 1))
        bi = make_intersector(scene)
        pi = gpu_traverse.build(scene, interpret=True)
        img_b, _, _ = wavefront.render(scene, mats, cam, 32, 24, spp=1,
                                       seed=1, intersector=bi, jitter=False)
        img_p, _, _ = wavefront.render(scene, mats, cam, 32, 24, spp=1,
                                       seed=1, intersector=pi, jitter=False)
        # same RNG + same hits -> near-identical; ulp-chaos only
        diff = np.abs(np.asarray(img_b) - np.asarray(img_p))
        assert np.median(diff) < 1e-5
        assert (diff > 0.05).mean() < 0.02

    def test_cornell_with_march(self):
        scene, mats, cam = build_cornell_box()
        lights = collect_area_lights(scene, mats)
        pi = gpu_traverse.build(scene)
        img, _, _ = render_path(scene, mats, lights, cam, 24, 24, spp=8,
                                seed=3, intersector=pi)
        a = np.asarray(img)
        assert not np.isnan(a).any() and (a >= 0).all()
        assert a.mean() > 0.05


class TestFilm:
    def test_accumulation_mean(self):
        film = Film.create(4, 4)
        one = jnp.ones((4, 4, 3))
        film = film.add(one, samples=2)
        film = film.add(one * 4.0, samples=2)
        np.testing.assert_allclose(np.asarray(film.mean()), 2.5)
        assert int(film.spp) == 4

    def test_checkpoint_roundtrip(self, tmp_path):
        film = Film.create(8, 8).add(jnp.full((8, 8, 3), 0.25), samples=7)
        path = str(tmp_path / "ckpt.npz")
        film.checkpoint(path, meta={"seed": 3})
        restored = Film.restore(path)
        np.testing.assert_array_equal(np.asarray(restored.accum),
                                      np.asarray(film.accum))
        assert int(restored.spp) == 7

    def test_save_png(self, tmp_path):
        film = Film.create(8, 8).add(jnp.full((8, 8, 3), 0.5), samples=1)
        p = str(tmp_path / "f.png")
        film.save(p)
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


class TestRussianRoulette:
    @pytest.mark.slow
    def test_unbiased_mean(self):
        """RR-on and RR-off renders agree in the mean (unbiased estimator)."""
        scene, mats, cam = build_cornell_box()
        lights = collect_area_lights(scene, mats)
        bi = make_intersector(scene)
        img_rr, _, _ = render_path(scene, mats, lights, cam, 32, 32,
                                   spp=96, seed=11, intersector=bi,
                                   max_depth=8, rr_start=2)
        img_no, _, _ = render_path(scene, mats, lights, cam, 32, 32,
                                   spp=96, seed=11, intersector=bi,
                                   max_depth=8, rr_start=8)
        a = np.asarray(img_rr)
        b = np.asarray(img_no)
        assert not np.isnan(a).any()
        # same-seed primary/NEE contributions are identical; RR only
        # perturbs deep indirect light, so the means must agree closely
        assert abs(a.mean() - b.mean()) / b.mean() < 0.03
        # but RR must actually fire: deep-path contributions differ
        assert np.abs(a - b).max() > 0.0


class TestFireflyClamp:
    @pytest.mark.slow
    def test_clamp_suppresses_indirect_only(self):
        scene, mats, cam = build_cornell_box(sphere_instead_of_tall_block=True)
        lights = collect_area_lights(scene, mats)
        base, alb, _ = render_path(scene, mats, lights, cam, 48, 48, spp=8,
                                   seed=2, jitter=False)
        tight, _, _ = render_path(scene, mats, lights, cam, 48, 48, spp=8,
                                  seed=2, clamp=0.5, jitter=False)
        loose, _, _ = render_path(scene, mats, lights, cam, 48, 48, spp=8,
                                  seed=2, clamp=1e6, jitter=False)
        a, t, l = np.asarray(base), np.asarray(tight), np.asarray(loose)
        assert not np.isnan(t).any()
        # tight clamp only darkens (and does darken somewhere)
        assert (t <= a + 1e-6).all() and t.mean() < a.mean()
        # camera-visible emitters (albedo guide = emission > 1) untouched
        lamp = np.asarray(alb).max(-1) > 1.0
        assert lamp.any()
        np.testing.assert_allclose(t[lamp], a[lamp], atol=1e-6)
        # huge clamp ~ no clamp (1-ulp fp reassociation tolerance)
        np.testing.assert_allclose(l, a, atol=1e-6)
