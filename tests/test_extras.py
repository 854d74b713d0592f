"""Tests for the denoiser, OBJ loader, env maps, and textures."""

import os
import time

import numpy as np
import pytest
import jax.numpy as jnp

from optix_ray_tracer_tpu.io.obj import obj_to_scene, read_mtl, read_obj
from optix_ray_tracer_tpu.render.denoise import denoise, skip_denoise
from optix_ray_tracer_tpu.render.envmap import EnvMap, constant_env, gradient_sky
from optix_ray_tracer_tpu.scene.textures import (
    TextureSet, build_texture_set, checker_texture,
)

CUBE_OBJ = """# simple quad + tri
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl blue
f 1/1/1 3/3/1 4/4/1
"""

CUBE_MTL = """newmtl red
Kd 0.8 0.1 0.1
newmtl blue
Kd 0.1 0.1 0.8
newmtl shiny
Ks 0.9 0.9 0.9
Ns 500
newmtl lamp
Ke 5 5 5
"""


class TestObj:
    def test_parse_with_fan_triangulation(self, tmp_path):
        p = tmp_path / "m.obj"
        p.write_text(CUBE_OBJ)
        mesh = read_obj(str(p))
        assert mesh.triangle_count == 3  # quad -> 2 + 1
        assert mesh.material_names == ["red", "red", "blue"]
        np.testing.assert_allclose(mesh.normals[0, 0], [0, 0, 1])
        np.testing.assert_allclose(mesh.uvs[0, 1], [1, 0])

    def test_negative_indices(self, tmp_path):
        p = tmp_path / "m.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
        mesh = read_obj(str(p))
        assert mesh.triangle_count == 1
        np.testing.assert_allclose(mesh.vertices[0, 2], [0, 1, 0])

    def test_missing_normals_get_face_normal(self, tmp_path):
        p = tmp_path / "m.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        mesh = read_obj(str(p))
        np.testing.assert_allclose(np.abs(mesh.normals[0, 0]), [0, 0, 1],
                                   atol=1e-6)

    def test_mtl_and_scene(self, tmp_path):
        (tmp_path / "m.obj").write_text(CUBE_OBJ)
        (tmp_path / "m.mtl").write_text(CUBE_MTL)
        mtls = read_mtl(str(tmp_path / "m.mtl"))
        assert mtls["red"].kd == (0.8, 0.1, 0.1)
        tris, mats, mesh = obj_to_scene(str(tmp_path / "m.obj"))
        assert tris.count == 3
        # red/blue distinct material rows
        ids = np.asarray(tris.material_id)
        assert ids[0] == ids[1] != ids[2]


class TestEnvMap:
    def test_constant(self):
        env = constant_env((0.2, 0.4, 0.6))
        d = jnp.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
        out = np.asarray(env.sample(d))
        np.testing.assert_allclose(out, [[0.2, 0.4, 0.6]] * 3, atol=1e-6)

    def test_gradient_sky_up_vs_down(self):
        env = gradient_sky()
        up = np.asarray(env.sample(jnp.asarray([[0.0, 0.0, 1.0]])))[0]
        down = np.asarray(env.sample(jnp.asarray([[0.0, 0.0, -1.0]])))[0]
        assert up[2] > up[0]          # zenith is blue
        assert down[0] > down[2]      # ground is brown

    def test_sun_disk(self):
        env = gradient_sky(sun_dir=(0, 0, 1), sun_radiance=(100, 100, 100),
                           sun_cos=0.95)
        up = np.asarray(env.sample(jnp.asarray([[0.0, 0.0, 1.0]])))[0]
        side = np.asarray(env.sample(jnp.asarray([[1.0, 0.0, 0.0]])))[0]
        assert up[0] > 50 and side[0] < 2

    def test_render_with_env(self):
        from optix_ray_tracer_tpu.render import wavefront
        from optix_ray_tracer_tpu.scene.camera import Camera
        from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles
        from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
        mb = MaterialBuilder()
        m = mb.add_metal((0.9, 0.9, 0.9), 0.0)
        scene = Scene(spheres=Spheres.from_list([((0, 0, 0), 0.5, m)]),
                      triangles=Triangles.empty())
        cam = Camera.look_at((3, 0, 0), (0, 0, 0), (0, 0, 1))
        env = gradient_sky()
        img, _, _ = wavefront.render(scene, mb.build(), cam, 16, 16, spp=1,
                                     seed=0, env=env, jitter=False)
        a = np.asarray(img)
        assert not np.isnan(a).any()
        # top of frame = sky (blue-ish), bottom = ground (brown-ish)
        assert a[0, 0, 2] > a[0, 0, 0]
        assert a[15, 0, 0] > a[15, 0, 2]


class TestEnvImportanceSampling:
    SUN = dict(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.9995)

    def test_pdf_integrates_to_sphere(self):
        """MC check of the sampler: E[1/pdf] over importance samples must
        equal the total solid angle 4*pi, the pdf lookup must reproduce
        the sampling pdf, and radiance/pdf must stay bounded (the 3x3 max
        filter's no-firefly guarantee)."""
        env = gradient_sky(**self.SUN)
        rs = np.random.RandomState(0)
        n = 100_000
        us = [jnp.asarray(rs.rand(n), jnp.float32) for _ in range(4)]
        d, pdf = env.sample_direction(*us)
        d, pdf = np.asarray(d), np.asarray(pdf)
        assert (pdf > 0).all()
        np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0,
                                   atol=1e-4)
        est = float((1.0 / pdf).mean())
        assert abs(est - 4 * np.pi) / (4 * np.pi) < 0.02, est
        pdf2 = np.asarray(env.pdf_solid_angle(jnp.asarray(d)))
        frac_off = float((np.abs(pdf2 - pdf) / pdf > 1e-3).mean())
        assert frac_off < 0.005, frac_off  # texel-edge float rounding only
        lum = (np.asarray(env.sample(jnp.asarray(d)))
               @ np.asarray([0.2126, 0.7152, 0.0722]))
        assert float((lum / pdf).max()) < 100.0
        # a tables-free map reports itself unsampleable
        assert not EnvMap(image=env.image).can_sample
        assert env.can_sample

    def test_constant_map_skips_tables(self):
        """Near-constant maps don't build sampling tables: env NEE would
        pay a shadow wave per diffuse vertex for a worse-than-cosine
        uniform sphere sample."""
        assert not constant_env((0.5, 0.5, 0.5)).can_sample
        assert gradient_sky().can_sample  # sky/ground contrast is enough

    def test_large_map_dim_texels_survive_float32(self):
        """Production-size map with extreme dynamic range: a flat float32
        CDF would collapse dim texels to zero-width spans (never sampled
        while the MIS counterpart claims pdf > 0 = energy loss).  The
        two-level CDF must keep E[1/pdf] = 4*pi and actually reach dim
        regions."""
        from optix_ray_tracer_tpu.render.envmap import _with_tables

        rs = np.random.RandomState(3)
        img = rs.uniform(0.01, 0.05, (512, 1024, 3)).astype(np.float32)
        img[100:102, 200:202] = 3e4  # tiny sun, 6 orders above the floor
        env = _with_tables(img)
        # the dim floor's per-texel CDF spans are ~7e-8 of the total —
        # at float32 ULP near 1.0, i.e. exactly the flat-CDF collapse
        # regime — while still carrying a few % of the total weight
        n = 200_000
        us = [jnp.asarray(rs.rand(n), jnp.float32) for _ in range(4)]
        d, pdf = env.sample_direction(*us)
        d, pdf = np.asarray(d), np.asarray(pdf)
        est = float((1.0 / pdf).mean())
        assert abs(est - 4 * np.pi) / (4 * np.pi) < 0.05, est
        away = d[:, 2] < -0.5  # sun sits at theta~35deg (z~+0.8)
        # dim weight share ~3.5%, z<-0.5 is ~1/4 of the dim sphere: if
        # float32 spans dropped the floor this would be ~0
        assert float(away.mean()) > 0.004, float(away.mean())
        pdf2 = np.asarray(env.pdf_solid_angle(jnp.asarray(d)))
        frac_off = float((np.abs(pdf2 - pdf) / pdf > 1e-3).mean())
        assert frac_off < 0.005, frac_off

    def test_sun_concentration(self):
        """Most CDF mass sits on the sun disk texels."""
        env = gradient_sky(**self.SUN)
        rs = np.random.RandomState(1)
        us = [jnp.asarray(rs.rand(50_000), jnp.float32) for _ in range(4)]
        d, _ = env.sample_direction(*us)
        sd = np.asarray(self.SUN["sun_dir"], np.float64)
        sd /= np.linalg.norm(sd)
        frac = float(((np.asarray(d) @ sd) > 0.99).mean())
        # sun disk covers ~0.025% of the sphere; importance sampling puts
        # a few percent of samples there (the rest rides the sky gradient)
        assert frac > 0.02, frac

    @pytest.mark.slow
    def test_env_nee_unbiased_and_lower_variance(self):
        """Path renders with env NEE (tables present) and BSDF-only
        (tables stripped) must agree in the mean; at equal spp the
        importance-sampled render must have much lower error on a
        sun-lit scene."""
        from optix_ray_tracer_tpu.ops.traverse import make_intersector
        from optix_ray_tracer_tpu.render.pathtracer import render_path
        from optix_ray_tracer_tpu.scene.camera import Camera
        from optix_ray_tracer_tpu.scene.geometry import (
            Scene, Spheres, Triangles,
        )
        from optix_ray_tracer_tpu.scene.materials import MaterialBuilder

        mb = MaterialBuilder()
        g = mb.add_rough((0.7, 0.7, 0.7))
        r = mb.add_rough((0.6, 0.1, 0.1))
        scene = Scene(
            spheres=Spheres.from_list([((0, 0, -100.5), 100.0, g),
                                       ((0, 0, 0), 0.5, r)]),
            triangles=Triangles.empty())
        cam = Camera.look_at((3.5, 0, 0.6), (0, 0, 0), (0, 0, 1))
        bi = make_intersector(scene)
        env = gradient_sky(**self.SUN)
        env_plain = EnvMap(image=env.image)
        mats = mb.build()

        truth, _, _ = render_path(scene, mats, None, cam, 24, 24, spp=384,
                                  seed=1, intersector=bi, env=env,
                                  max_depth=4)
        bsdf_hi, _, _ = render_path(scene, mats, None, cam, 24, 24,
                                    spp=1536, seed=2, intersector=bi,
                                    env=env_plain, max_depth=4)
        t = np.asarray(truth)
        rel = np.abs(t.mean(-1) - np.asarray(bsdf_hi).mean(-1)) \
            / (t.mean(-1) + 0.05)
        assert rel.mean() < 0.06, rel.mean()

        i1, _, _ = render_path(scene, mats, None, cam, 24, 24, spp=4,
                               seed=7, intersector=bi, env=env, max_depth=4)
        i2, _, _ = render_path(scene, mats, None, cam, 24, 24, spp=4,
                               seed=7, intersector=bi, env=env_plain,
                               max_depth=4)
        rmse_is = float(np.sqrt(((np.asarray(i1) - t) ** 2).mean()))
        rmse_bs = float(np.sqrt(((np.asarray(i2) - t) ** 2).mean()))
        # measured ~4-5x on this scene; assert a conservative 2x
        assert rmse_is < rmse_bs / 2.0, (rmse_is, rmse_bs)


class TestTextures:
    def test_checker_sample(self):
        tex = checker_texture(res=64, tiles=2)
        ts = build_texture_set([tex], [0])
        # uv (0.25, 0.75): first tile row/col -> bright
        mid = jnp.asarray([0], jnp.int32)
        bright = np.asarray(ts.sample(mid, jnp.asarray([[0.2, 0.8]])))[0]
        dark = np.asarray(ts.sample(mid, jnp.asarray([[0.7, 0.8]])))[0]
        assert bright.mean() != dark.mean()

    def test_untextured_material_returns_one(self):
        ts = build_texture_set([checker_texture(32)], [0, -1])
        out = np.asarray(ts.sample(jnp.asarray([1], jnp.int32),
                                   jnp.asarray([[0.5, 0.5]])))
        np.testing.assert_allclose(out, 1.0)

    def test_textured_cornell_path(self):
        from optix_ray_tracer_tpu.render.pathtracer import render_path
        from optix_ray_tracer_tpu.scene.cornell import build_cornell_box
        from optix_ray_tracer_tpu.scene.lights import collect_area_lights
        import dataclasses as dc
        import jax.numpy as jnp2

        scene, mats, cam = build_cornell_box(with_blocks=False)
        # give every triangle planar uvs + hook material 0 to a checker
        T = scene.triangle_count
        v = np.asarray(scene.triangles.vertices)
        uv = v[..., [0, 2]]  # xz-planar projection
        tris = dc.replace(scene.triangles, uvs=jnp2.asarray(uv))
        scene = dc.replace(scene, triangles=tris)
        ts = build_texture_set([checker_texture(64, tiles=4)],
                               [0] + [-1] * (mats.count - 1))
        lights = collect_area_lights(scene, mats)
        img, _, _ = render_path(scene, mats, lights, cam, 32, 32, spp=8,
                                seed=1, textures=ts)
        a = np.asarray(img)
        assert not np.isnan(a).any()
        # floor shows checker variance
        floor = a[26:31, 8:24].mean(-1)
        assert floor.std() > 0.01


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """Encode (H, W, C) uint8 as a PNG whose row y uses filter filters[y]
    (PNG spec section 9), predicting from the original neighbours; a
    filter byte above 4 is written as is over unfiltered bytes."""
    import struct
    import zlib

    h, w, c = img.shape
    x = np.zeros((h + 1, w + 1, c), np.int32)
    x[1:, 1:] = img
    a, b, cc = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(a), a, b, (a + b) >> 1, paeth]
    rows = [bytes([f]) + ((x[y + 1, 1:] - preds[f if f < 5 else 0][y]) & 255)
            .astype(np.uint8).tobytes() for y, f in enumerate(filters)]

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


class TestReadPng:
    @pytest.mark.parametrize("channels", [1, 2, 3, 4])
    @pytest.mark.parametrize("filters", ["none", "sub", "up", "average",
                                         "paeth", "mixed"])
    def test_filters_round_trip(self, channels, filters):
        from optix_ray_tracer_tpu.utils.color import read_png

        rng = np.random.default_rng(channels)
        h, w = 9, 13
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        kinds = ["none", "sub", "up", "average", "paeth"]
        rows = (rng.integers(0, 5, h) if filters == "mixed"
                else [kinds.index(filters)] * h)
        np.testing.assert_array_equal(read_png(_filtered_png(img, rows)),
                                      img)

    def test_bad_filter_type_raises(self):
        from optix_ray_tracer_tpu.utils.color import read_png

        img = np.zeros((4, 5, 3), np.uint8)
        with pytest.raises(ValueError, match="filter"):
            read_png(_filtered_png(img, [0, 1, 5, 0]))

    def test_load_texture_png(self, tmp_path):
        """A filtered RGB PNG texture loads to linear floats."""
        from optix_ray_tracer_tpu.scene.textures import load_texture
        from optix_ray_tracer_tpu.utils.color import srgb_to_linear

        img = np.random.default_rng(5).integers(0, 256, (6, 7, 3),
                                                dtype=np.uint8)
        p = tmp_path / "tex.png"
        p.write_bytes(_filtered_png(img, [4, 1, 3, 2, 0, 4]))
        tex = load_texture(str(p))
        assert tex.shape == (6, 7, 3)
        np.testing.assert_allclose(
            tex, np.asarray(srgb_to_linear(img / np.float32(255.0))),
            rtol=1e-6, atol=1e-7)


class TestDenoise:
    @pytest.mark.slow
    def test_reduces_noise_preserves_edges(self):
        rng = np.random.default_rng(0)
        h = w = 64
        # two flat regions with an albedo edge + noise
        clean = np.ones((h, w, 3), np.float32) * 0.5
        albedo = np.ones((h, w, 3), np.float32)
        albedo[:, w // 2:] = 0.2
        normal = np.zeros((h, w, 3), np.float32)
        normal[..., 2] = 1.0
        noisy = clean * albedo + rng.normal(0, 0.1, (h, w, 3)).astype(np.float32)
        out = np.asarray(denoise(jnp.asarray(noisy), jnp.asarray(albedo),
                                 jnp.asarray(normal)))
        res_noisy = (noisy - clean * albedo).std()
        res_out = (out - clean * albedo).std()
        assert res_out < res_noisy * 0.5
        # albedo edge preserved (demodulation): mean levels still distinct
        assert abs(out[:, :w // 2].mean() - 0.5) < 0.1
        assert abs(out[:, w // 2:].mean() - 0.1) < 0.05

    @pytest.mark.slow
    def test_normal_edge_stops_filtering(self):
        h = w = 32
        img = np.zeros((h, w, 3), np.float32)
        img[:, w // 2:] = 1.0
        normal = np.zeros((h, w, 3), np.float32)
        normal[:, :w // 2, 2] = 1.0
        normal[:, w // 2:, 0] = 1.0   # 90-degree normal edge
        albedo = np.ones_like(img)
        out = np.asarray(denoise(jnp.asarray(img), jnp.asarray(albedo),
                                 jnp.asarray(normal)))
        # the edge stays sharp: columns adjacent to the seam barely change
        assert out[:, w // 2 - 3].mean() < 0.15
        assert out[:, w // 2 + 2].mean() > 0.85

    def test_skip_passthrough(self):
        x = jnp.ones((4, 4, 3))
        assert skip_denoise(x) is x

    def test_sky_pixels_pass_through(self):
        # miss pixels have zero-normal guides; they must not be zeroed
        img = np.full((16, 16, 3), 0.8, np.float32)
        albedo = np.zeros((16, 16, 3), np.float32)
        normal = np.zeros((16, 16, 3), np.float32)
        out = np.asarray(denoise(jnp.asarray(img), jnp.asarray(albedo),
                                 jnp.asarray(normal)))
        np.testing.assert_allclose(out, img, atol=1e-5)


class TestViewer:
    def test_mjpeg_stream_and_input(self):
        """ViewerServer end-to-end on a stub render_fn: PNG multipart
        parts (decoded back to the rendered frame), input endpoints, clean
        quit."""
        import urllib.request
        import numpy as np
        from optix_ray_tracer_tpu.render.viewer import ViewerServer
        from optix_ray_tracer_tpu.scene.camera import Camera

        calls = []

        def render_fn(camera):
            calls.append(camera)
            return np.full((12, 16, 4), 128, np.uint8)

        cam = Camera.look_at((0, 0, 1), (0, 0, 0), (0, 1, 0))
        srv = ViewerServer(cam, render_fn, port=0, fps_limit=60.0)
        srv.serve(blocking=False)
        port = srv._httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"
        try:
            deadline = time.time() + 10
            while srv.latest_frame() is None and time.time() < deadline:
                time.sleep(0.05)
            frame = srv.latest_frame()
            assert frame is not None
            data, ctype = frame
            assert ctype == b"image/png"
            from optix_ray_tracer_tpu.utils.color import read_png
            np.testing.assert_array_equal(
                read_png(data), np.full((12, 16, 4), 128, np.uint8))
            with urllib.request.urlopen(f"{base}/stream", timeout=5) as r:
                head = r.read(64)
            assert b"--frame" in head and b"image/png" in head
            for path, code in [("/key?k=w", 204), ("/look?dx=5&dy=-3", 204),
                               ("/look?dx=abc", 204)]:
                req = urllib.request.urlopen(base + path, timeout=5)
                assert req.status == code
        finally:
            urllib.request.urlopen(f"{base}/quit", timeout=5)


class TestBenchmarkConfigs:
    def test_run_config1(self):
        from optix_ray_tracer_tpu.models import benchmarks
        cfg = benchmarks.ALL_CONFIGS[1]()
        (img, alb, nrm), stats = benchmarks.run(cfg, spp=2, width=64,
                                                height=48)
        assert img.shape == (48, 64, 3)
        assert stats["spp_per_sec"] > 0
        assert not np.isnan(np.asarray(img)).any()

    def test_run_config4_cornell(self):
        from optix_ray_tracer_tpu.models import benchmarks
        cfg = benchmarks.ALL_CONFIGS[4]()
        (img, _, _), stats = benchmarks.run(cfg, spp=2, width=48, height=48)
        assert stats["triangles"] > 0
        # light patch should be bright, floor lit
        assert float(np.asarray(img).max()) > 0.5
