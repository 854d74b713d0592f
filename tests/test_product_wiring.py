"""Config-reachable extensions + debug-mode + denoiser wiring.

VERDICT round-1 items 5/8/9: the denoiser runs in the product loop, the
``debug-mode`` flag maps to real validation, and integrator/envmap/
textures/meshes/extra materials are reachable from config.json.
"""

import json
import os

import numpy as np
import pytest

from optix_ray_tracer_tpu.io.config import ConfigError, parse_config_dict
from optix_ray_tracer_tpu.models import common, renderer_mesh

from test_frontends import _mesh_config, MESH_VTK  # noqa: F401 (fixture src)

QUAD_OBJ = """\
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
f 1 2 3
f 1 3 4
"""


def _base_dict(tmp_path, n_files=1):
    cfg = _mesh_config(tmp_path, n_files=n_files)
    # round-trip: rebuild the raw dict for extension edits
    return cfg


class TestConfigExtensions:
    def test_integrator_and_denoise_keys(self, tmp_path):
        cfg = parse_config_dict({"integrator": "path", "denoise": False})
        assert cfg.integrator == "path"
        assert cfg.denoise is False
        # defaults: whitted + denoise on (reference hot-loop parity)
        cfg2 = parse_config_dict({})
        assert cfg2.integrator == "whitted"
        assert cfg2.denoise is True
        assert cfg2.denoiser == "atrous"

    def test_denoise_filter_names(self):
        cfg = parse_config_dict({"denoise": "neural"})
        assert cfg.denoise is True and cfg.denoiser == "neural"
        cfg = parse_config_dict({"denoise": "atrous"})
        assert cfg.denoise is True and cfg.denoiser == "atrous"
        cfg = parse_config_dict({"denoise": "off"})
        assert cfg.denoise is False
        with pytest.raises(ConfigError):
            parse_config_dict({"denoise": "bilateral"})

    def test_invalid_integrator_rejected(self):
        with pytest.raises(ConfigError):
            parse_config_dict({"integrator": "bidirectional"})

    def test_extension_materials(self):
        cfg = parse_config_dict({
            "dielectrics": [{"ior": 1.33}],
            "emissives": [{"emission": [10, 10, 8]}],
            "roughs": [{"albedo": [0.5, 0.5, 0.5]}],
            "spheres": [{"center": [0, 0, 0], "radius": 1.0,
                         "mat-type": "DIELECTRIC", "mat-index": 0}],
        })
        assert cfg.dielectrics == [1.33]
        assert cfg.emissives == [(10.0, 10.0, 8.0)]
        table, bases = common.build_materials(cfg, 0)
        from optix_ray_tracer_tpu.scene.materials import DIELECTRIC, EMISSIVE
        assert int(table.mtype[bases.dielectric]) == DIELECTRIC
        assert int(table.mtype[bases.emissive]) == EMISSIVE
        spheres = common.build_extra_spheres(cfg, bases)
        assert int(spheres.material_id[0]) == bases.dielectric

    def test_extension_mat_index_validated(self):
        with pytest.raises(ConfigError):
            parse_config_dict({
                "spheres": [{"center": [0, 0, 0], "radius": 1.0,
                             "mat-type": "EMISSIVE", "mat-index": 0}]})

    def test_envmap_key(self):
        cfg = parse_config_dict({"envmap": {"type": "gradient-sky",
                                            "sun-direction": [0, 0, 1]}})
        env = common.build_envmap(cfg)
        assert env is not None
        up = env.sample(np.asarray([[0.0, 0.0, 1.0]], np.float32))
        assert np.all(np.asarray(up) > 0)
        with pytest.raises(ConfigError):
            parse_config_dict({"envmap": {"type": "cubemap"}})

    def test_textures_key(self, tmp_path):
        cfg = parse_config_dict({
            "roughs": [{"albedo": [1, 1, 1]}],
            "textures": [{"checker": True, "tiles": 4,
                          "mat-type": "ROUGH", "mat-index": 0}]})
        tex = common.build_textures(cfg, common.build_materials(cfg, 0)[1], 1)
        assert tex is not None
        assert int(tex.material_texture[0]) == 0

    def test_meshes_key(self, tmp_path):
        obj = tmp_path / "quad.obj"
        obj.write_text(QUAD_OBJ)
        cfg = parse_config_dict({
            "emissives": [{"emission": [5, 5, 5]}],
            "meshes": [{"obj": "quad.obj", "mat-type": "EMISSIVE",
                        "mat-index": 0, "shift": [0, 0, 2],
                        "scale": [0.5, 0.5, 0.5]}],
        }, base_dir=str(tmp_path))
        _, bases = common.build_materials(cfg, 0)
        tris = common.build_extra_triangles(cfg, bases)
        assert tris.count == 2
        v = np.asarray(tris.vertices)
        np.testing.assert_allclose(v[..., 2], 2.0, atol=1e-6)  # shifted
        assert np.abs(v[..., :2]).max() <= 0.5 + 1e-6          # scaled
        assert int(tris.material_id[0]) == bases.emissive

    def test_meshes_require_obj(self):
        with pytest.raises(ConfigError):
            parse_config_dict({"meshes": [{"mat-type": "ROUGH"}]})


class TestProductLoop:
    @pytest.mark.slow
    def test_denoise_on_by_default_and_bypass(self, tmp_path):
        cfg = _mesh_config(tmp_path, n_files=1)
        assert cfg.denoise is True
        data = renderer_mesh.commit(cfg)
        _, _, film_dn = next(renderer_mesh.render_frames(data, max_frames=1))
        cfg.denoise = False
        _, _, film_raw = next(renderer_mesh.render_frames(data, max_frames=1))
        a = np.asarray(film_dn.mean())
        b = np.asarray(film_raw.mean())
        assert np.isfinite(a).all() and np.isfinite(b).all()
        # the 1-spp Lambertian frame is noisy; the a-trous pass must change it
        assert not np.allclose(a, b)

    @pytest.mark.slow
    def test_path_integrator_from_config(self, tmp_path):
        obj = tmp_path / "light.obj"
        obj.write_text(QUAD_OBJ)
        cfg = _mesh_config(tmp_path, n_files=1)
        cfg.integrator = "path"
        cfg.background = (0.0, 0.0, 0.0)
        cfg.emissives = [(20.0, 20.0, 16.0)]
        cfg.meshes = [{"obj": str(obj), "mat-type": "EMISSIVE",
                       "mat-index": 0, "shift": [0.5, 0.5, 3.0]}]
        data = renderer_mesh.commit(cfg)
        assert data.extra_triangles.count == 2
        scene = renderer_mesh.frame_scene(data, 0, 0, 1)
        lights = common.collect_lights(cfg, scene, data.materials)
        assert lights is not None and lights.count == 2
        _, _, film = next(renderer_mesh.render_frames(data, max_frames=1))
        img = np.asarray(film.mean())
        assert np.isfinite(img).all()
        assert img.max() > 0.0   # the area light illuminates the scene

    @pytest.mark.slow
    def test_envmap_from_config(self, tmp_path):
        cfg = _mesh_config(tmp_path, n_files=1)
        cfg.envmap = {"type": "constant", "color": [2.0, 0.0, 0.0]}
        data = renderer_mesh.commit(cfg)
        assert data.env is not None
        _, _, film = next(renderer_mesh.render_frames(data, max_frames=1))
        img = np.asarray(film.mean())
        # sky pixels show the red constant env instead of the background
        assert img[0, 0, 0] > 1.5 and img[0, 0, 1] < 0.1


class TestDebugMode:
    def test_enable_maps_to_jax_debug_nans(self):
        import jax

        from optix_ray_tracer_tpu.utils import debug

        prev = jax.config.jax_debug_nans
        try:
            debug.enable_debug_mode()
            assert debug.DEBUG_MODE
            assert jax.config.jax_debug_nans
        finally:
            debug.DEBUG_MODE = False
            jax.config.update("jax_debug_nans", prev)

    def test_accel_validation_catches_corruption(self):
        import dataclasses

        import jax.numpy as jnp

        from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
        from optix_ray_tracer_tpu.ops import gpu_traverse
        from optix_ray_tracer_tpu.scene.geometry import (
            Scene, Spheres, Triangles,
        )
        from optix_ray_tracer_tpu.utils import debug
        from optix_ray_tracer_tpu.utils.logging import RendererError

        v, _ = sphere_with_n_triangles(2000)
        scene = Scene(spheres=Spheres.empty(),
                      triangles=Triangles.from_arrays(v))
        engine = gpu_traverse.build(scene)
        debug.validate_accel(engine, scene)  # passes

        bvh = engine.bvh
        bad = dataclasses.replace(engine, bvh=dataclasses.replace(
            bvh, node_max=bvh.node_max.at[0].set(bvh.node_min[0])))
        with pytest.raises(RendererError):
            debug.validate_accel(bad, scene)

    @pytest.mark.parametrize("fault", ["no_refit", "leaf_table", "node_box",
                                       "node_ids", "other_scene"])
    def test_accel_validation_catches_stale_accel(self, fault):
        """An engine out of step with the scene it traces fails validation:
        a refit that did not run after the vertices moved, kernel tables
        that disagree with the tree, or a scene of another size."""
        import dataclasses

        from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
        from optix_ray_tracer_tpu.ops import gpu_traverse
        from optix_ray_tracer_tpu.scene.geometry import (
            Scene, Spheres, Triangles,
        )
        from optix_ray_tracer_tpu.utils import debug
        from optix_ray_tracer_tpu.utils.logging import RendererError

        def scene_of(v):
            return Scene(spheres=Spheres.empty(),
                         triangles=Triangles.from_arrays(v))

        v, _ = sphere_with_n_triangles(500)
        scene = scene_of(v)
        moved = scene_of(np.asarray(v) + 0.05 * np.sin(4.0 * np.asarray(v)))
        engine = gpu_traverse.build(scene)
        refitted = gpu_traverse.refit(engine, moved)
        debug.validate_accel(refitted, moved)  # the refit passes

        if fault == "no_refit":
            bad, target = engine, moved
        elif fault == "leaf_table":
            bad, target = dataclasses.replace(
                refitted, leaves=refitted.leaves.at[3, 1].add(0.01)), moved
        elif fault == "node_box":
            bad, target = dataclasses.replace(
                refitted, nodes=refitted.nodes.at[2, 4].add(0.01)), moved
        elif fault == "node_ids":
            bad, target = dataclasses.replace(
                refitted, nodes=refitted.nodes.at[:, 12:14].set(
                    refitted.nodes[:, 13:11:-1])), moved
        else:
            v2, _ = sphere_with_n_triangles(900)
            bad, target = refitted, scene_of(v2)
        with pytest.raises(RendererError):
            debug.validate_accel(bad, target)

    def test_debug_mode_cli_flag(self, tmp_path, monkeypatch):
        import jax

        from optix_ray_tracer_tpu.utils import debug

        prev = jax.config.jax_debug_nans
        cfg = parse_config_dict({"debug-mode": True})
        assert cfg.debug_mode
        try:
            debug.enable_debug_mode()
            # frontends validate on build in debug mode (smoke)
            from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
            from optix_ray_tracer_tpu.scene.geometry import (
                Scene, Spheres, Triangles,
            )
            v, n = sphere_with_n_triangles(2000)
            scene = Scene(spheres=Spheres.empty(),
                          triangles=Triangles.from_arrays(v, n))
            assert common.choose_intersector(scene) is not None
        finally:
            debug.DEBUG_MODE = False
            jax.config.update("jax_debug_nans", prev)


class TestViewerEndpoints:
    def test_wheel_denoise_anim(self):
        import urllib.request

        from optix_ray_tracer_tpu.render.viewer import ViewerServer
        from optix_ray_tracer_tpu.scene.camera import Camera

        cam = Camera.look_at((3, 0, 0), (0, 0, 0), (0, 0, 1))
        calls = []

        def render_fn(camera, denoise_on=True, animate=False):
            calls.append((denoise_on, animate))
            return np.zeros((8, 8, 4), np.uint8)

        srv = ViewerServer(cam, render_fn, port=0, fps_limit=200.0)
        srv.serve(blocking=False)
        port = srv._httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"
        try:
            assert urllib.request.urlopen(f"{base}/denoise").read() \
                == b"denoise off"
            assert urllib.request.urlopen(f"{base}/anim").read() \
                == b"animation on"
            urllib.request.urlopen(f"{base}/wheel?d=2")
            import time
            deadline = time.time() + 5.0
            while time.time() < deadline:
                if any(c == (False, True) for c in calls):
                    break
                time.sleep(0.02)
            assert any(c == (False, True) for c in calls)
            # /filter cycles default -> atrous -> neural -> default,
            # and ?f= sets directly
            assert urllib.request.urlopen(f"{base}/filter").read() \
                == b"atrous"
            assert urllib.request.urlopen(f"{base}/filter").read() \
                == b"neural"
            assert urllib.request.urlopen(f"{base}/filter").read() \
                == b"default"
            assert urllib.request.urlopen(
                f"{base}/filter?f=neural").read() == b"neural"
            assert srv.filter_name == "neural"
        finally:
            srv.stop()

    def test_chunk_fn_receives_filter_name(self):
        import time
        import urllib.request

        from optix_ray_tracer_tpu.render.viewer import ViewerServer
        from optix_ray_tracer_tpu.scene.camera import Camera

        cam = Camera.look_at((3, 0, 0), (0, 0, 0), (0, 0, 1))
        seen = []

        def render_chunk_fn(camera, chunk, denoise_on, animate,
                            filter_name=None):
            seen.append(filter_name)
            return np.zeros((chunk, 8, 8, 4), np.uint8)

        srv = ViewerServer(cam, render_chunk_fn=render_chunk_fn, chunk=2,
                           port=0, fps_limit=200.0)
        srv.serve(blocking=False)
        port = srv._httpd.server_address[1]
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/filter?f=atrous")
            deadline = time.time() + 5.0
            while time.time() < deadline and "atrous" not in seen:
                time.sleep(0.02)
            assert "atrous" in seen
        finally:
            srv.stop()

    def test_chunked_dispatch_amortization(self):
        """Idle viewer asks for K look-ahead frames per dispatch; input
        drops it to 1 so the camera reacts within a frame.

        Synchronization is by event latches set INSIDE the render
        callback (no sleep-polling): on a loaded 1-vCPU host the render
        thread can stall arbitrarily long, and a poll deadline races it
        — the latch just waits."""
        import threading
        import urllib.request

        from optix_ray_tracer_tpu.render.viewer import ViewerServer
        from optix_ray_tracer_tpu.scene.camera import Camera

        cam = Camera.look_at((3, 0, 0), (0, 0, 0), (0, 0, 1))
        chunks = []
        got_idle = threading.Event()      # >= 3 idle dispatches seen
        got_single = threading.Event()    # a chunk-1 dispatch seen

        def render_chunk_fn(camera, chunk, denoise_on, animate):
            chunks.append(chunk)
            if len(chunks) >= 3:
                got_idle.set()
            if chunk == 1:
                got_single.set()
            return np.zeros((chunk, 8, 8, 4), np.uint8)

        srv = ViewerServer(cam, render_chunk_fn=render_chunk_fn, chunk=4,
                           port=0, fps_limit=500.0)
        srv.serve(blocking=False)
        port = srv._httpd.server_address[1]
        try:
            assert got_idle.wait(timeout=60.0)
            # before any input, every dispatch is the amortized chunk
            assert chunks[0] == 4 and chunks[1] == 4 and chunks[2] == 4
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/look?dx=10&dy=0")
            assert got_single.wait(timeout=60.0)  # input -> single frame
        finally:
            srv.stop()


def _read_png(path):
    """Minimal decoder for the PNGs this repo writes (8-bit, filter 0,
    non-interlaced) — keeps the AOV tests dependency-free."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h, c = 8, b"", 0, 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, _bits, ctype = struct.unpack(">IIBB", payload[:10])
            c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c
    rows = [raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
            for y in range(h)]
    assert all(raw[y * (stride + 1)] == 0 for y in range(h)), "filter 0 only"
    return np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, c)


class TestViewerReSTIR:
    """--viewer with integrator "restir": reservoirs persist across viewer
    frames (temporal reuse follows the fly camera), the interactive regime
    ReSTIR was designed for."""

    def test_viewer_restir_temporal(self, tmp_path, monkeypatch):
        from optix_ray_tracer_tpu.__main__ import main
        from optix_ray_tracer_tpu.render import viewer as viewer_mod
        from optix_ray_tracer_tpu.scene.camera import Camera

        data_dir = tmp_path / "data"
        data_dir.mkdir()
        (data_dir / "m0.vtk").write_text(MESH_VTK)
        (data_dir / "test.vtk.series").write_text(json.dumps(
            {"file-series-version": "1.0",
             "files": [{"name": "m0.vtk", "time": 0.0}]}))
        (data_dir / "light.obj").write_text(QUAD_OBJ)
        cfg = {
            "mesh": True,
            "series-path": str(data_dir),
            "series-name": "test.vtk.series",
            "cache-path": str(tmp_path / "cache"),
            "stl-path": str(data_dir),
            "cache": False,
            "integrator": "restir",
            "denoise": False,
            "background": [0.0, 0.0, 0.0],
            "particle-material-preset": "viridis",
            "roughs": [{"albedo": [0.7, 0.6, 0.5]}],
            "metals": [],
            "emissives": [{"emission": [20.0, 18.0, 15.0]}],
            "meshes": [{"obj": str(data_dir / "light.obj"),
                        "mat-type": "EMISSIVE", "mat-index": 0,
                        "shift": [0.5, 0.5, 2.5], "rotate": [0, 0, 0],
                        "scale": [1, 1, 1]}],
            "spheres": [{"center": [0, 0, 0], "radius": 100.0,
                         "mat-type": "ROUGH", "mat-index": 0,
                         "shift": [0, 0, -100.5], "rotate": [0, 0, 0],
                         "scale": [1, 1, 1]}],
            "loop-data": {"api": "HEADLESS", "window-width": 32,
                          "window-height": 24, "fps": 4,
                          "camera-center": [6, 0, 1],
                          "camera-target": [0.5, 0.5, 0.25],
                          "up-direction": [0, 0, 1],
                          "render-speed-ratio": 1,
                          "particle-shift": [0, 0, 0],
                          "particle-scale": [1, 1, 1]},
        }
        cfgp = tmp_path / "config.json"
        cfgp.write_text(json.dumps(cfg))

        captured = {}

        class FakeServer:
            def __init__(self, camera, render_fn=None, **kw):
                captured["fn"] = render_fn
                captured["camera"] = camera

            def serve(self, blocking=True):
                captured["served"] = True

        monkeypatch.setattr(viewer_mod, "ViewerServer", FakeServer)
        rc = main(["--config", str(cfgp), "--viewer"])
        assert rc == 0 and captured.get("served")

        cam = captured["camera"]
        f0 = captured["fn"](cam, denoise_on=False)
        assert f0.shape == (24, 32, 4) and f0.dtype == np.uint8
        assert f0[..., :3].max() > 0  # lit by the emissive quad
        # second frame from a MOVED camera: temporal reuse reprojects the
        # frame-0 reservoirs; must stay finite and lit
        cam2 = Camera.look_at((5.8, 0.3, 1.1), (0.5, 0.5, 0.25),
                              (0.0, 0.0, 1.0))
        f1 = captured["fn"](cam2, denoise_on=False, animate=True)
        assert f1.shape == (24, 32, 4) and f1[..., :3].max() > 0
        # frames differ (new candidate streams + new view)
        assert not np.array_equal(f0, f1)


class TestAOVExport:
    """CLI --aov: the reference computes albedo/normal denoiser guides every
    frame (shader/Shader.cu:269-272) but never exposes them; here they are
    product output."""

    def test_film_save_aovs_roundtrip(self, tmp_path):
        import jax.numpy as jnp

        from optix_ray_tracer_tpu.render.film import Film
        from optix_ray_tracer_tpu.utils.color import color_to_uint8

        alb = jnp.broadcast_to(jnp.asarray([0.25, 0.5, 0.75]), (4, 6, 3))
        nrm = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (4, 6, 3))
        film = Film.create(6, 4).add(jnp.zeros((4, 6, 3)), alb, nrm, 2)
        paths = film.save_aovs(str(tmp_path / "f"))
        a = _read_png(paths[0])
        n = _read_png(paths[1])
        # albedo: sRGB-encoded mean (accumulated 2 samples, divided by spp)
        expect = np.asarray(color_to_uint8(alb))
        np.testing.assert_array_equal(a, expect)
        # normal: (n+1)/2 mapped, z=1 -> 255, x=y=0 -> 128
        assert n[0, 0, 2] == 255 and n[0, 0, 0] == 128 and n[0, 0, 1] == 128

    def test_cli_animation_aov(self, tmp_path):
        from optix_ray_tracer_tpu.__main__ import main

        data_dir = tmp_path / "data"
        data_dir.mkdir()
        for i in range(2):
            (data_dir / f"m{i}.vtk").write_text(MESH_VTK)
        (data_dir / "test.vtk.series").write_text(json.dumps(
            {"file-series-version": "1.0",
             "files": [{"name": "m0.vtk", "time": 0.0},
                       {"name": "m1.vtk", "time": 0.5}]}))
        cfg = {
            "mesh": True,
            "series-path": str(data_dir),
            "series-name": "test.vtk.series",
            "cache-path": str(tmp_path / "cache"),
            "stl-path": str(data_dir),
            "cache": False,
            "particle-material-preset": "viridis",
            "roughs": [{"albedo": [0.7, 0.6, 0.5]}],
            "metals": [],
            "spheres": [{"center": [0, 0, 0], "radius": 100.0,
                         "mat-type": "ROUGH", "mat-index": 0,
                         "shift": [0, 0, -100.5], "rotate": [0, 0, 0],
                         "scale": [1, 1, 1]}],
            "loop-data": {"api": "HEADLESS", "window-width": 32,
                          "window-height": 24, "fps": 4,
                          "camera-center": [6, 0, 1],
                          "camera-target": [0.5, 0.5, 0.25],
                          "up-direction": [0, 0, 1],
                          "render-speed-ratio": 1,
                          "particle-shift": [0, 0, 0],
                          "particle-scale": [1, 1, 1]},
        }
        cfgp = tmp_path / "config.json"
        cfgp.write_text(json.dumps(cfg))
        out = tmp_path / "out"
        rc = main(["--config", str(cfgp), "--frames", "1", "--spp", "1",
                   "--aov", "--output", str(out)])
        assert rc == 0
        beauty = _read_png(out / "frame_000000.png")
        alb = _read_png(out / "frame_000000_albedo.png")
        nrm = _read_png(out / "frame_000000_normal.png")
        assert beauty.shape[:2] == alb.shape[:2] == nrm.shape[:2] == (24, 32)
        # the guides are REAL (fused path fetched them), not the zero
        # channels of the quantized fast path
        assert len(np.unique(alb[..., :3])) > 2
        assert len(np.unique(nrm[..., :3])) > 2
        # miss pixels map to normal 0 -> 128; hit pixels differ
        assert np.any(nrm[..., 2] != nrm[0, 0, 2])
