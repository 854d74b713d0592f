"""Smoke test of the renderer's main path on one NVIDIA GPU.

Run from the root of a checkout:  ``python chip_smoke.py``  (one card), or
``python chip_smoke.py --four`` (only the four-card sharding phase).

Phases, in order; any failure exits non-zero:

1. device: a GPU must be present (no CPU carry-on); prints the card's name
   and power limit, the JAX version and the device count;
2. kernel at real width: compiles the traversal engine on the 100k-triangle
   bench scene (``compiled.memory_analysis()``), then checks it against the
   brute-force oracle on camera, shadow and incoherent waves at 100k and 1M
   triangles, as built, after a refit that moves the vertices, and after a
   rebuild;
3. kernel against plain XLA: Mrays/s per wave class for the kernel, the
   plain XLA traversal and brute force (``bench.py``), and the scene size
   below which brute force wins;
4. configs 3, 4, 5 through ``models.benchmarks.run`` at their published
   resolutions, and each against brute force at 256x144;
5. the CLI animation at the reference's operating point (Mesh mode,
   1200x800, 1 spp, depth 5, denoise on) on a deforming ~100k-triangle VTK
   series, in process;
6. only with ``--four``: the same animation with ``--shard`` over four
   cards, and ``render_sharded`` over a (tile=2, sample=2) mesh, each
   against the same render on one card.

The last line of standard output is one JSON object with ``ok`` and the
device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

#: sizes; a rehearsal on the CPU shrinks these
SIZES = dict(
    bench_tris=100_000, big_tris=1_000_000, width=1024, height=1024,
    check_rays=65_536, reps=10, threshold_tris=(16, 64, 256, 1024, 4096),
    compare_w=256, compare_h=144, config4_spp=4, anim_w=1200, anim_h=800,
    anim_tris=100_000, anim_frames=24)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import jax

    import bench

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    card = bench.card_info()
    log(f"[1] card: {card}")
    log(f"[1] jax {jax.__version__}, {len(jax.devices())} x "
        f"{dev.device_kind}")
    return card


def _moved(scene):
    """The scene with every vertex displaced by a smooth field (shared
    vertices move together, so a closed mesh stays closed)."""
    import jax.numpy as jnp

    from optix_ray_tracer_tpu.scene.geometry import Scene, Triangles

    v = scene.triangles.vertices
    v = v + 0.05 * jnp.sin(4.0 * v[..., jnp.array([1, 2, 0])])
    return Scene(spheres=scene.spheres,
                 triangles=Triangles(v, scene.triangles.normals,
                                     scene.triangles.material_id))


def phase_kernel(card):
    import jax
    import jax.numpy as jnp

    import bench
    from optix_ray_tracer_tpu.ops import gpu_traverse
    from optix_ray_tracer_tpu.ops.bvh import lbvh_depth
    from optix_ray_tracer_tpu.ops.traverse import STACK_DEPTH

    s = SIZES
    scene = bench.bench_scene(s["bench_tris"])
    engine = gpu_traverse.build(scene)
    o, d = jnp.zeros((s["width"] * s["height"], 3)), jnp.ones(
        (s["width"] * s["height"], 3))
    tm = jnp.full((o.shape[0],), 1e16, jnp.float32)
    t0 = time.perf_counter()
    compiled = jax.jit(bench._intersect).lower(engine, scene, o, d,
                                               tm).compile()
    log(f"[2] kernel compiled for {o.shape[0]} rays x "
        f"{scene.triangle_count} triangles in "
        f"{time.perf_counter() - t0:.3f} s")
    log(f"[2] memory_analysis: {compiled.memory_analysis()}")

    failures = []
    for n_tris in (s["bench_tris"], s["big_tris"]):
        scene = bench.bench_scene(n_tris)
        engine = gpu_traverse.build(scene)
        depth = lbvh_depth(engine.bvh)
        log(f"[2] {scene.triangle_count} triangles: LBVH depth {depth} "
            f"(stack holds {STACK_DEPTH})")
        if depth > STACK_DEPTH:
            failures.append(f"LBVH depth {depth} > stack {STACK_DEPTH}")
        waves = bench.make_waves(scene, engine, s["width"], s["height"])
        stride = max(1, waves["camera"][0].shape[0] // s["check_rays"])
        waves = {k: (w[0][::stride], w[1][::stride], w[2][::stride], w[3])
                 for k, w in waves.items()}
        moved = _moved(scene)
        for label, eng, scn in (
                ("built", engine, scene),
                ("refit", gpu_traverse.refit(engine, moved), moved),
                ("rebuilt", gpu_traverse.rebuild(engine, moved), moved)):
            bad = bench.check_waves(scn, eng, waves, s["check_rays"])
            log(f"[2] {scene.triangle_count} tris {label}: mismatches vs "
                f"oracle per wave ({waves['camera'][0].shape[0]} rays "
                f"each): {bad} [{card}]")
            if any(bad.values()):
                failures.append(f"{n_tris} {label} {bad}")
    if failures:
        raise SystemExit(f"[2] exactness failed: {failures}")


def phase_engines(card):
    import bench

    s = SIZES
    res = bench.run(["kernel", "xla", "brute"], reps=s["reps"],
                    check_rays=0, n_tris=s["bench_tris"], width=s["width"],
                    height=s["height"], out=sys.stdout)
    for eng, waves in res.items():
        log(f"[3] {eng}: " + ", ".join(
            f"{w} {r['mrays_s']:.6g} Mrays/s" for w, r in waves.items())
            + f" [{card}]")
    # where does a BVH start to pay? camera wave, kernel vs brute force
    for n_tris in s["threshold_tris"]:
        scene = bench.bench_scene(n_tris)
        table = bench.engines(scene, ["kernel", "brute"])
        wave = bench.make_waves(scene, table["kernel"], s["width"],
                                s["height"])["camera"]
        k = bench.time_wave(table["kernel"], scene, wave, 3)
        b = bench.time_wave(table["brute"], scene, wave, 3)
        log(f"[3] threshold {scene.triangle_count} tris camera wave: "
            f"kernel {k['mrays_s']:.6g} Mrays/s, brute {b['mrays_s']:.6g} "
            f"Mrays/s [{card}]")


def phase_config5_engines(card):
    """Config 5 end to end (published resolution, 1 spp) with the kernel and
    with the plain XLA traversal."""
    from optix_ray_tracer_tpu.models import benchmarks
    from optix_ray_tracer_tpu.ops import gpu_traverse

    cfg = benchmarks.config5_sponza_class()
    w, h = cfg["width"], cfg["height"]
    engine = gpu_traverse.build(cfg["scene"])
    engines = {"kernel": engine, "xla": gpu_traverse.xla_twin(engine)}
    for name, inter in engines.items():
        benchmarks.run(cfg, spp=1, width=w, height=h, intersector=inter)
        _, st = benchmarks.run(cfg, spp=1, width=w, height=h, seed=1,
                               intersector=inter)
        log(f"[3] config 5 {w}x{h} 1 spp (cut from {cfg['spp']}) with "
            f"{name}: render_s {st['render_s']:.6g}, "
            f"{st['spp_per_sec']:.6g} spp/s [{card}]")


def phase_configs(card):
    from optix_ray_tracer_tpu.models import benchmarks
    from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector

    s = SIZES
    failures = []
    for num in (3, 4, 5):
        cfg = benchmarks.ALL_CONFIGS[num]()
        w, h = cfg["width"], cfg["height"]
        spp = cfg["spp"]
        if num == 4:
            spp = s["config4_spp"]
            log(f"[4] config 4: spp cut from {cfg['spp']} to {spp}")
        _, first = benchmarks.run(cfg, spp=spp, width=w, height=h)
        (img, _, _), st = benchmarks.run(cfg, spp=spp, width=w, height=h,
                                         seed=1)
        a = np.asarray(img)
        ok = a.shape == (h, w, 3) and np.isfinite(a).all() and a.max() > 0
        log(f"[4] config {num} {cfg['name']} {w}x{h} {spp} spp, "
            f"{st['triangles']} tris: render_s {st['render_s']:.6g} "
            f"(first call with compile {first['render_s']:.6g}), "
            f"{st['spp_per_sec']:.6g} spp/s, image ok {ok} [{card}]")
        if not ok:
            failures.append(f"config {num} image")
        cw, ch = s["compare_w"], s["compare_h"]
        (ia, _, _), _ = benchmarks.run(cfg, spp=1, width=cw, height=ch,
                                       seed=7)
        (ib, _, _), _ = benchmarks.run(cfg, spp=1, width=cw, height=ch,
                                       seed=7,
                                       intersector=BruteForceIntersector())
        ia, ib = np.asarray(ia), np.asarray(ib)
        nan = int(np.isnan(ia).sum() + np.isnan(ib).sum())
        differ = int(np.sum(np.any(np.abs(ia - ib) > 1e-4, axis=-1)))
        log(f"[4] config {num} engine vs brute force at {cw}x{ch} 1 spp: "
            f"{differ} of {cw * ch} pixels differ by > 1e-4, {nan} NaN")
        if nan or differ > 0.001 * cw * ch:
            failures.append(f"config {num} vs brute force: {differ} px, "
                            f"{nan} NaN")
    if failures:
        raise SystemExit(f"[4] failed: {failures}")


def write_mesh_series(path: str, n_tris: int, n_files: int = 3) -> None:
    """A deforming UV sphere as a Mesh-mode VTK series: one triangle strip
    (one particle) per latitude band, ~``n_tris`` triangles per file."""
    from optix_ray_tracer_tpu.io.vtk import PolyData, write_polydata

    n_lat = max(2, int(np.sqrt(n_tris / 4)))
    n_lon = max(3, n_tris // (2 * n_lat))
    theta, phi = np.meshgrid(np.linspace(0, np.pi, n_lat + 1),
                             np.linspace(0, 2 * np.pi, n_lon + 1),
                             indexing="ij")
    row = np.arange(n_lon + 1)
    strips = [np.stack([i * (n_lon + 1) + row, (i + 1) * (n_lon + 1) + row],
                       1).reshape(-1) for i in range(n_lat)]
    rng = np.random.default_rng(0)
    vel = rng.normal(0.0, 0.05, (n_lat, 3))
    entries = []
    for f in range(n_files):
        r = 1.0 + 0.08 * np.sin(3 * theta + f) * np.cos(2 * phi)
        pts = np.stack([r * np.sin(theta) * np.cos(phi),
                        r * np.sin(theta) * np.sin(phi),
                        r * np.cos(theta)], -1).reshape(-1, 3)
        name = f"sphere_{f}.vtk"
        write_polydata(os.path.join(path, name), PolyData(
            points=pts, vertices=[], lines=[], polygons=[],
            triangle_strips=strips, point_data={},
            cell_data={"id": np.arange(n_lat, dtype=np.int32),
                       "vel": vel}))
        entries.append({"name": name, "time": 0.5 * f})
    with open(os.path.join(path, "sphere.vtk.series"), "w") as fh:
        json.dump({"file-series-version": "1.0", "files": entries}, fh)


def _animation_config(tmp: str, data_dir: str) -> str:
    s = SIZES
    cfg = {
        "mesh": True, "series-path": data_dir,
        "series-name": "sphere.vtk.series",
        "cache-path": os.path.join(tmp, "cache"), "stl-path": data_dir,
        "cache": False, "particle-material-preset": "viridis",
        "roughs": [{"albedo": [0.7, 0.6, 0.5]}], "metals": [],
        "spheres": [{"center": [0, 0, 0], "radius": 100.0,
                     "mat-type": "ROUGH", "mat-index": 0,
                     "shift": [0, 0, -101.5], "rotate": [0, 0, 0],
                     "scale": [1, 1, 1]}],
        "spp": 1, "max-depth": 5, "denoise": True,
        "loop-data": {"api": "HEADLESS", "window-width": s["anim_w"],
                      "window-height": s["anim_h"], "fps": 16,
                      "camera-center": [4.0, 0.5, 1.5],
                      "camera-target": [0.0, 0.0, 0.0],
                      "up-direction": [0, 0, 1], "render-speed-ratio": 1,
                      "particle-shift": [0, 0, 0],
                      "particle-scale": [1, 1, 1]},
    }
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def _run_cli(cfg_path: str, out: str, extra=()) -> list:
    """The CLI in process; returns the decoded frames in order."""
    from optix_ray_tracer_tpu.__main__ import main as cli_main
    from optix_ray_tracer_tpu.utils.color import read_png

    n = SIZES["anim_frames"]
    t0 = time.perf_counter()
    rc = cli_main(["--config", cfg_path, "--frames", str(n), "--output", out,
                   *extra])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"CLI exited {rc}")
    names = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    if len(names) != n:
        raise SystemExit(f"CLI wrote {len(names)} frames, expected {n}")
    frames = []
    for f in names:
        with open(os.path.join(out, f), "rb") as fh:
            frames.append(read_png(fh.read()))
    stamps = [os.stat(os.path.join(out, f)).st_mtime for f in names]
    return frames, stamps, wall


def phase_animation(card):
    s = SIZES
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        write_mesh_series(data_dir, s["anim_tris"])
        cfg_path = _animation_config(tmp, data_dir)
        frames, stamps, wall = _run_cli(cfg_path, os.path.join(tmp, "out"))
    flat = [f for f in frames if len(np.unique(f[..., :3])) < 16]
    if flat:
        raise SystemExit(f"[5] {len(flat)} near-constant frames")
    # frames leave in chunks; the first chunk carries the compile, so the
    # steady state is the span from the end of the first chunk to the end
    gaps = np.diff(stamps)
    first = int(np.argmax(gaps > 0)) if (gaps > 0).any() else 0
    k = max(first, len(stamps) // 3 - 1)
    steady = (stamps[-1] - stamps[k]) / max(len(stamps) - 1 - k, 1)
    log(f"[5] CLI Mesh animation {s['anim_w']}x{s['anim_h']}, 1 spp, depth "
        f"5, denoise on, {s['anim_tris']} triangles x 3 files: "
        f"{len(frames)} frames in {wall:.6g} s wall (commit + compile "
        f"included); steady state {steady:.6g} s/frame over frames "
        f"{k + 1}..{len(stamps) - 1} [{card}]")


def phase_four(card):
    """Four cards: the CLI animation with --shard and render_sharded over a
    (tile=2, sample=2) mesh, each against the same render on one card."""
    import jax

    from optix_ray_tracer_tpu.models.common import choose_intersector
    from optix_ray_tracer_tpu.parallel.sharding import (
        make_mesh, render_sharded,
    )
    from optix_ray_tracer_tpu.render import wavefront
    from optix_ray_tracer_tpu.utils.color import color_to_uint8

    n = len(jax.devices())
    if n < 4:
        raise SystemExit(f"--four needs 4 devices, JAX found {n}")
    s = SIZES
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        write_mesh_series(data_dir, s["anim_tris"])
        cfg_path = _animation_config(tmp, data_dir)
        one, _, wall1 = _run_cli(cfg_path, os.path.join(tmp, "one"))
        four, _, wall4 = _run_cli(cfg_path, os.path.join(tmp, "four"),
                                  ["--shard"])
    same = sum(np.array_equal(a, b) for a, b in zip(one, four))
    worst = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                for a, b in zip(one, four))
    log(f"[6] CLI animation one card ({wall1:.6g} s) vs --shard over {n} "
        f"cards ({wall4:.6g} s): {same}/{len(one)} uint8 frames identical, "
        f"max |diff| {worst} [{card}]")

    from optix_ray_tracer_tpu.models import benchmarks
    cfg = benchmarks.config3_mesh_diffuse()
    w, h = cfg["width"], cfg["height"]
    inter = choose_intersector(cfg["scene"])
    ref, _, _ = wavefront.render(cfg["scene"], cfg["materials"],
                                 cfg["camera"], w, h, spp=4, seed=3,
                                 background=cfg["background"],
                                 max_depth=cfg["max_depth"],
                                 intersector=inter)
    mesh = make_mesh(tile=2, sample=2)
    img = render_sharded(cfg["scene"], cfg["materials"], cfg["camera"], w, h,
                         4, mesh, seed=3, background=cfg["background"],
                         max_depth=cfg["max_depth"], intersector=inter)
    ref, img = np.asarray(ref), np.asarray(img)
    diff = float(np.abs(ref - img).max())
    u8_same = bool(np.array_equal(np.asarray(color_to_uint8(ref)),
                                  np.asarray(color_to_uint8(img))))
    log(f"[6] render_sharded (tile=2, sample=2) config 3 {w}x{h} 4 spp vs "
        f"one card: max |diff| {diff:.3g}, uint8 identical {u8_same}")
    if same != len(one) or diff > 1e-5:
        raise SystemExit("[6] sharded renders differ from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="only the four-card sharding phase")
    args = ap.parse_args(argv)

    import jax

    from optix_ray_tracer_tpu.utils.jitcache import enable_compilation_cache
    enable_compilation_cache()

    card = phase_device()
    if args.four:
        phases = [(6, phase_four)]
    else:
        phases = [(2, phase_kernel), (3, phase_engines),
                  (3, phase_config5_engines), (4, phase_configs),
                  (5, phase_animation)]
    for num, fn in phases:
        t0 = time.perf_counter()
        fn(card)
        log(f"[{num}] {fn.__name__} done in "
            f"{time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
