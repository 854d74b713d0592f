"""Intersection benchmark: ray throughput per wave class and engine.

Scene: the 100k-triangle sphere (``io/meshgen.py``) seen from (3, 0, 0) at
1024x1024.  Three waves of 1M rays each:

* ``camera``: pinhole camera rays in scanline order;
* ``shadow``: any-hit rays from the camera hits to a point light;
* ``incoherent``: uniformly random origins in [-0.9, 0.9]^3 and uniformly
  random directions.

Engines: ``kernel`` (the per-ray traversal kernel, ``ops/gpu_traverse.py``),
``xla`` (the engine's own plain XLA walk, the path it takes off the GPU,
``gpu_traverse.xla_twin``) and ``brute`` (the
brute-force oracle).  Each (engine, wave) is compiled once (compile seconds
reported apart), then timed with ``block_until_ready`` over ``--reps``
dispatches.  Before timing, 64k rays of every wave are checked against the
oracle.

Run on the GPU: ``python bench.py [--engines kernel,xla,brute]``.  Prints
one line per (engine, wave), then one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

WIDTH = HEIGHT = 1024
N_TRIS = 100_000
LIGHT = (3.0, 3.0, 3.0)
CHECK_RAYS = 65_536


def card_info() -> str:
    """``name, power limit`` of the first card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def bench_scene(n_tris: int = N_TRIS):
    from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu.scene.geometry import Scene, Spheres, Triangles

    v, n = sphere_with_n_triangles(n_tris)
    return Scene(spheres=Spheres.empty(),
                 triangles=Triangles.from_arrays(v, n))


def make_waves(scene, engine, width: int = WIDTH, height: int = HEIGHT,
               seed: int = 11) -> dict:
    """The three waves as ``name -> (o, d, t_max, any_hit)``; the shadow
    wave starts at the camera wave's hits (found with ``engine``)."""
    import jax.numpy as jnp

    from optix_ray_tracer_tpu.scene.camera import Camera

    cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = cam.generate_rays(width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    r = o.shape[0]
    inf = jnp.full((r,), 1e16, jnp.float32)
    hit = engine.intersect(scene, o, d)
    point = jnp.where(hit.is_hit[:, None], o + hit.t[:, None] * d, o)
    to_light = jnp.asarray(LIGHT, jnp.float32) - point
    dist = jnp.linalg.norm(to_light, axis=-1)
    wl = to_light / jnp.maximum(dist, 1e-6)[:, None]
    rng = np.random.default_rng(seed)
    oi = rng.uniform(-0.9, 0.9, (r, 3)).astype(np.float32)
    di = rng.normal(size=(r, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    return {
        "camera": (o, d, inf, False),
        "shadow": (point + wl * 1e-3, wl, dist, True),
        "incoherent": (jnp.asarray(oi), jnp.asarray(di), inf, False),
    }


def engines(scene, names) -> dict:
    """``name -> intersector`` for the requested engine names."""
    from optix_ray_tracer_tpu.ops import gpu_traverse
    from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector

    table = {"kernel": lambda: gpu_traverse.build(scene),
             "xla": lambda: gpu_traverse.xla_twin(gpu_traverse.build(scene)),
             "brute": BruteForceIntersector}
    return {n: table[n]() for n in names}


def _intersect(engine, scene, o, d, t_max):
    return engine.intersect(scene, o, d, t_max=t_max)


def _any_hit(engine, scene, o, d, t_max):
    return engine.any_hit(scene, o, d, t_max=t_max)


def query_fn(engine, any_hit: bool):
    """(scene, o, d, t_max) -> the wave's result; the engine is a jit
    argument, so its arrays are not baked into the program."""
    import jax

    fn = jax.jit(_any_hit if any_hit else _intersect)
    return lambda *args: fn(engine, *args)


def mismatches(hit, ref) -> int:
    """Rays whose nearest hit disagrees with the oracle: prim id and type
    must be equal, except on fp ties, where the distances agree to
    1e-5 relative + 1e-6."""
    t = np.asarray(hit.t)
    t_ref = np.asarray(ref.t)
    same = (np.asarray(hit.prim_id) == np.asarray(ref.prim_id)) \
        & (np.asarray(hit.prim_type) == np.asarray(ref.prim_type))
    tie = np.abs(t - t_ref) <= 1e-5 * np.abs(t_ref) + 1e-6
    return int(np.sum(~(same | tie)))


def check_waves(scene, engine, waves, n: int = CHECK_RAYS) -> dict:
    """``wave -> mismatches`` against the brute-force oracle on the first
    ``n`` rays of each wave (any-hit waves must match exactly)."""
    from optix_ray_tracer_tpu.ops.traverse import BruteForceIntersector

    oracle = BruteForceIntersector()
    out = {}
    for name, (o, d, tm, any_hit) in waves.items():
        o, d, tm = o[:n], d[:n], tm[:n]
        if any_hit:
            got = np.asarray(query_fn(engine, True)(scene, o, d, tm))
            ref = np.asarray(query_fn(oracle, True)(scene, o, d, tm))
            out[name] = int(np.sum(got != ref))
        else:
            out[name] = mismatches(query_fn(engine, False)(scene, o, d, tm),
                                   query_fn(oracle, False)(scene, o, d, tm))
    return out


def time_wave(engine, scene, wave, reps: int) -> dict:
    """Compile seconds, then best and median seconds per dispatch."""
    import jax

    o, d, tm, any_hit = wave
    fn = query_fn(engine, any_hit)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(scene, o, d, tm))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(scene, o, d, tm))
        times.append(time.perf_counter() - t0)
    rays = o.shape[0]
    return dict(compile_s=compile_s, best_s=min(times),
                median_s=statistics.median(times),
                mrays_s=rays / min(times) / 1e6)


def run(names, reps: int, check_rays: int = CHECK_RAYS, n_tris=N_TRIS,
        width: int = WIDTH, height: int = HEIGHT, out=sys.stdout) -> dict:
    """Time every (engine, wave); returns ``engine -> wave -> timing``.
    ``check_rays`` = 0 skips the exactness check."""
    import jax

    card = card_info()
    scene = bench_scene(n_tris)
    table = engines(scene, names)
    waves = make_waves(scene, table.get("kernel") or next(iter(
        table.values())), width, height)
    if check_rays:
        for name in names:
            if name == "brute":
                continue
            bad = check_waves(scene, table[name], waves, check_rays)
            print(f"exactness {name} vs oracle, {check_rays} rays per wave: "
                  f"{bad}", file=out)
            if any(bad.values()):
                raise SystemExit(f"exactness check failed for {name}: {bad}")
    results = {}
    for name in names:
        results[name] = {}
        for wave_name, wave in waves.items():
            # brute force is quadratic; one timed dispatch is enough
            r = time_wave(table[name], scene, wave,
                          1 if name == "brute" else reps)
            results[name][wave_name] = r
            print(f"{name:7s} {wave_name:10s} {r['mrays_s']:.6g} Mrays/s "
                  f"(best {r['best_s']:.6g} s, median {r['median_s']:.6g} s,"
                  f" compile {r['compile_s']:.4g} s) "
                  f"[{card}; {jax.devices()[0].device_kind}]", file=out)
    return results


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--engines", default="kernel",
                        help="comma list of kernel,xla,brute")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import jax

    from optix_ray_tracer_tpu.utils.jitcache import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev.platform}")
    names = args.engines.split(",")
    results = run(names, args.reps)
    print(json.dumps({
        "card": card_info(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "mrays_s": {e: {w: r["mrays_s"] for w, r in res.items()}
                    for e, res in results.items()},
    }))


if __name__ == "__main__":
    main()
