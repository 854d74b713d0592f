"""End-to-end config-4/5 path-tracing throughput in spp/s.

Run on the GPU: ``python tools/e2e_bench.py [45|5h]``.  Each config is
compiled and warmed once, then timed with ``block_until_ready`` (best of
``reps``), with the production intersector (``choose_intersector``).
"""

from __future__ import annotations

import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")

from optix_ray_tracer_tpu.models import benchmarks
from optix_ray_tracer_tpu.models.common import choose_intersector
from optix_ray_tracer_tpu.render.pathtracer import render_path
from optix_ray_tracer_tpu.utils.jitcache import enable_compilation_cache

enable_compilation_cache()


def run_config(num, spp_batch=1, reps=3, **kw):
    cfg = benchmarks.ALL_CONFIGS[num]()
    for k, v in kw.items():
        cfg[k] = v
    inter = choose_intersector(cfg["scene"])
    w, h = cfg["width"], cfg["height"]

    def render(seed):
        img, _, _ = render_path(
            cfg["scene"], cfg["materials"], cfg.get("lights"),
            cfg["camera"], width=w, height=h, spp=spp_batch, seed=seed,
            background=cfg["background"], max_depth=cfg["max_depth"],
            intersector=inter, env=cfg.get("env"),
            textures=cfg.get("textures"))
        return img

    jrender = jax.jit(render)
    jrender(0).block_until_ready()       # compile + warm
    best = np.inf
    for r in range(reps):
        t0 = time.perf_counter()
        jrender(r + 1).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    spp_s = spp_batch / best
    print(f"config {num} ({cfg['name']}, {w}x{h}, depth "
          f"{cfg['max_depth']}): {best:.2f} s / {spp_batch} spp = "
          f"{spp_s:.3f} spp/s")
    return spp_s


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "45"
    if "4" in which:
        run_config(4)
    if "5" in which:
        run_config(5)
    if "5h" in which:
        run_config(5, width=960, height=544)
