"""Interactive operating point: stage-split the two
targets — reference animation <= 0.2 s/frame at 1200x800, viewer
>= 15 fps at 640x480 — so the binding cost is measured, not guessed.

Parts (select via argv, default all):
  anim    — reference animation steady-state s/frame + a split of
            per-file costs: scene build (host VTK->device), intersector
            rebuild, render dispatch, frame fetch.
  viewer  — fused chunk dispatch at 320x240 and 640x480: device render
            ms/frame vs uint8 fetch ms/frame vs host JPEG encode, the
            three serial stages of the viewer loop.

Timing: block_until_ready / host fetch around every measured quantity.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from optix_ray_tracer_tpu.utils.jitcache import enable_compilation_cache

enable_compilation_cache()

REF = "/root/reference/files"


def _ref_config():
    from optix_ray_tracer_tpu.io.config import parse_config_dict

    with open(f"{REF}/config.json") as f:
        raw = json.load(f)
    raw["series-path"] = REF
    raw["stl-path"] = f"{REF}/shape/separated/"
    return parse_config_dict(raw, base_dir=REF)


def bench_anim(max_frames: int = 120):
    """Steady-state s/frame of the fused reference animation (quantized
    uint8 fetch, the production fast path), with a per-frame timeline so
    file boundaries (rebuild + host VTK prep) and chunk fetches are
    visible against the <= 0.2 s/frame target."""
    from optix_ray_tracer_tpu.models import renderer_time

    cfg = _ref_config()
    data = renderer_time.commit(cfg)
    W, H = cfg.loop_data.window_width, cfg.loop_data.window_height
    print(f"animation {W}x{H}, files: {data.file_count}")

    stamps = []
    t0 = time.perf_counter()
    n = 0
    for fi, k, frame in renderer_time.render_frames(
            data, max_frames=max_frames, quantize=True):
        np.asarray(frame.rgba if hasattr(frame, "rgba") else frame.u8
                   if hasattr(frame, "u8") else frame.color)
        stamps.append((fi, k, time.perf_counter() - t0))
        n += 1
    spans = np.diff([0.0] + [s[2] for s in stamps])
    # drop the first chunk (compile) from the steady-state stats
    steady = spans[8:]
    print(f"frames: {n}, total {stamps[-1][2]:.1f} s")
    print(f"steady-state: median {np.median(steady):.3f} s/frame, "
          f"p90 {np.quantile(steady, 0.9):.3f}, mean {steady.mean():.3f}")
    # biggest spans = chunk/file boundaries
    order = np.argsort(spans)[::-1][:6]
    for i in order:
        fi, k, _ = stamps[i]
        print(f"  span {spans[i]:.2f} s at file {fi} frame {k}")


def bench_viewer():
    from optix_ray_tracer_tpu.models import benchmarks as B
    from optix_ray_tracer_tpu.models.common import choose_intersector
    from optix_ray_tracer_tpu.render import wavefront
    from optix_ray_tracer_tpu.render.viewer import _encode_frame
    from optix_ray_tracer_tpu.utils.color import color_to_uint8

    cfg = B.config3_mesh_diffuse(20_000)
    scene, mats, cam = cfg["scene"], cfg["materials"], cfg["camera"]
    inter = choose_intersector(scene)

    for (W, H) in ((320, 240), (640, 480)):
        @jax.jit
        def chunk4(seed):
            def one(s):
                img, alb, nrm = wavefront.render(
                    scene, mats, cam, W, H, spp=1, seed=s,
                    intersector=inter,
                    background=cfg.get("background", (0.7, 0.8, 0.9)))
                from optix_ray_tracer_tpu.render.denoise import denoise
                img = denoise(img, alb, nrm)
                u8 = color_to_uint8(img)
                return jnp.concatenate(
                    [u8, jnp.full(u8.shape[:2] + (1,), 255, jnp.uint8)],
                    axis=-1)
            # lax.map (a scan), like the production viewer's fused
            # chunk, which scans frames
            return jax.lax.map(one, seed + jnp.arange(4, dtype=jnp.uint32))

        out = chunk4(jnp.uint32(1))
        np.asarray(out)            # compile + warm
        # device render (chunk of 4), excluding fetch
        best_r = np.inf
        for r in range(5):
            t0 = time.perf_counter()
            out = chunk4(jnp.uint32(10 + r))
            out.block_until_ready()
            best_r = min(best_r, time.perf_counter() - t0)
        # fetch
        best_f = np.inf
        for r in range(5):
            out = chunk4(jnp.uint32(20 + r))
            out.block_until_ready()
            t0 = time.perf_counter()
            host = np.asarray(out)
            best_f = min(best_f, time.perf_counter() - t0)
        # encode
        t0 = time.perf_counter()
        for k in range(4):
            _encode_frame(host[k])
        t_e = (time.perf_counter() - t0) / 4
        per = best_r / 4 * 1e3
        fps = 1.0 / (best_r / 4 + best_f / 4 + t_e)
        print(f"viewer {W}x{H}: render {per:.1f} ms/frame + fetch "
              f"{best_f / 4 * 1e3:.1f} + encode {t_e * 1e3:.1f} "
              f"-> {fps:.1f} fps ceiling")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "anim viewer"
    if "anim" in which:
        bench_anim()
    if "viewer" in which:
        bench_viewer()
