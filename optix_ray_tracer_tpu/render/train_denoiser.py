"""Train the learned denoiser (render/neural_denoise.py) on self-rendered
noisy/clean pairs.

The reference ships a pretrained AI denoiser (RendererImpl.cu:584-669);
we train ours in-repo, on this renderer's own output — no external data.
Scenes: the five BASELINE benchmark configs (models/benchmarks.py) plus
the shipped reference particle series when mounted.  For each scene and
several orbit cameras we render a 1-spp frame (noisy, with albedo/normal
guides) and a high-spp frame (clean target), then fit the
kernel-predicting CNN on random 64x64 crops.

Usage:
    python -m optix_ray_tracer_tpu.render.train_denoiser \
        [--steps 3000] [--out render/denoiser_data/weights.npz]

Runs on whatever backend jax picks (an accelerator preferred: rendering
the training set is the expensive part).  The held-out scene (config3 mesh)
is never trained on; the script reports raw / a-trous / neural PSNR on
it at the end.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _orbit(camera, angle: float, lift: float = 0.0):
    """New Camera orbited about the target by ``angle`` radians.

    |target - center| is preserved up to the small ``lift`` term, so the
    FOV (set by |W| in the UVW model) stays essentially unchanged."""
    from optix_ray_tracer_tpu.scene.camera import Camera

    c = np.asarray(camera.center, np.float64)
    t = np.asarray(camera.target, np.float64)
    off = c - t
    ca, sa = np.cos(angle), np.sin(angle)
    off = np.asarray([off[0] * ca - off[1] * sa,
                      off[0] * sa + off[1] * ca,
                      off[2] + lift * np.linalg.norm(off)])
    return Camera.look_at(tuple(t + off), tuple(t), (0.0, 0.0, 1.0))


def _render_pair(cfg, camera, size, seed, clean_spp):
    """(noisy 1spp, albedo, normal, clean) for one view, linear HWC."""
    import jax.numpy as jnp

    from optix_ray_tracer_tpu.models import common as mcommon
    from optix_ray_tracer_tpu.render import pathtracer, wavefront

    scene, mats = cfg["scene"], cfg["materials"]
    inter = mcommon.choose_intersector(scene)
    W = H = size
    kw = dict(width=W, height=H, intersector=inter,
              background=cfg.get("background", (0.7, 0.8, 0.9)),
              max_depth=cfg.get("max_depth", 5),
              env=cfg.get("env"), )
    if cfg.get("integrator") == "path":
        def rend(spp, sd):
            return pathtracer.render_path(
                scene, mats, cfg.get("lights"), camera, spp=spp, seed=sd,
                textures=cfg.get("textures"), clamp=8.0, **kw)
    else:
        def rend(spp, sd):
            return wavefront.render(scene, mats, camera, spp=spp, seed=sd,
                                    **kw)
    noisy, alb, nrm = rend(1, seed)
    # clean target in <=64-spp host-side chunks: one multi-minute scan
    # dispatch trips the device watchdog on heavy scenes (config5 at
    # 512 spp crashed the worker); equal-size chunk averaging with
    # disjoint counter-RNG seeds is statistically identical
    chunk = min(clean_spp, 64)
    n_chunks = max(-(-clean_spp // chunk), 1)   # ceil: never drop samples
    acc = None
    for c in range(n_chunks):
        img, _, _ = rend(chunk, seed + 7919 + c * 65_537)
        img = np.asarray(img, np.float64)
        acc = img if acc is None else acc + img
    clean = (acc / n_chunks).astype(np.float32)
    return tuple(np.asarray(x) for x in (noisy, alb, nrm, clean))


#: held-out scene order (build_dataset and main's per-scene table)
HELDOUT_NAMES = ("config3", "proc_h0", "proc_h1")


def _procedural_cfg(seed: int) -> dict:
    """One randomized training scene — the corpus diversifier (VERDICT
    r3 #5: the round-3 net, trained on 4 benchmark configs, lost to
    a-trous on held-out smooth-diffuse geometry).  Varies:

    * geometry: 1-3 tessellated blobs (3k-40k tris, smooth OR faceted
      normals — the smooth-diffuse regime is the one round 3 missed)
      plus 0-3 analytic spheres over a ground plane/sphere;
    * materials: random-albedo rough, tinted metals at random fuzz,
      dielectric, occasional emissive quad (area light);
    * lighting: flat background / gradient sky / sun-sky env map;
    * integrator: whitted or path (with NEE when emitters exist).
    """
    from optix_ray_tracer_tpu.io.meshgen import (
        quad, sphere_with_n_triangles,
    )
    from optix_ray_tracer_tpu.render.envmap import gradient_sky
    from optix_ray_tracer_tpu.scene.camera import Camera
    from optix_ray_tracer_tpu.scene.geometry import (
        Scene, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu.scene.materials import MaterialBuilder

    rng = np.random.default_rng(seed)
    mb = MaterialBuilder()

    def rand_mat():
        r = rng.random()
        if r < 0.55:
            return mb.add_rough(tuple(rng.uniform(0.15, 0.85, 3)))
        if r < 0.85:
            return mb.add_metal(tuple(rng.uniform(0.6, 0.95, 3)),
                                fuzz=float(rng.uniform(0.0, 0.35)))
        return mb.add_dielectric(float(rng.uniform(1.3, 1.8)))

    ground = mb.add_rough(tuple(rng.uniform(0.3, 0.8, 3)))
    spheres = [((0.0, 0.0, -1000.5), 1000.0, ground)]
    vs, ns, ms = [], [], []

    for _ in range(rng.integers(1, 4)):          # tessellated blobs
        c = (float(rng.uniform(-1.5, 1.5)), float(rng.uniform(-1.5, 1.5)),
             float(rng.uniform(-0.2, 0.8)))
        rad = float(rng.uniform(0.3, 0.8))
        v, n = sphere_with_n_triangles(int(rng.integers(3_000, 40_000)),
                                       c, rad)
        m = rand_mat()
        vs.append(v)
        # half the blobs keep smooth sphere normals, half go faceted
        # (face normals) — both shading regimes in the corpus
        ns.append(n if rng.random() < 0.5 else None)
        ms.append(np.full(len(v), m, np.int32))
    for _ in range(rng.integers(0, 4)):          # analytic spheres
        spheres.append(((float(rng.uniform(-2, 2)),
                         float(rng.uniform(-2, 2)),
                         float(rng.uniform(-0.1, 1.0))),
                        float(rng.uniform(0.2, 0.6)), rand_mat()))

    integrator = "path" if rng.random() < 0.5 else "whitted"
    if integrator == "path" and rng.random() < 0.6:
        # emissive panel overhead (area light for the NEE path)
        e = mb.add_emissive(tuple(rng.uniform(4.0, 16.0, 3)))
        cx, cy = rng.uniform(-1, 1, 2)
        s = float(rng.uniform(0.4, 1.2))
        v, n = quad([cx - s, cy - s, 2.5], [cx + s, cy - s, 2.5],
                    [cx + s, cy + s, 2.5], [cx - s, cy + s, 2.5])
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), e, np.int32))

    from optix_ray_tracer_tpu.scene.geometry import (
        face_normals_as_vertex_normals,
    )
    import jax.numpy as jnp
    nrm = [np.asarray(face_normals_as_vertex_normals(
               jnp.asarray(v, jnp.float32))) if n is None else n
           for v, n in zip(vs, ns)]
    tris = Triangles.from_arrays(
        np.concatenate(vs), np.concatenate(nrm), np.concatenate(ms))
    scene = Scene(spheres=Spheres.from_list(spheres), triangles=tris)
    materials = mb.build()

    env = None
    bg = tuple(rng.uniform(0.0, 1.0, 3))
    r = rng.random()
    if r < 0.4:
        sun = None
        if rng.random() < 0.6:
            sd = rng.normal(size=3)
            sd[2] = abs(sd[2]) + 0.5
            sun = tuple(sd / np.linalg.norm(sd))
        env = gradient_sky(
            zenith=tuple(rng.uniform(0.2, 0.7, 3)),
            horizon=tuple(rng.uniform(0.6, 1.0, 3)),
            sun_dir=sun)
        bg = (0.0, 0.0, 0.0)

    az = rng.uniform(0, 2 * np.pi)
    dist = rng.uniform(3.5, 6.0)
    cam = Camera.look_at(
        (dist * np.cos(az), dist * np.sin(az),
         float(rng.uniform(0.3, 1.5))), (0.0, 0.0, 0.2), (0.0, 0.0, 1.0))
    lights = (collect_area_lights(scene, materials)
              if integrator == "path" else None)
    return dict(scene=scene, materials=materials, camera=cam,
                lights=lights, integrator=integrator, background=bg,
                max_depth=5, env=env)


def build_dataset(size: int = 192, views: int = 4, clean_spp: int = 256,
                  include_reference: bool = True, verbose: bool = True,
                  procedural: int = 10):
    """Render (noisy, albedo, normal, clean) image tuples.

    Returns (train_imgs, heldout_imgs).  Held out entirely: config3
    (the 20k-tri smooth-diffuse mesh) AND two procedural scenes from a
    disjoint seed range — generalization is scored on scenes the net
    never saw (VERDICT r3 #5).
    """
    from optix_ray_tracer_tpu.models import benchmarks as B

    scenes = [("config1", B.config1_sphere_ground()),
              ("config2", B.config2_whitted_spheres()),
              ("config4", B.config4_cornell()),
              ("config5", B.config5_sponza_class(n_cols=4))]
    for k in range(procedural):
        scenes.append((f"proc{k}", _procedural_cfg(1000 + k)))
    heldout_scenes = [(n, c) for n, c in zip(
        HELDOUT_NAMES, (B.config3_mesh_diffuse(20_000),
                        _procedural_cfg(9000), _procedural_cfg(9001)))]

    REF = "/root/reference/files"
    if include_reference and os.path.isdir(REF):
        import json

        from optix_ray_tracer_tpu.io.config import parse_config_dict
        from optix_ray_tracer_tpu.models import common as mcommon
        from optix_ray_tracer_tpu.models import renderer_time

        with open(f"{REF}/config.json") as f:
            raw = json.load(f)
        raw["series-name"] = "particle-short.vtk.series"
        raw["series-path"] = REF
        raw["stl-path"] = f"{REF}/shape/separated/"
        rcfg = parse_config_dict(raw, base_dir=REF)
        data = renderer_time.commit(rcfg)
        n_frames = mcommon.frame_count_for_file(
            data.durations[0], rcfg.loop_data.fps,
            rcfg.loop_data.render_speed_ratio)
        scene = renderer_time.frame_scene(data, 0, 0, max(n_frames, 1))
        scenes.append(("reference", dict(
            scene=scene, materials=data.materials, camera=data.camera,
            integrator="whitted", background=rcfg.background,
            max_depth=rcfg.max_depth, env=data.env)))

    def render_set(slist):
        out = []
        for name, cfg in slist:
            cam0 = cfg["camera"]
            for v in range(views):
                cam = cam0 if v == 0 else _orbit(
                    cam0, angle=0.45 * v, lift=0.08 * (v - views / 2))
                cspp = clean_spp if cfg.get("integrator") != "path" \
                    else max(clean_spp, 256)
                t0 = time.time()
                pair = _render_pair(cfg, cam, size, seed=101 * v + 13,
                                    clean_spp=cspp)
                if verbose:
                    print(f"  {name} view {v}: {time.time()-t0:.1f}s")
                out.append(pair)
        return out

    return render_set(scenes), render_set(heldout_scenes)


def _crops(imgs, n_per_img: int, crop: int, rng):
    """Random augmented crops -> stacked arrays (N, crop, crop, 3) x4."""
    outs = [[], [], [], []]
    for noisy, alb, nrm, clean in imgs:
        H, W = noisy.shape[:2]
        for _ in range(n_per_img):
            y = rng.integers(0, H - crop + 1)
            x = rng.integers(0, W - crop + 1)
            k = rng.integers(0, 4)
            fl = rng.integers(0, 2)
            for o, im in zip(outs, (noisy, alb, nrm, clean)):
                c = im[y:y + crop, x:x + crop]
                c = np.rot90(c, k)
                if fl:
                    c = c[:, ::-1]
                o.append(np.ascontiguousarray(c))
    return [np.stack(o) for o in outs]


def train(train_imgs, steps: int = 3000, batch: int = 16, crop: int = 64,
          lr: float = 2e-3, seed: int = 0, verbose: bool = True):
    import jax
    import jax.numpy as jnp
    import optax

    from optix_ray_tracer_tpu.render import neural_denoise as nd

    rng = np.random.default_rng(seed)
    noisy, alb, nrm, clean = _crops(train_imgs, n_per_img=24, crop=crop,
                                    rng=rng)
    n = len(noisy)
    if verbose:
        print(f"dataset: {n} crops of {crop}x{crop}")

    params = jax.tree.map(jnp.asarray, nd.init_params(seed))
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.02)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    def loss_fn(p, no, al, nr, cl):
        safe = nd.demod_albedo(al)
        out = nd.apply(p, no / safe, al, nr) * safe
        # L1 on Reinhard-tonemapped radiance: bounded, so the HDR
        # outliers of clamped path-traced crops cannot dominate the
        # gradient (raw L1 measured to stall training at near-identity)
        tone = lambda x: x / (1.0 + jnp.abs(x))
        return jnp.abs(tone(out) - tone(cl)).mean()

    # the whole crop set lives on device (~100-300 MB); per-step batches
    # are gathered there — only the (batch,) index vector crosses the
    # host link each step.  The crop arrays MUST be jit ARGUMENTS, not
    # closure captures: captured device arrays lower as HLO constants,
    # and at corpus scale (15 scenes, 1440 crops) the embedded constants
    # bloat every compile.
    dev = jax.devices()[0]
    dno, dal, dnr, dcl = (jax.device_put(a, dev)
                          for a in (noisy, alb, nrm, clean))

    @jax.jit
    def step(p, s, idx, no_all, al_all, nr_all, cl_all):
        args = [jnp.take(a, idx, axis=0)
                for a in (no_all, al_all, nr_all, cl_all)]
        l, g = jax.value_and_grad(loss_fn)(p, *args)
        up, s = opt.update(g, s)
        return optax.apply_updates(p, up), s, l

    t0 = time.time()
    for i in range(steps):
        idx = rng.integers(0, n, batch)
        params, opt_state, l = step(params, opt_state, idx,
                                    dno, dal, dnr, dcl)
        if verbose and (i % 200 == 0 or i == steps - 1):
            print(f"step {i}: loss {float(l):.4f} "
                  f"({time.time()-t0:.0f}s)")
    return params


def evaluate(params, imgs, label: str = "held-out", verbose: bool = True):
    """(raw, atrous, neural) PSNR in sRGB on full images."""
    import jax.numpy as jnp

    from optix_ray_tracer_tpu.render import denoise as dn
    from optix_ray_tracer_tpu.render import neural_denoise as nd
    from optix_ray_tracer_tpu.utils.color import linear_to_srgb

    def psnr(a, b):
        a = np.asarray(linear_to_srgb(jnp.asarray(a)))
        b = np.asarray(linear_to_srgb(jnp.asarray(b)))
        mse = float(np.mean((a - b) ** 2))
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    raws, ats, nns = [], [], []
    for noisy, alb, nrm, clean in imgs:
        raws.append(psnr(noisy, clean))
        ats.append(psnr(np.asarray(dn.denoise(
            jnp.asarray(noisy), jnp.asarray(alb), jnp.asarray(nrm))),
            clean))
        nns.append(psnr(np.asarray(nd.denoise_neural(
            jnp.asarray(noisy), jnp.asarray(alb), jnp.asarray(nrm),
            params)), clean))
    out = (float(np.mean(raws)), float(np.mean(ats)), float(np.mean(nns)))
    if verbose:
        print(f"{label}: raw {out[0]:.2f} dB | a-trous {out[1]:.2f} dB | "
              f"neural {out[2]:.2f} dB")
    return out


def _save_dataset(path, train_imgs, heldout):
    arrs = {}
    for tag, imgs in (("train", train_imgs), ("held", heldout)):
        for j, name in enumerate(("noisy", "alb", "nrm", "clean")):
            arrs[f"{tag}_{name}"] = np.stack([im[j] for im in imgs])
    np.savez_compressed(path, **arrs)


def _load_dataset(path):
    with np.load(path) as z:
        out = []
        for tag in ("train", "held"):
            stacks = [z[f"{tag}_{n}"] for n in ("noisy", "alb", "nrm",
                                                "clean")]
            out.append(list(zip(*[list(s) for s in stacks])))
    return out[0], out[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--clean-spp", type=int, default=256)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--data", default=None,
                    help="npz cache of the rendered dataset: loaded if "
                         "present, written after rendering otherwise")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from optix_ray_tracer_tpu.render import neural_denoise as nd

    out = args.out or nd._WEIGHTS_FILE
    if args.data and os.path.exists(args.data):
        print(f"loading dataset {args.data} ...")
        train_imgs, heldout = _load_dataset(args.data)
    else:
        print("rendering training set ...")
        train_imgs, heldout = build_dataset(
            size=args.size, views=args.views, clean_spp=args.clean_spp)
        if args.data:
            _save_dataset(args.data, train_imgs, heldout)
            print(f"saved dataset {args.data}")
    params = train(train_imgs, steps=args.steps)
    evaluate(params, train_imgs[:4], label="train[0:4]")
    evaluate(params, heldout)
    # per-scene held-out table (VERDICT r3 #5: neural must win — or a
    # selection rule must be measured — on EVERY held-out scene, not
    # just on average); held-out images are `views` consecutive per
    # scene in HELDOUT_NAMES order
    if len(heldout) % len(HELDOUT_NAMES) == 0:
        v = len(heldout) // len(HELDOUT_NAMES)
        for i, nm in enumerate(HELDOUT_NAMES):
            evaluate(params, heldout[i * v:(i + 1) * v],
                     label=f"held-out {nm}")
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    nd.save_params(params, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
