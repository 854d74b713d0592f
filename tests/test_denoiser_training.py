"""Training-pipeline smoke for the learned denoiser.

Trains the KPCN (render/neural_denoise.py) for a few steps on cheap
SYNTHETIC noisy/clean pairs — no rendering — and checks that optimization
moves and the filter beats the raw input.  Guards the in-repo trainer
(render/train_denoiser.py) against rot without paying the full
render-and-train cost (which runs on an accelerator via its __main__).
"""

import numpy as np
import pytest


def _synthetic_imgs(n=3, H=96, W=96, noise=0.25, seed=0):
    rng = np.random.default_rng(seed)
    imgs = []
    for i in range(n):
        yy, xx = np.mgrid[0:H, 0:W] / H
        alb = np.stack([0.3 + 0.6 * (xx > 0.5),
                        0.5 * np.ones_like(xx),
                        0.4 + 0.4 * (yy > 0.4)], -1).astype(np.float32)
        irr = (0.5 + 0.4 * np.sin(6 * xx + i) * np.cos(5 * yy)
               )[..., None].astype(np.float32) * np.ones(3, np.float32)
        clean = alb * irr
        noisy = np.maximum(
            clean + rng.normal(0, noise, clean.shape).astype(np.float32),
            0.0)
        nrm = np.stack([np.zeros_like(xx), np.zeros_like(xx),
                        np.ones_like(xx)], -1).astype(np.float32)
        imgs.append((noisy, alb, nrm, clean))
    return imgs


@pytest.mark.slow
def test_train_beats_raw_on_synthetic():
    from optix_ray_tracer_tpu.render import train_denoiser as td

    imgs = _synthetic_imgs()
    params = td.train(imgs, steps=60, batch=8, crop=48, verbose=False)
    raw, atrous, neural = td.evaluate(params, imgs, verbose=False)
    # 60 steps is plenty on this easy distribution: the learned filter
    # must clearly beat the raw noisy input (measured ~+13 dB)
    assert neural > raw + 5.0, (raw, neural)
    assert np.isfinite(neural)


def test_dataset_cache_roundtrip(tmp_path):
    from optix_ray_tracer_tpu.render import train_denoiser as td

    train_imgs = _synthetic_imgs(n=2, H=16, W=16)
    heldout = _synthetic_imgs(n=1, H=16, W=16, seed=5)
    p = str(tmp_path / "ds.npz")
    td._save_dataset(p, train_imgs, heldout)
    t2, h2 = td._load_dataset(p)
    assert len(t2) == 2 and len(h2) == 1
    for a, b in zip(train_imgs[0], t2[0]):
        np.testing.assert_array_equal(a, b)


def test_orbit_preserves_target_distance():
    from optix_ray_tracer_tpu.render import train_denoiser as td
    from optix_ray_tracer_tpu.scene.camera import Camera

    cam = Camera.look_at((4.0, 1.0, 2.0), (0.5, -0.5, 0.0), (0, 0, 1))
    cam2 = td._orbit(cam, angle=0.7)
    d1 = np.linalg.norm(np.asarray(cam.center) - np.asarray(cam.target))
    d2 = np.linalg.norm(np.asarray(cam2.center) - np.asarray(cam2.target))
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cam2.target),
                               np.asarray(cam.target), atol=1e-6)
