"""Film: device-resident accumulation buffer + image output + checkpointing.

Replaces the reference's presentation stack (``src/GraphicsAPI/*`` — GL/VK/
D3D swapchains + CUDA interop): the framebuffer is a device array
that accumulates radiance across samples; host fetches happen once per
flush, and output is PNG/PPM files instead of a swapchain.

Also provides the checkpoint/resume the reference never needed (1 spp +
denoiser, SURVEY.md section 5.4): progressive renders can persist
(accumulator, sample count, seed) and continue bit-exactly thanks to the
counter-based RNG.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from optix_ray_tracer_tpu.utils.color import color_to_uint8, write_png, write_ppm


def save_aov_images(prefix: str, albedo_mean, normal_mean) -> list[str]:
    """Write the denoiser guide channels as AOV images:
    ``<prefix>_albedo.png`` (sRGB-encoded mean albedo) and
    ``<prefix>_normal.png`` (world-space normals mapped ``(n+1)/2``,
    stored linearly).

    The reference computes exactly these two buffers every frame as its
    denoiser guides (``shader/Shader.cu:269-272`` writes albedoBuffer /
    normalBuffer) but never exposes them; here they double as inspectable
    product output (CLI ``--aov``).
    """
    alb_path, nrm_path = prefix + "_albedo.png", prefix + "_normal.png"
    write_png(alb_path, np.asarray(color_to_uint8(albedo_mean)))
    n01 = jnp.clip(jnp.asarray(normal_mean) * 0.5 + 0.5, 0.0, 1.0)
    write_png(nrm_path, np.asarray(
        jnp.minimum((n01 * 256.0).astype(jnp.uint32), 255).astype(jnp.uint8)))
    return [alb_path, nrm_path]


@dataclasses.dataclass(frozen=True)
class U8Frame:
    """A frame quantized to sRGB uint8 ON DEVICE before the host fetch —
    the reference's float4->uchar4 conversion kernel analog
    (``src/Global/RendererImpl.cu:672-678``).

    The animation fast path yields these instead of :class:`Film`:
    fetching 4 B/pixel instead of 12 B/pixel of float radiance cuts the
    per-frame device-to-host transfer ~3x.  Carries no linear accumulation state — callers
    that need radiance/guides ask ``render_frames`` for Films instead
    (``quantize=False``).
    """
    rgba: np.ndarray          # (H, W, 4) uint8, sRGB-encoded
    spp: int = 1

    def to_uint8(self) -> np.ndarray:
        return np.asarray(self.rgba)

    def save(self, path: str) -> None:
        img = self.to_uint8()
        if path.endswith(".ppm"):
            write_ppm(path, img)
        else:
            write_png(path, img)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Film:
    """Accumulated radiance + sample count (a pytree; lives on device)."""
    accum: jax.Array          # (H, W, 3) float32 radiance sum
    albedo_accum: jax.Array   # (H, W, 3)
    normal_accum: jax.Array   # (H, W, 3)
    spp: jax.Array            # () int32 samples accumulated so far

    @staticmethod
    def create(width: int, height: int) -> "Film":
        z = jnp.zeros((height, width, 3), jnp.float32)
        return Film(accum=z, albedo_accum=z, normal_accum=z,
                    spp=jnp.int32(0))

    def add(self, radiance, albedo=None, normal=None, samples: int = 1) -> "Film":
        """Accumulate a (H, W, 3) per-sample-mean radiance estimate computed
        from ``samples`` samples."""
        s = jnp.int32(samples)
        return Film(
            accum=self.accum + radiance * s,
            albedo_accum=self.albedo_accum + (albedo * s if albedo is not None
                                              else jnp.zeros_like(self.accum)),
            normal_accum=self.normal_accum + (normal * s if normal is not None
                                              else jnp.zeros_like(self.accum)),
            spp=self.spp + s)

    def mean(self):
        inv = 1.0 / jnp.maximum(self.spp.astype(jnp.float32), 1.0)
        return self.accum * inv

    def to_uint8(self) -> np.ndarray:
        """sRGB-encoded RGBA uint8 frame (host)."""
        return np.asarray(color_to_uint8(self.mean()))

    def save(self, path: str) -> None:
        img = self.to_uint8()
        if path.endswith(".ppm"):
            write_ppm(path, img)
        else:
            write_png(path, img)

    def save_aovs(self, prefix: str) -> list[str]:
        """Write this film's guide channels via :func:`save_aov_images`.
        Guides are zero unless the render path carried them (see the
        frontends' ``fetch_guides`` contract)."""
        inv = 1.0 / jnp.maximum(self.spp.astype(jnp.float32), 1.0)
        return save_aov_images(prefix, self.albedo_accum * inv,
                               self.normal_accum * inv)

    # ---- checkpoint / resume -------------------------------------------

    def checkpoint(self, path: str, meta: dict | None = None) -> None:
        """Persist accumulation state (npz + sidecar json)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path,
                 accum=np.asarray(self.accum),
                 albedo=np.asarray(self.albedo_accum),
                 normal=np.asarray(self.normal_accum),
                 spp=int(self.spp))
        if meta is not None:
            with open(path + ".json", "w") as f:
                json.dump(meta, f)

    @staticmethod
    def restore(path: str) -> "Film":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            return Film(accum=jnp.asarray(z["accum"]),
                        albedo_accum=jnp.asarray(z["albedo"]),
                        normal_accum=jnp.asarray(z["normal"]),
                        spp=jnp.int32(int(z["spp"])))
