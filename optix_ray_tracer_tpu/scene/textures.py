"""Texture sampling — benchmark config 5 ("textures + HDR env map").

A :class:`TextureSet` packs same-sized RGB textures into one (N, TH, TW, 3)
device array with a per-material texture index (-1 = untextured).  At shade
time the integrator multiplies the material albedo by the bilinear texture
sample at the hit's interpolated UV — the standard baseColor * texture model.

All lookups are dense gathers on a single packed array; smaller textures are
resampled to the atlas resolution at build time (host-side).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TextureSet:
    """atlas: (N, TH, TW, 3) float32 linear-space; material_texture:
    (M,) int32 texture index per material row (-1 = none)."""
    atlas: jax.Array
    material_texture: jax.Array

    @property
    def count(self) -> int:
        return self.atlas.shape[0]

    def sample(self, material_id, uv):
        """Bilinear, wrap-around sample; untextured materials return 1.

        material_id: (R,) int32; uv: (R, 2).  Returns (R, 3) multipliers.
        """
        n, th, tw = self.atlas.shape[0], self.atlas.shape[1], self.atlas.shape[2]
        tex_id = self.material_texture[
            jnp.clip(material_id, 0, self.material_texture.shape[0] - 1)]
        has_tex = tex_id >= 0
        ti = jnp.maximum(tex_id, 0)

        u = uv[..., 0] * tw - 0.5
        v = (1.0 - uv[..., 1]) * th - 0.5  # image row 0 = top, v=1 = top
        u0 = jnp.floor(u)
        v0 = jnp.floor(v)
        fu = (u - u0)[..., None]
        fv = (v - v0)[..., None]
        u0i = jnp.mod(u0.astype(jnp.int32), tw)
        u1i = jnp.mod(u0i + 1, tw)
        v0i = jnp.mod(v0.astype(jnp.int32), th)
        v1i = jnp.mod(v0i + 1, th)

        c00 = self.atlas[ti, v0i, u0i]
        c01 = self.atlas[ti, v0i, u1i]
        c10 = self.atlas[ti, v1i, u0i]
        c11 = self.atlas[ti, v1i, u1i]
        col = (c00 * (1 - fu) + c01 * fu) * (1 - fv) \
            + (c10 * (1 - fu) + c11 * fu) * fv
        return jnp.where(has_tex[..., None], col, 1.0)


def _resample_nearest(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(th) * h // th).clip(0, h - 1)
    xs = (np.arange(tw) * w // tw).clip(0, w - 1)
    return img[ys][:, xs]


def build_texture_set(textures: list[np.ndarray | None],
                      material_texture_ids: list[int],
                      resolution: int = 256) -> TextureSet:
    """Pack host textures (HxWx3 float arrays in linear space, or None
    placeholders) into a TextureSet at a common resolution."""
    packed = []
    remap = {}
    for i, t in enumerate(textures):
        if t is None:
            continue
        remap[i] = len(packed)
        packed.append(_resample_nearest(np.asarray(t, np.float32),
                                        resolution, resolution))
    if not packed:
        packed = [np.ones((resolution, resolution, 3), np.float32)]
    atlas = np.stack(packed, 0)
    mat_tex = np.asarray([remap.get(t, -1) if t is not None and t >= 0 else -1
                          for t in material_texture_ids], np.int32)
    return TextureSet(atlas=jnp.asarray(atlas),
                      material_texture=jnp.asarray(mat_tex))


def checker_texture(res: int = 128, tiles: int = 8,
                    c0=(0.9, 0.9, 0.9), c1=(0.2, 0.2, 0.2)) -> np.ndarray:
    """Procedural checkerboard (tests / benchmarks without assets)."""
    y, x = np.mgrid[0:res, 0:res]
    mask = ((x * tiles // res) + (y * tiles // res)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(c0, np.float32),
                   np.asarray(c1, np.float32))
    return img.astype(np.float32)


def load_texture(path: str) -> np.ndarray:
    """Read an image file as a linear-space float texture: binary PPM, or
    8-bit PNG (``utils.color.read_png``).  Other formats raise ValueError."""
    lower = path.lower()
    if lower.endswith(".ppm"):
        return read_ppm_texture(path)
    if not lower.endswith(".png"):
        raise ValueError(f"texture {path}: only binary PPM (.ppm) and 8-bit "
                         "PNG (.png) images are read")
    from optix_ray_tracer_tpu.utils.color import read_png, srgb_to_linear
    with open(path, "rb") as f:
        img = read_png(f.read())
    if img.shape[-1] < 3:          # grey / grey+alpha -> RGB
        img = np.repeat(img[..., :1], 3, axis=-1)
    img = img[..., :3].astype(np.float32) / 255.0
    return np.asarray(srgb_to_linear(jnp.asarray(img)), np.float32)


def read_ppm_texture(path: str) -> np.ndarray:
    """Read a binary PPM as a linear-space float texture (sRGB-decoded)."""
    from optix_ray_tracer_tpu.utils.color import srgb_to_linear
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise ValueError("only binary PPM (P6) supported")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    img = data.reshape(h, w, 3).astype(np.float32) / maxval
    return np.asarray(srgb_to_linear(jnp.asarray(img)), np.float32)
