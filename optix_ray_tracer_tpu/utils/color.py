"""Color transforms: linear <-> sRGB, float -> uint8 framebuffer conversion.

Matches the exact constants of the reference's conversion kernels
(``include/Global/DeviceFunctions.cuh:153-212``): gamma 1/2.4, linear cutoff
0.0031308, 12.92 linear slope, 1.055/-0.055 power segment, and the
``min(uint(s * 256), 255)`` byte quantization of ``colorToUchar4``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


#: Rec.709 luma weights — the single shared definition (light selection,
#: env-map importance tables, adaptive-sampling error metric).
LUMA_709 = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def luminance(rgb):
    """Rec.709 luminance of (..., 3) linear RGB; works for numpy and jnp."""
    return rgb @ LUMA_709


def linear_to_srgb(c):
    """Per-channel linear->sRGB with reference constants; clips to [0, 1]."""
    c = jnp.clip(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * jnp.power(jnp.maximum(c, 1e-30), 1.0 / 2.4) - 0.055
    return jnp.clip(jnp.where(c < 0.0031308, lo, hi), 0.0, 1.0)


def srgb_to_linear(s):
    s = jnp.clip(s, 0.0, 1.0)
    lo = s / 12.92
    hi = jnp.power((s + 0.055) / 1.055, 2.4)
    return jnp.where(s <= 0.04045, lo, hi)


def color_to_float4(rgb):
    """sRGB-encode an (..., 3) linear color and append alpha=1.

    Semantics of ``colorToFloat4`` (DeviceFunctions.cuh:188-210), which the
    raygen program applies before writing the color buffer
    (shader/Shader.cu:269).
    """
    srgb = linear_to_srgb(rgb[..., :3])
    alpha = jnp.ones_like(srgb[..., :1])
    return jnp.concatenate([srgb, alpha], axis=-1)


def color_to_uint8(rgb):
    """sRGB-encode and quantize to uint8 RGBA.

    Semantics of ``colorToUchar4`` (DeviceFunctions.cuh:153-185):
    ``min(uint(srgb * 256), 255)``.
    """
    srgb = linear_to_srgb(rgb[..., :3])
    q = jnp.minimum((srgb * 256.0).astype(jnp.uint32), 255).astype(jnp.uint8)
    alpha = jnp.full_like(q[..., :1], 255)
    return jnp.concatenate([q, alpha], axis=-1)


def write_ppm(path, rgb_uint8: np.ndarray) -> None:
    """Write an (H, W, >=3) uint8 image as binary PPM (dependency-free)."""
    arr = np.asarray(rgb_uint8)[..., :3]
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.astype(np.uint8).tobytes())


def png_bytes(rgba_uint8: np.ndarray) -> bytes:
    """Encode an image as PNG in memory (zlib + struct only, no imaging deps).

    Replaces the reference's swapchain present path — the framebuffer is
    fetched from the device once per flush and encoded on host.
    """
    import struct
    import zlib

    arr = np.asarray(rgba_uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), 255, np.uint8)], axis=-1)
        c = 4
    color_type = {1: 0, 2: 4, 4: 6}.get(c, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path, rgba_uint8: np.ndarray) -> None:
    """Write an image as a PNG file (see :func:`png_bytes`)."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgba_uint8))


def read_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced grey/grey+alpha/RGB/RGBA PNG to an
    (H, W, C) uint8 array (zlib + struct only, the inverse of
    :func:`png_bytes`).  Other PNG kinds raise ValueError."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color_type}, "
            f"interlace {interlace}); use an 8-bit PNG or a binary PPM")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w * channels + 1)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    line = raw[:, 1:].reshape(h, w, channels)
    if not ftype.any():
        return line.copy()
    # A filter predicts a pixel from its reconstructed left (a), up (b) and
    # up-left (c) neighbours, so the pixels of one anti-diagonal x + y = k
    # depend only on diagonals k-1 and k-2: decode a diagonal at a time.
    line = line.astype(np.int32)
    out = np.zeros((h + 1, w + 1, channels), np.int32)   # zero top/left rim
    for k in range(w + h - 1):
        y = np.arange(max(0, k - w + 1), min(h, k + 1))
        x = k - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[y][:, None], [0, a, b, (a + b) >> 1, paeth])
        out[y + 1, x + 1] = (line[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)
