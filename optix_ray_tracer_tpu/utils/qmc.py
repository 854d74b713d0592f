"""Low-discrepancy sampling: hash-based Owen-scrambled Sobol points.

The reference samples with per-pixel cuRAND states
(``src/Global/HostFunctions.cu:122-140``) — pure pseudo-random, variance
~ 1/N.  This module provides the quasi-Monte-Carlo upgrade the stateless
design makes natural: **padded 2D Sobol sequences with hash-based Owen
scrambling** (Burley, "Practical Hash-Based Owen Scrambling", JCGT
2020).  Each (pixel, bounce, purpose) gets its own randomized sequence,
indexed by the sample counter:

* the POINT SET per pad is (0,1)-Sobol in 2D (van der Corput +
  Sobol dim-2), whose first 2^k points perfectly stratify every
  elementary interval — variance ~ 1/N^2 on smooth integrands;
* Owen scrambling (nested uniform scramble of the output bits) plus an
  Owen shuffle of the sample index decorrelate pixels and pads while
  PRESERVING the (0,1) stratification — unbiased, and the whole thing
  stays a pure function of ``(pixel_id, sample, bounce, seed)``:
  replayable, shard-safe, stateless under jit, exactly like the PCG4D
  path (utils/rng.py).

Everything is uint32 bit arithmetic — no tables beyond 32x4
direction-number constants, no gathers.

Integrators opt in with ``sampler="sobol"`` (io/config.py key
``sampler``); the PCG4D stream stays the default so existing goldens
and the reference-parity determinism contract are untouched.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_INV_2_24 = float(1.0 / (1 << 24))


def _joe_kuo_directions() -> np.ndarray:
    """Direction numbers (32, D) for the first D Sobol dimensions.

    Dimension 0 is van der Corput; the rest follow the Joe-Kuo
    recurrence from published primitive-polynomial parameters."""
    # (s, a, m) rows of new-joe-kuo-6 for dimensions 2..6 (1-indexed)
    params = [
        (1, 0, [1]),
        (2, 1, [1, 3]),
        (3, 1, [1, 3, 1]),
        (3, 2, [1, 1, 1]),
        (4, 1, [1, 1, 3, 3]),
    ]
    dims = [np.array([1 << (31 - j) for j in range(32)], np.uint64)]
    for s, a, m in params:
        v = np.zeros(32, np.uint64)
        for j in range(s):
            v[j] = np.uint64(m[j]) << np.uint64(31 - j)
        for j in range(s, 32):
            v[j] = v[j - s] ^ (v[j - s] >> np.uint64(s))
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v[j] ^= v[j - k]
        dims.append(v)
    return np.stack(dims, axis=1).astype(np.uint32)   # (32, D)


_DIRECTIONS = _joe_kuo_directions()                    # (32, 6)


def reverse_bits32(x):
    """Bit-reverse each uint32 lane (5 masked shuffle steps)."""
    x = jnp.asarray(x).astype(_U32)
    x = ((x & _U32(0x55555555)) << 1) | ((x >> 1) & _U32(0x55555555))
    x = ((x & _U32(0x33333333)) << 2) | ((x >> 2) & _U32(0x33333333))
    x = ((x & _U32(0x0F0F0F0F)) << 4) | ((x >> 4) & _U32(0x0F0F0F0F))
    x = ((x & _U32(0x00FF00FF)) << 8) | ((x >> 8) & _U32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def _laine_karras(x, seed):
    """Laine-Karras-style hash: for a fixed seed, a bijection on uint32
    in which bit i depends only on bits <= i — an Owen scramble when
    applied in the reversed-bit domain (Burley 2020, listing 4)."""
    x = x + seed
    x = x ^ (x * _U32(0x6C50B47C))
    x = x ^ (x * _U32(0xB82F1E52))
    x = x ^ (x * _U32(0xC7AFE638))
    x = x ^ (x * _U32(0x8D22F6E6))
    return x


def owen_scramble(x, seed):
    """Nested uniform (Owen) scramble of a [0,1)-as-uint32 value."""
    x = jnp.asarray(x).astype(_U32)
    seed = jnp.asarray(seed).astype(_U32)
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed))


def sobol_u32(index, dim: int):
    """Raw Sobol point (as uint32 radical-inverse bits) of ``index`` in
    dimension ``dim`` (static python int < 6)."""
    idx = jnp.asarray(index).astype(_U32)
    acc = jnp.zeros_like(idx)
    for j in range(32):
        bit = (idx >> j) & _U32(1)
        acc = acc ^ (bit * _U32(int(_DIRECTIONS[j, dim])))
    return acc


def _to_unit_float(u):
    return (u >> 8).astype(jnp.float32) * _INV_2_24


def sobol_owen4(pixel_id, sample, bounce, seed):
    """Four U[0,1) floats: two Owen-scrambled 2D Sobol pads over the
    SAMPLE index, decorrelated per (pixel, bounce, seed).

    Drop-in for utils/rng.uniform4: same signature, same purity
    contract.  Components (0,1) form one (0,1)-sequence pad, (2,3) a
    second — call sites that consume one or two components per draw get
    genuine low-discrepancy pairs.
    """
    from optix_ray_tracer_tpu.utils.rng import pcg4d

    s_shuf, s0, s1, s2 = pcg4d(pixel_id, bounce, seed,
                               jnp.uint32(0x9E3779B9))
    # Owen-shuffle the index (same shuffle for all dims of this pad set:
    # required — a per-dim shuffle would break the joint 2D (0,1)
    # stratification), then Owen-scramble each dimension independently
    idx = owen_scramble(jnp.asarray(sample).astype(_U32), s_shuf)
    u0 = owen_scramble(sobol_u32(idx, 0), s0)
    u1 = owen_scramble(sobol_u32(idx, 1), s1)
    u2 = owen_scramble(sobol_u32(idx, 2), s2)
    u3 = owen_scramble(sobol_u32(idx, 3), s0 ^ s1)
    return (_to_unit_float(u0), _to_unit_float(u1),
            _to_unit_float(u2), _to_unit_float(u3))
