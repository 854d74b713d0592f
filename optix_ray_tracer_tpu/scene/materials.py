"""Material table — the replacement for OptiX SBT hit records.

The reference dispatches shading through 6 program groups + per-instance SBT
records holding a union of {rough{albedo} | metal{albedo, fuzz}}
(``include/Global/Shader.cuh:43-70``).  Here there is no function-pointer
dispatch: materials live in one SoA table and the shade stage gathers rows by
``material_id`` and blends BSDF branches with masks (``jnp.where``), which
keeps the whole wavefront in elementwise XLA code.

Parity types: ROUGH (Lambertian), METAL (mirror + fuzz).  Extension types
required by the benchmark configs (BASELINE.md): DIELECTRIC (glass) and
EMISSIVE (area lights for NEE/MIS path tracing).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

ROUGH = 0       # Lambertian; reference MaterialType::ROUGH (Shader.cuh:16)
METAL = 1       # mirror + fuzz; reference MaterialType::METAL (Shader.cuh:17)
DIELECTRIC = 2  # extension: glass, Schlick fresnel
EMISSIVE = 3    # extension: diffuse area-light emitter

MATERIAL_NAMES = {"ROUGH": ROUGH, "METAL": METAL,
                  "DIELECTRIC": DIELECTRIC, "EMISSIVE": EMISSIVE}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material table.

    mtype:    (M,)   int32  — ROUGH/METAL/DIELECTRIC/EMISSIVE
    albedo:   (M, 3) float32
    param:    (M,)   float32 — fuzz for METAL, ior for DIELECTRIC
    emission: (M, 3) float32 — radiance for EMISSIVE
    """
    mtype: jax.Array
    albedo: jax.Array
    param: jax.Array
    emission: jax.Array

    @property
    def count(self) -> int:
        return self.mtype.shape[0]

    def gather(self, material_id):
        """Row lookup for a batch of hits: returns (mtype, albedo, param, emission)."""
        mid = jnp.clip(material_id, 0, self.count - 1)
        return (self.mtype[mid], self.albedo[mid],
                self.param[mid], self.emission[mid])


class MaterialBuilder:
    """Host-side accumulation of materials into one table.

    Mirrors how the reference concatenates roughs + metals + the baked
    color-ramp particle materials into ``materialAllFiles``
    (``src/Global/RendererMesh.cu:223-233``).
    """

    def __init__(self) -> None:
        self._rows: list[tuple[int, tuple, float, tuple]] = []

    def __len__(self) -> int:
        return len(self._rows)

    def add(self, mtype: int, albedo, param: float = 0.0,
            emission=(0.0, 0.0, 0.0)) -> int:
        self._rows.append((mtype, tuple(albedo), float(param), tuple(emission)))
        return len(self._rows) - 1

    def add_rough(self, albedo) -> int:
        return self.add(ROUGH, albedo)

    def add_metal(self, albedo, fuzz: float = 0.0) -> int:
        return self.add(METAL, albedo, fuzz)

    def add_dielectric(self, ior: float = 1.5) -> int:
        return self.add(DIELECTRIC, (1.0, 1.0, 1.0), ior)

    def add_emissive(self, emission) -> int:
        return self.add(EMISSIVE, (0.0, 0.0, 0.0), 0.0, emission)

    def add_ramp(self, colors: np.ndarray) -> int:
        """Append a baked color ramp as consecutive ROUGH rows; returns the
        index of the first (the reference's ``materialOffset``)."""
        first = len(self._rows)
        for c in np.asarray(colors, np.float32):
            self.add_rough(c)
        return first

    def build(self) -> MaterialTable:
        if not self._rows:
            # one fallback material so gathers stay in-bounds
            self.add_rough((0.5, 0.5, 0.5))
        mtype = np.asarray([r[0] for r in self._rows], np.int32)
        albedo = np.asarray([r[1] for r in self._rows], np.float32)
        param = np.asarray([r[2] for r in self._rows], np.float32)
        emission = np.asarray([r[3] for r in self._rows], np.float32)
        return MaterialTable(mtype=jnp.asarray(mtype), albedo=jnp.asarray(albedo),
                             param=jnp.asarray(param), emission=jnp.asarray(emission))
