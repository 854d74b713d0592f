"""Logging + error taxonomy.

The reference logs through SDL (~80 call sites) and fails fast with
per-subsystem exit codes: VTK -1, config -2, SDL -100, CUDA -200,
OptiX -300, VK -400, D3D -500 (``include/Global/HostFunctions.cuh:147-182``,
``include/Util/VTKMeshReader.cuh:7``).  This framework maps those to a
typed exception hierarchy (libraries should raise, not exit) plus standard
``logging`` with a renderer-wide logger.
"""

from __future__ import annotations

import logging
import sys

LOG = logging.getLogger("optix_ray_tracer_tpu")

# Exit codes kept for CLI compatibility with the reference's conventions.
EXIT_VTK = -1
EXIT_CONFIG = -2
EXIT_DEVICE = -200   # CUDA analog: JAX device runtime failures


class RendererError(RuntimeError):
    """Base class; ``exit_code`` mirrors the reference's taxonomy."""
    exit_code = 1


class DeviceError(RendererError):
    exit_code = EXIT_DEVICE


def configure(verbose: bool = False, stream=sys.stderr) -> None:
    """Set up the renderer logger (idempotent)."""
    if LOG.handlers:
        LOG.setLevel(logging.DEBUG if verbose else logging.INFO)
        return
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname).1s] %(message)s", datefmt="%H:%M:%S"))
    LOG.addHandler(handler)
    LOG.setLevel(logging.DEBUG if verbose else logging.INFO)
