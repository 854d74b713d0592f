"""optix_ray_tracer_tpu — a renderer framework in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
``3169651074/nvidia-optix-ray-tracer`` (an OptiX 9 real-time renderer for
time-series DEM/VTK particle simulation data), running on one or more
NVIDIA GPUs (README.md says where the package name comes from):

* OptiX GAS/IAS hardware BVHs      -> on-device LBVH (Morton + Karras) built
                                      with XLA sort, walked per ray by one
                                      Pallas (Triton) traversal kernel
                                      (``ops/gpu_traverse.py``).
* recursive megakernel shaders     -> an iterative wavefront integrator
                                      (``render/wavefront.py``) with
                                      ``lax.scan`` over bounce depth.
* cuRAND mutable per-pixel states  -> stateless counter-based RNG keyed by
                                      (pixel, sample, bounce).
* SBT + program groups             -> material/geometry index arrays and
                                      vectorized masked shading.
* SDL/GL/VK/D3D presentation       -> headless device-resident film + PNG/PPM
                                      output (``render/film.py``), optional
                                      local viewer.
* single-GPU                       -> multi-GPU via ``jax.sharding.Mesh``
                                      (``parallel/``).

Scene/config compatibility: the JSON config schema, ``.vtk.series``
manifests, VTK ASCII polydata, and STL shape libraries of the reference are
all supported by ``io/``.
"""

__version__ = "0.1.0"

import jax as _jax

# Ray tracing needs true fp32 arithmetic: on the GPU, float32 matmuls and
# einsums default to TF32 (about three decimal digits), which loses
# intersection precision.  Geometry math is tiny compared to traversal, so
# force full precision globally.
_jax.config.update("jax_default_matmul_precision", "highest")

from optix_ray_tracer_tpu.utils import vecmath, transforms, color, colorramp  # noqa: F401,E402
