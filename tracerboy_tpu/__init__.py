"""tracerboy-tpu: a physically-based progressive path tracer in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of wallisc/TracerBoy
(C++/DX12/HLSL GPU path tracer), run on an NVIDIA GPU. The reference's
megakernel + DXR design is replaced by a wavefront pipeline (raygen ->
traverse -> shade) over flat ray pools, with the BVH stored as a flattened
structure-of-arrays in device memory and traversed by vectorized masked
kernels. See SURVEY.md at the repo root for
the full component inventory being rebuilt.
"""

__version__ = "0.1.0"

from tracerboy_tpu.renderer import Renderer, RenderState  # noqa: F401
from tracerboy_tpu.utils.config import (  # noqa: F401
    OutputSettings,
    CameraSettings,
    PostProcessSettings,
    DenoiserSettings,
    PerformanceSettings,
    DebugSettings,
    FilterType,
    TonemapType,
    RenderMode,
    OutputType,
    default_output_settings,
)
