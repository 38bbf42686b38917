"""Pure JAX kernels for the codec pipeline.

Every op here is traced/jit-compiled, fixed-shape, batchable via ``vmap`` and
shardable via ``shard_map`` — the batched replacement for the reference's
per-frame pybind11 C++ modules (``ops/cpp_modules/src/cpp_modules.cpp``) and
the FPS CUDA op (``ops/fps/src/sampling_gpu.cu``).
"""

from rpcc.ops.rounding import round_half_away
from rpcc.ops.projection import (
    build_transform_map,
    project_points,
    range_image_to_points,
)
