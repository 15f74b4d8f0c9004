"""interpolate_unstructured_tpu_torch — the PyTorch + CUDA port.

A port of ``interpolate_unstructured_tpu`` (JAX, TPU) to PyTorch on an
NVIDIA H100, one slice at a time.  This slice is the cold interpolation
path: ``build_grid``, then ``interpolate_at`` / ``interpolate_scalar_at``
without a warm guess.  Its two kernels are CUDA C++ for ``sm_90a``
(``csrc/``), built by ``nvcc`` on first use into ``build/kernels/``:

* B1 ``ops/interp_kernel.py`` — brute-force locate + interpolate
  (meshes of at most ``bruteforce_max_cells`` cells);
* B2 ``ops/cand_kernel.py`` — the candidate-row probe of larger meshes.

On CPU tensors each kernel's plain PyTorch version runs instead.  The
package imports torch and numpy, never jax.
"""

from .models.grid import (
    Grid,
    build_grid,
    get_point_data_index,
    grid_from_numpy,
)
from .ops.interp import interpolate_at, interpolate_scalar_at
from .utils.config import DEFAULT_CONFIG, IUConfig

__all__ = [
    "DEFAULT_CONFIG",
    "Grid",
    "IUConfig",
    "build_grid",
    "get_point_data_index",
    "grid_from_numpy",
    "interpolate_at",
    "interpolate_scalar_at",
]
