"""interpolate_unstructured_tpu_torch — the PyTorch + CUDA port.

A port of ``interpolate_unstructured_tpu`` (JAX, TPU) to PyTorch on an
NVIDIA H100, one slice at a time.  Ported so far: ``build_grid`` with
its seed, walk and candidate tables; cold and warm point location
(``get_cell``, the neighbor walk, bin and kd-tree seeds); and
interpolation and cell-data lookup (``interpolate_at``,
``interpolate_scalar_at``, ``interpolate_at_icell``,
``get_cell_scalar_at``, ``get_icell_scalar_at``).  Its kernels are CUDA
C++ for ``sm_90a`` (``csrc/``), built by ``nvcc`` on first use into
``build/kernels/``:

* B1 ``ops/interp_kernel.py`` — brute-force locate + interpolate
  (meshes of at most ``bruteforce_max_cells`` cells);
* B2 ``ops/cand_kernel.py`` — the candidate-row probe of larger meshes;
* B3 ``ops/walk_kernel.py`` — the neighbor walk.

On CPU tensors each kernel's plain PyTorch version runs instead.
``build_grid`` puts a grid on the CUDA device unless it is given
``device="cpu"``.  The package imports torch, numpy and scipy, never
jax.
"""

from .models.grid import (
    Grid,
    build_grid,
    get_cell_data_index,
    get_icell_data_index,
    get_point_data_index,
    grid_from_numpy,
)
from .ops.interp import (
    get_cell_scalar_at,
    get_icell_scalar_at,
    interpolate_at,
    interpolate_at_icell,
    interpolate_scalar_at,
)
from .ops.locate import (
    STATUS_ARRIVED,
    STATUS_BOUNDARY,
    STATUS_MASK_CHANGED,
    STATUS_STEP_CAP,
    bin_seed,
    get_cell,
    locate_bruteforce,
    point_is_inside_cell,
    walk,
)
from .utils.config import DEFAULT_CONFIG, IUConfig

__all__ = [
    "DEFAULT_CONFIG",
    "Grid",
    "IUConfig",
    "STATUS_ARRIVED",
    "STATUS_BOUNDARY",
    "STATUS_MASK_CHANGED",
    "STATUS_STEP_CAP",
    "bin_seed",
    "build_grid",
    "get_cell",
    "get_cell_data_index",
    "get_cell_scalar_at",
    "get_icell_data_index",
    "get_icell_scalar_at",
    "get_point_data_index",
    "grid_from_numpy",
    "interpolate_at",
    "interpolate_at_icell",
    "interpolate_scalar_at",
    "locate_bruteforce",
    "point_is_inside_cell",
    "walk",
]
