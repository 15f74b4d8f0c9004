"""interpolate_unstructured_tpu_torch — the PyTorch + CUDA port.

A port of ``interpolate_unstructured_tpu`` (JAX, TPU) to PyTorch on an
NVIDIA H100, one slice at a time.  Ported so far: ``build_grid`` with
its seed, walk and candidate tables and the data-mutation API
(``add_point_data`` and the other adders, ``set_point_data``, the
``reserve_*`` functions); cold and warm point location (``get_cell``,
the neighbor walk, bin and kd-tree seeds); interpolation and cell-data
lookup (``interpolate_at``, ``interpolate_scalar_at``,
``interpolate_at_icell``, ``get_cell_scalar_at``,
``get_icell_scalar_at``); field-line tracing (``integrate_along_field``,
``build_trace_table``); and accurate mode, float64-grade values from a
float32 grid (``prepare_accurate``, ``interpolate_at_acc``,
``interpolate_at_icell_acc``); mesh input and output (``read_grid``
reads every mesh format the JAX package reads, through the converter
``io/convert.py`` and its ``.binda`` cache; ``write_vtk``,
``write_trace_vtk``); grid checkpoints (``save_grid``, ``load_grid``,
in the JAX package's binda v5 layout, so either package loads what the
other saved); ``validate_grid``; and the JAX package's utilities:
``utils/serial_oracle.py`` (the binding of the independent serial C++
oracle ``native/serial_oracle.cc``, which it builds with g++),
``utils/timing.py`` and ``utils/cache.py``.  Its kernels are CUDA C++ for
``sm_90a`` (``csrc/``), built by ``nvcc`` on first use into
``build/kernels/``:

* B1 ``ops/interp_kernel.py`` — brute-force locate + interpolate
  (meshes of at most ``bruteforce_max_cells`` cells);
* B2 ``ops/cand_kernel.py`` — the candidate-row probe of larger meshes,
  and its df-plane branch (B2-df), accurate mode's cold query;
* B3 ``ops/walk_kernel.py`` — the neighbor walk;
* B4 ``ops/trace_kernel.py`` — the fused stages of a tracer iteration;
* B5 ``ops/acc_kernel.py`` — df32 interpolation at known cells.

B1, B2 and B3 also take float64 grids, in double (the JAX package's
float64 route); accurate mode (B2-df, B5) and the fused tracer (B4)
take float32 grids, and a float64 trace takes the generic path.
On CPU tensors each kernel's plain PyTorch version runs instead.
``build_grid``, ``read_grid``, ``load_grid`` and ``build_kdtree`` put
their tensors on the CUDA device unless they are given ``device="cpu"``.
The package imports torch, numpy and scipy, never jax; ``h5py`` (XDMF
sidecars, CGNS) and ``meshio`` (the converter's fallback) only when a
file needs them.
"""

from .models.grid import (
    Grid,
    UGrid,
    add_cell_data,
    add_icell_data,
    add_point_data,
    build_grid,
    get_cell_data_index,
    get_icell_data_index,
    get_point_data_index,
    grid_from_numpy,
    read_grid,
    reserve_cell_data_storage,
    reserve_icell_data_storage,
    reserve_point_data_storage,
    set_point_data,
    write_vtk,
)
from .io.checkpoint import load_grid, save_grid
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
from .ops.interp_acc import (
    interpolate_at_acc,
    interpolate_at_icell_acc,
    prepare_accurate,
)
from .ops.kdtree import KdTree, build_kdtree, nearest as kdtree_nearest
from .trace import (
    TraceResult,
    build_trace_table,
    integrate_along_field,
    write_trace_vtk,
)
from .utils.config import DEFAULT_CONFIG, IUConfig
from .utils.validate import validate_grid

__all__ = [
    "DEFAULT_CONFIG",
    "Grid",
    "IUConfig",
    "KdTree",
    "STATUS_ARRIVED",
    "STATUS_BOUNDARY",
    "STATUS_MASK_CHANGED",
    "STATUS_STEP_CAP",
    "TraceResult",
    "UGrid",
    "add_cell_data",
    "add_icell_data",
    "add_point_data",
    "bin_seed",
    "build_grid",
    "build_kdtree",
    "build_trace_table",
    "get_cell",
    "get_cell_data_index",
    "get_cell_scalar_at",
    "get_icell_data_index",
    "get_icell_scalar_at",
    "get_point_data_index",
    "grid_from_numpy",
    "integrate_along_field",
    "interpolate_at",
    "interpolate_at_acc",
    "interpolate_at_icell",
    "interpolate_at_icell_acc",
    "interpolate_scalar_at",
    "kdtree_nearest",
    "load_grid",
    "locate_bruteforce",
    "point_is_inside_cell",
    "prepare_accurate",
    "read_grid",
    "reserve_cell_data_storage",
    "reserve_icell_data_storage",
    "reserve_point_data_storage",
    "save_grid",
    "set_point_data",
    "validate_grid",
    "walk",
    "write_trace_vtk",
    "write_vtk",
]
