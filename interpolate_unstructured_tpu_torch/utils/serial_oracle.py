"""ctypes binding for the independent serial C++ oracle.

``native/serial_oracle.cc`` reimplements the reference's point
location (nearest-point seed + neighbor walk,
m_interp_unstructured.f90:272-288, :664-763), simplex and quad
interpolation (:529-641) and the RK23 field-line tracer (:987-1217) in
plain serial C++, written from the algorithm and not from either
package.  It backs

* cross-validation tests (``tests/test_torch_serial_oracle.py``,
  ``tests/test_torch_trace.py``): the port's candidate, walk and
  brute-force paths must agree with it at 1e-12 in float64, and its
  traces at 1e-9;
* ``chip_smoke.py``'s oracle phase, which holds the card's answers
  against it on the host CPU and prints its single-core rates.

The port's copy of the JAX package's binding, with the same names,
arguments and outputs, building the same source.  The shared library
is compiled on first use (never at import) with
``g++ -O3 -march=native -shared -fPIC`` into ``build/serial_oracle/``
at the repository root (the directory
``utils.cache.enable_compile_cache`` sets), named by a hash of the
source and flags and by the CPU's instruction-set flags, so a changed
source or another CPU builds once.  Without a C++ toolchain
:func:`available` returns False (tests skip), and :func:`serial_query`
and :func:`serial_trace` raise with the compiler's message.

Inputs may be numpy arrays or torch tensors on any device: they are
copied to the host as float64 (coordinates, data, seeds) and int32
(connectivity, guesses, masks) before the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import cache

SRC = Path(__file__).resolve().parents[2] / "native" / "serial_oracle.cc"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lib = None
_build_error = None


def _machine_tag() -> str:
    """ISA component of the library's name: ``-march=native`` binaries
    are CPU-specific, so another CPU must miss the cache."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.strip())
                    break
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:8]


def library_path() -> Path:
    """Where the library for the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return cache.build_dir("serial_oracle") / (
        f"serial_oracle_{h.hexdigest()[:16]}_{_machine_tag()}.so")


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.build{os.getpid()}")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders race safely
    return so


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        _build_error = e
        return None
    f = lib.iu_serial_query
    f.restype = None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f.argtypes = [
        ctypes.c_int, ctypes.c_int,                # npc, is_quad
        ctypes.c_int, ctypes.c_int,                # n_points, n_cells
        f64p, i32p, i32p, f64p,                    # points, cells, nbrs, data
        ctypes.c_int, f64p,                        # n_q, queries
        ctypes.c_void_p, ctypes.c_int,             # guesses (or NULL), max_steps
        f64p, i32p, u8p,                           # out_vals, out_ic, out_found
    ]
    t = lib.iu_serial_trace
    t.restype = None
    t.argtypes = [
        ctypes.c_int, ctypes.c_int,                # npc, is_quad
        ctypes.c_int, ctypes.c_int,                # n_points, n_cells
        f64p, i32p, i32p,                          # points, cells, nbrs
        ctypes.c_int, f64p, ctypes.c_int,          # ndim, field (ndim,np), nvar
        ctypes.c_double, ctypes.c_double,          # min_dx, max_dx
        ctypes.c_int,                              # max_steps
        ctypes.c_double, ctypes.c_double,          # rtol, atol
        ctypes.c_int, ctypes.c_int,                # reverse, axisymmetric
        ctypes.c_void_p, ctypes.c_int,             # icell_mask (or NULL), mask_value
        ctypes.c_int, f64p, ctypes.c_int,          # n_traj, y0, max_iterations
        f64p, f64p, i32p, i32p,                    # out_y, out_yfield, nsteps, bm
    ]
    _lib = lib
    return _lib


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"serial oracle unavailable: {_build_error}")
    return lib


def _host(a, dtype) -> np.ndarray:
    """``a`` (array or tensor, any device) as a C-contiguous host array
    of ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype)


def available() -> bool:
    """True when the oracle library built (g++ present)."""
    return _load() is not None


def serial_query(points, cells, neighbors, data, queries, guesses=None,
                 max_steps=10_000, cell_type=None):
    """Serial reference-algorithm query pass.

    Args mirror the grid arrays (numpy arrays or tensors, any float
    dtype — widened to float64).  ``cell_type`` disambiguates 4-vertex
    cells: pass ``"quad"`` for planar quads (default: tetra when
    npc == 4).  Without ``guesses`` each query is seeded by the cell of
    its nearest mesh point (a brute-force search over every point);
    ``guesses[i] >= 0`` starts the walk from that cell's centroid.
    Returns host arrays ``(vals (n_q,), i_cell (n_q,), found (n_q,))``.
    """
    lib = _lib_or_raise()
    points = _host(points, np.float64)
    cells = _host(cells, np.int32)
    neighbors = _host(neighbors, np.int32)
    data = _host(data, np.float64)
    queries = _host(queries, np.float64)
    n_q = queries.shape[0]
    npc = cells.shape[1]
    vals = np.empty(n_q, np.float64)
    ic = np.empty(n_q, np.int32)
    found = np.empty(n_q, np.uint8)
    gptr = None
    if guesses is not None:
        guesses = _host(guesses, np.int32)
        gptr = guesses.ctypes.data_as(ctypes.c_void_p)
    lib.iu_serial_query(
        npc, 1 if cell_type == "quad" else 0,
        points.shape[0], cells.shape[0],
        points, cells, neighbors, data,
        n_q, queries, gptr, max_steps,
        vals, ic, found,
    )
    return vals, ic, found.astype(bool)


def serial_trace(points, cells, neighbors, field, y0, *, nvar=0,
                 min_dx, max_dx, max_steps, rtol, atol, reverse=False,
                 axisymmetric=False, icell_mask=None, mask_value=-1,
                 max_iterations=None, cell_type=None):
    """Serial reference-algorithm field-line trace
    (iu_integrate_along_field, m_interp_unstructured.f90:987-1217).

    Args mirror :func:`trace.integrate_along_field`: ``field`` is
    (n_points, ndim) vertex vector data, ``y0`` is
    (n_traj, ndim + nvar) seeds (extra variables integrate
    d(var)/ds = 1, the arc-length sub-integral of
    test_trace_field.f90:57-64), ``icell_mask`` an optional
    (n_cells,) int array restricting integration to
    ``mask == mask_value`` cells.

    Returns host arrays ``(y (n_traj, max_steps, ndim+nvar),
    y_field (n_traj, max_steps, ndim), n_steps (n_traj,),
    boundary_material (n_traj,))`` with the same conventions as
    ``TraceResult`` (n_steps == max_steps + 1 means the buffer filled;
    boundary -1 = physical boundary, else the mask value entered,
    -2 = not reached).
    """
    lib = _lib_or_raise()
    points = _host(points, np.float64)
    cells = _host(cells, np.int32)
    neighbors = _host(neighbors, np.int32)
    field = _host(field, np.float64)
    y0 = _host(y0, np.float64)
    ndim = field.shape[1]
    n_traj = y0.shape[0]
    d = ndim + nvar
    if y0.shape[1] != d:
        raise ValueError(f"y0 must have shape (B, {d})")
    if max_iterations is None:
        max_iterations = 50 * max_steps + 1000
    # component-major (ndim, n_points), matching the C side
    field_t = np.ascontiguousarray(field.T)
    out_y = np.empty((n_traj, max_steps, d), np.float64)
    out_yf = np.empty((n_traj, max_steps, ndim), np.float64)
    nsteps = np.empty(n_traj, np.int32)
    bm = np.empty(n_traj, np.int32)
    mptr = None
    if icell_mask is not None:
        icell_mask = _host(icell_mask, np.int32)
        mptr = icell_mask.ctypes.data_as(ctypes.c_void_p)
    lib.iu_serial_trace(
        cells.shape[1], 1 if cell_type == "quad" else 0,
        points.shape[0], cells.shape[0],
        points, cells, neighbors,
        ndim, field_t, nvar,
        float(min_dx), float(max_dx), int(max_steps),
        float(rtol), float(atol), int(bool(reverse)),
        int(bool(axisymmetric)), mptr, int(mask_value),
        n_traj, y0, int(max_iterations),
        out_y, out_yf, nsteps, bm,
    )
    return out_y, out_yf, nsteps, bm
