"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library
with a plain C interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         --fmad=false -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

The library lands in ``build/kernels/`` at the repository root (the
directory ``utils.cache.enable_compile_cache`` sets), named by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads at once.  ``--fmad=false`` keeps the kernels'
rounding order equal to their plain PyTorch versions'.  The kernels of
B1, B2, B3 and E1 have a second entry point each for float64 grids
(``*_f64``), whose scalars are passed as C doubles.  The build runs
on first use, never at import; a failed build raises with nvcc's
output.  ``nvcc -Xptxas -v`` output (registers, shared memory, spills)
is kept beside the library as ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils import cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double  # the scalars of a float64 grid's entry points
_IP = ctypes.POINTER(ctypes.c_int)  # a host int array
_DP = ctypes.POINTER(ctypes.c_double)  # a host double array
# name -> (restype, argtypes) of every C entry point
_SIGNATURES = {
    "iu_interp_bruteforce": (
        _I,
        [_P, _P, _P, _P, _P, _P, _I, _IP, _I, _P, _I, _I, _I, _F, _P, _I, _P,
         _P, _I, _I, _P],
    ),
    "iu_interp_bruteforce_f64": (
        _I,
        [_P, _P, _P, _P, _P, _P, _I, _IP, _I, _P, _I, _I, _I, _D, _P, _I, _P,
         _P, _I, _I, _P],
    ),
    "iu_interp_acc": (
        _I, [_P, _I, _P, _P, _P, _I, _I, _I, _IP, _I, _P, _P, _I, _I, _P],
    ),
    "iu_walk": (
        _I,
        [_P, _I, _I, _I, _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _P, _P,
         _P, _P, _P],
    ),
    "iu_walk_f64": (
        _I,
        [_P, _I, _I, _I, _P, _P, _P, _P, _I, _D, _D, _D, _D, _I, _I, _P, _P,
         _P, _P, _P],
    ),
    "iu_get_cell_walk": (
        _I,
        [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
         _F, _I, _I, _P, _P, _P],
    ),
    "iu_get_cell_walk_f64": (
        _I,
        [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D,
         _D, _I, _I, _P, _P, _P],
    ),
    "iu_cand_bin_pass": (
        _I, [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    ),
    "iu_cand_bin_pass_f64": (
        _I, [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    ),
    "iu_cand_bin_scatter": (_I, [_P, _P, _P, _I, _P, _P, _P]),
    "iu_cand_rows_binned": (
        _I,
        [_P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _I, _F, _I, _F, _I, _P, _P, _I, _I, _I, _P, _P],
    ),
    "iu_cand_rows_binned_f64": (
        _I,
        [_P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _D,
         _I, _I, _P, _P, _I, _I, _I, _P, _P],
    ),
    "iu_cand_bin_unsort": (_I, [_P, _P, _I, _I, _P, _P, _P, _P]),
    "iu_trace_loop": (
        _I,
        [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _I,
         _F, _I, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P,
         _P, _P],
    ),
    "iu_cand_bin": (
        _I, [_P, _P, _P, _P, _I, _I, _I, _IP, _I, _I, _DP, _I, _I, _P, _P,
             _P],
    ),
    "iu_cand_order": (
        _I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    ),
    "iu_interp_icell": (
        _I, [_P, _P, _P, _I, _I, _P, _I, _IP, _I, _P, _P, _I, _P, _I, _P],
    ),
    "iu_interp_icell_f64": (
        _I, [_P, _P, _P, _I, _I, _P, _I, _IP, _I, _P, _P, _I, _P, _I, _P],
    ),
    "iu_error_string": (ctypes.c_char_p, [_I]),
}

_lib = None
_lock = threading.Lock()

# Most variable columns one launch of B1 or B5 takes, passed by value
# (csrc/var_slots.cuh kMaxVarSlots); the wrappers launch once for each
# group of this many.
MAX_VAR_SLOTS = 64


def var_slot_groups(slots):
    """``slots`` in groups of at most MAX_VAR_SLOTS as (first column of
    the group in the output, host int array, count); one empty group
    for no slots."""
    slots = list(slots)
    return [
        (g, (ctypes.c_int * max(len(part), 1))(*part), len(part))
        for g in range(0, max(len(slots), 1), MAX_VAR_SLOTS)
        for part in [slots[g: g + MAX_VAR_SLOTS]]
    ]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """The directory the kernel library builds into."""
    return cache.build_dir("kernels")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libiu_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    tmp = out.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_name(out.name + ".log").write_text("".join(logs))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.restype = res
                fn.argtypes = args
            _lib = dll
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().iu_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
