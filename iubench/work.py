"""The least work of a batch of point queries, and the least time the card
could answer it in: what ``query_roofline`` divides by.

The work is counted from the traffic and the mesh, never from a table of
the system under test, so it reads the same whatever implements it.

Bytes, each moved once:

* per query: its 3 coordinates read (grid dtype), its guess read where
  it has one (4 B), and its answer written: one value per variable
  (grid dtype), a cell id (4 B) and a found flag (1 B);
* per distinct cell that holds an answer: its connectivity read
  (4 B a vertex);
* per distinct vertex of those cells: its 3 coordinates and its value
  of every variable read (grid dtype).

Operations, per query, for the one cell of the mesh's type that holds
it (a fused multiply-add counts 2):

* tetra: the containment test takes the signed distance to each of 4
  face planes, ``c_k - n_k . q`` (3 multiplies, 3 adds: 6), so 24; the
  4 barycentric weights are those distances times the inverse heights
  (4); each variable is ``sum_k w_k f_k`` (4 multiplies, 3 adds: 7);
  in all ``28 + 7 V``;
* triangle: 3 edge lines in 2D, ``c_k - n_k . q`` (2 + 2: 4), so 12;
  3 weights (3); each variable 3 + 2 = 5; in all ``15 + 5 V``.

Least time = max(bytes / 3.35 TB/s, operations / peak), the peak being
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor
cores: the published figures of one NVIDIA H100 SXM at its 700 W power
limit.  Quote a share of it with the card's power limit beside it
(``power_limit()``).
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}
ID_BYTES, FLAG_BYTES = 4, 1


def query_ops(cell_type: str, n_vars: int) -> int:
    """Operations of one query (see the module docstring)."""
    if cell_type == "tetra":
        return 28 + 7 * n_vars
    if cell_type == "triangle":
        return 15 + 5 * n_vars
    raise ValueError(f"no operation count for {cell_type!r} cells yet")


def query_bytes(dtype: str, n_queries: int, n_vars: int, guess: bool,
                n_cells: int, npc: int, n_points: int) -> int:
    """Bytes of a batch whose answers lie in ``n_cells`` distinct cells
    with ``n_points`` distinct vertices."""
    s = ITEMSIZE[dtype]
    per_query = 3 * s + (ID_BYTES if guess else 0) + n_vars * s \
        + ID_BYTES + FLAG_BYTES
    return (n_queries * per_query + n_cells * npc * ID_BYTES
            + n_points * (3 + n_vars) * s)


def least_time(dtype: str, n_bytes: int, n_ops: int) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def query_work(cell, found_cells, *, n_queries: int, n_vars: int,
               guess: bool) -> dict:
    """The work of one call whose found answers lie in ``found_cells``,
    counted on the benchmark's own mesh arrays."""
    cfg = cell.spec.config
    dtype = cfg["dtype"]
    conn = torch.as_tensor(cell.cells, device=found_cells.device)
    distinct = torch.unique(found_cells.long())
    n_points = int(torch.unique(conn[distinct]).numel())
    n_bytes = query_bytes(dtype, n_queries, n_vars, guess,
                          int(distinct.numel()), conn.shape[1], n_points)
    n_ops = n_queries * query_ops(cfg["cell_type"], n_vars)
    t, by = least_time(dtype, n_bytes, n_ops)
    return {"bytes": n_bytes, "ops": n_ops, "least_s": t, "bound_by": by,
            "distinct_cells": int(distinct.numel()),
            "distinct_points": n_points}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
