"""The bin order of a walk grid's large batches (``csrc/order.cu``).

``interpolate_at`` on a grid without candidate tables runs get_cell's
walk (kernel B3) and the known-cell interpolation (kernel E1).  Given a
large batch in random order, both read their rows as random sectors
from device memory; in bin order the queries of a region are adjacent
and the rows come from device memory about once a call.  So a large
batch (:func:`engages`) is taken in bin order:

1. :func:`order`: each query's key bin, a coarse bin of the grid's seed
   bins (:func:`key_shift`), and its rank there (the key pass); the scan
   of the counts; the scatter of each query and its start cell to its
   place in bin order, ``slot`` (the kernels move tiles of queries as
   runs: ``csrc/order.cu``);
2. B3 and E1, unchanged, on the ordered batch (``ops/interp.py``);
3. :func:`unsort`: i_cell, found and the values back in query order.

Each query's walk and interpolation read nothing of the other queries,
so the outputs are the unordered route's bit for bit, whatever order the
atomics give the queries of a bin.  On CUDA tensors the kernels run, on
CPU tensors the plain versions (:func:`order_plain`, with
:func:`order_keys_plain`, and :func:`unsort_plain`).  ``key_launches``,
``scatter_launches`` and ``unsort_launches`` count the kernels'
launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels, geometry

key_launches = 0
scatter_launches = 0
unsort_launches = 0

# The engage rule (tools/warm_order_sweep.py, H100, 50 MiB of L2; PERF.md
# §6): a tet grid whose walk rows (512 bytes a cell) fill at least
# MIN_L2_TIMES times the card's L2, a batch of at least MIN_PER_CELL
# queries a cell, and a batch whose queries, a walk row each, would fill
# at least MIN_BATCH_L2_TIMES times the L2.  The order pays when the
# rows are read many times over from a table far larger than the L2: on
# tet boxes it won in float32 and float64, warm and cold, wherever the
# rule takes a batch (from 3 queries a cell with rows of 9.8 L2, from 4
# at 7.3 L2, at 10 at 5.7 and 4.0 L2).  Below the rule it lost or broke
# even in some of the four (float32 warm at 3 a cell and 7.3 L2, float64
# warm at 4 a cell and 4.0 L2, everything up to 4 a cell at 2.7 L2).  On
# triangles and quads it lost or broke even on cold batches up to 4
# queries a cell at 9.8 L2, and lost triangles' batches at 5.9 L2 even at
# 10 a cell, so planar grids keep the unordered route.
MIN_L2_TIMES = 4
MIN_PER_CELL = 3
MIN_BATCH_L2_TIMES = 28
# Queries a tile of the kernels (csrc/order.cu kTile), and the most key
# bins they count (kMaxKeys)
TILE = 2048
MAX_KEYS = 1024
# The key grid: the fewest halvings of the seed grid along each axis that
# leave at most TILE // KEY_RUN key bins, so that a tile's queries of a
# key bin make runs of KEY_RUN on average (the same sweep: 125 key bins
# won at every batch it engages, over 1000, whose runs are 2 long, and
# 27, whose regions are too coarse for E1).
KEY_RUN = 16

_KEY_ENTRY = {torch.float32: "iu_order_key", torch.float64: "iu_order_key_f64"}
_SCATTER_ENTRY = {torch.float32: "iu_order_scatter",
                  torch.float64: "iu_order_scatter_f64"}


def engages(n_queries: int, n_cells: int, row_bytes: int, l2_bytes: int,
            cell_type: str) -> bool:
    """Whether a batch of ``n_queries`` on a walk grid of ``n_cells``
    cells of ``cell_type``, whose walk rows take ``row_bytes`` bytes, is
    taken in bin order on a card with ``l2_bytes`` bytes of L2."""
    return (cell_type == "tetra"
            and row_bytes >= MIN_L2_TIMES * l2_bytes
            and n_queries >= MIN_PER_CELL * n_cells
            and n_queries * row_bytes
            >= MIN_BATCH_L2_TIMES * l2_bytes * n_cells)


def l2_bytes(device) -> int:
    """The L2 cache of a CUDA device, in bytes."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def key_shape(bin_shape, shift: int) -> tuple:
    """Key bins per axis: 2**shift seed bins a key bin along each axis."""
    return tuple(((n - 1) >> shift) + 1 for n in bin_shape)


def n_keys(bin_shape, shift: int) -> int:
    """Key bins of the key grid."""
    out = 1
    for n in key_shape(bin_shape, shift):
        out *= n
    return out


def key_shift(bin_shape) -> int:
    """Halvings of the seed grid that make the key grid: the fewest that
    leave at most TILE // KEY_RUN key bins."""
    shift = 0
    while n_keys(bin_shape, shift) > TILE // KEY_RUN:
        shift += 1
    return shift


def order_keys_plain(r, rmin, inv_h, bin_shape, shift):
    """Plain version of the key: each query's flat key bin (B,) int64, its
    seed bin (``geometry.bin_ijk``) with each coordinate shifted right by
    ``shift``."""
    ijk = geometry.bin_ijk(r, rmin, inv_h, bin_shape, torch.int64)
    return geometry.bin_flat([c >> shift for c in ijk],
                             key_shape(bin_shape, shift))


class Back(NamedTuple):
    """The way back from bin order: each query's position in the ordered
    batch (``slot``, (B,) int32), and its position among the slots of
    its tile of TILE queries (``pos``, (B,) int32), by which the unsort
    moves runs."""

    slot: torch.Tensor
    pos: torch.Tensor


def tile_positions(slot):
    """Each query's position among the slots of its tile of TILE
    consecutive queries, in ascending slot order: (B,) int32."""
    b = slot.shape[0]
    q = torch.arange(b, device=slot.device)
    tile = q // TILE
    by_tile = torch.argsort(tile * b + slot.long())
    pos = torch.empty_like(q)
    pos[by_tile] = q - tile[by_tile] * TILE
    return pos.to(torch.int32)


def order_plain(r, start, rmin, inv_h, bin_shape, shift):
    """Plain version of :func:`order`: the keys of
    :func:`order_keys_plain`, a stable sort of them, and the queries and
    start cells (None for none) taken in that order.  Returns (r_out,
    start_out, :class:`Back`)."""
    key = order_keys_plain(r, rmin, inv_h, bin_shape, shift)
    perm = torch.argsort(key, stable=True)
    slot = torch.empty_like(perm)
    slot[perm] = torch.arange(perm.shape[0], device=perm.device)
    return (r[perm], None if start is None else start[perm],
            Back(slot.to(torch.int32), tile_positions(slot)))


def order(grid, r, start=None):
    """The (B, 3) queries ``r`` (the grid's dtype and device) and their
    (B,) int32 start cells ``start`` (or None) in bin order: grouped by
    key bin, a bin of ``grid``'s seed bins halved :func:`key_shift` times
    along each axis, in ascending key order.  Returns
    (r_out, start_out, :class:`Back`).  In a key bin the kernels keep no
    fixed order, the plain version the query order."""
    global key_launches, scatter_launches
    b = r.shape[0]
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"queries must be (B, 3), got {tuple(r.shape)}")
    if start is not None and (start.dtype != torch.int32
                              or start.shape != (b,)):
        raise ValueError("start must be an int32 (B,) tensor or None")
    shift = key_shift(grid.bin_shape)
    rmin, inv_h, shape = grid.bin_rmin, grid.bin_inv_h, grid.bin_shape
    if r.device.type != "cuda":
        return order_plain(r, start, rmin, inv_h, shape, shift)
    if r.dtype not in _KEY_ENTRY or rmin.dtype != r.dtype:
        raise TypeError("the bin order takes float32 or float64 queries of "
                        "the seed grid's dtype")
    if not (r.device == rmin.device == inv_h.device
            and (start is None or start.device == r.device)):
        raise ValueError("queries, start cells and seed grid must share one "
                         "device")
    k = n_keys(shape, shift)
    if k > MAX_KEYS:
        raise ValueError(f"{k} key bins: the key pass counts at most "
                         f"{MAX_KEYS}")
    dev = r.device
    r, rmin, inv_h = r.contiguous(), rmin.contiguous(), inv_h.contiguous()
    counts = torch.zeros(k, dtype=torch.int32, device=dev)
    key, rank, pos, slot = (torch.empty(b, dtype=torch.int32, device=dev)
                            for _ in range(4))
    r_out = torch.empty_like(r)
    start_out = None
    if start is not None:
        start = start.contiguous()
        start_out = torch.empty_like(start)
    back = Back(slot, pos)
    if b == 0:
        return r_out, start_out, back

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        code = getattr(lib, _KEY_ENTRY[r.dtype])(
            r.data_ptr(), b, rmin.data_ptr(), inv_h.data_ptr(), *shape,
            shift, counts.data_ptr(), key.data_ptr(), rank.data_ptr(),
            pos.data_ptr(), stream)
        _kernels.check(code, _KEY_ENTRY[r.dtype])
        key_launches += 1
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        code = getattr(lib, _SCATTER_ENTRY[r.dtype])(
            r.data_ptr(), ptr(start), b, key.data_ptr(), rank.data_ptr(),
            pos.data_ptr(), counts.data_ptr(), ends.data_ptr(),
            r_out.data_ptr(), ptr(start_out), slot.data_ptr(), stream)
        _kernels.check(code, _SCATTER_ENTRY[r.dtype])
        scatter_launches += 1
    return r_out, start_out, back


def unsort_plain(back, ic, found, values):
    """Plain version of :func:`unsort`: each output indexed by
    ``back.slot``."""
    s = back.slot.long()
    return ic[s], found[s], values[s]


def unsort(back, ic, found, values):
    """(i_cell (B,) int32, found (B,) bool, values (B, V)) of the ordered
    batch back in query order: query q takes position ``back.slot[q]``
    (``back``: the :class:`Back` of :func:`order`)."""
    global unsort_launches
    slot, pos = back
    b = slot.shape[0]
    if (ic.shape != (b,) or found.shape != (b,) or values.ndim != 2
            or values.shape[0] != b or pos.shape != (b,)):
        raise ValueError("unsort takes (B,) i_cell and found and (B, V) "
                         "values")
    if slot.device.type != "cuda":
        return unsort_plain(back, ic, found, values)
    if (slot.dtype != torch.int32 or pos.dtype != torch.int32
            or ic.dtype != torch.int32 or found.dtype != torch.bool
            or values.element_size() % 4):
        raise TypeError("the unsort takes an int32 slot, pos and i_cell, a "
                        "bool found and values of 4 or 8 bytes")
    if len({t.device for t in (slot, pos, ic, found, values)}) != 1:
        raise ValueError("unsort inputs must share one device")
    slot, pos, ic = slot.contiguous(), pos.contiguous(), ic.contiguous()
    found, values = found.contiguous(), values.contiguous()
    ic_out, found_out = torch.empty_like(ic), torch.empty_like(found)
    vals_out = torch.empty_like(values)
    if b == 0:
        return ic_out, found_out, vals_out
    n_words = values.shape[1] * values.element_size() // 4
    with torch.cuda.device(slot.device):
        code = _kernels.lib().iu_order_unsort(
            slot.data_ptr(), pos.data_ptr(), b, ic.data_ptr(),
            found.data_ptr(), values.data_ptr(), n_words, ic_out.data_ptr(),
            found_out.data_ptr(), vals_out.data_ptr(),
            torch.cuda.current_stream(slot.device).cuda_stream)
    _kernels.check(code, "iu_order_unsort")
    unsort_launches += 1
    return ic_out, found_out, vals_out
