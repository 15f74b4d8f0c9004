"""Multi-device scaling: query batches split across devices, the grid
replicated on each.

The port of the JAX package's ``parallel/sharding.py`` onto
``torch.distributed``, with its names and contracts.  Torch has no
``shard_map``, so:

* a mesh is this process's list of devices (:func:`make_mesh`); an entry
  may repeat a device;
* :func:`replicate_grid` puts one copy of the grid on each distinct
  device of the mesh;
* a batch is split into one shard per mesh entry (:class:`Sharded`), and
  each ``sharded_*`` function runs the port's single-device entry point
  on each shard, on its entry's device, against the grid's copy there.

The hot path has no collectives.  Only :func:`distribute_queries` (the
shard size), :func:`collect_results` (the results) and
:func:`sharded_trace` (its ``n_rounds`` total, as the JAX package's
``psum``) communicate, over the default process group when one is
initialized: with NCCL the buffers lie on the rank's current CUDA
device, with gloo on the CPU.  The caller initializes the group and sets
the rank's device (``torch.distributed.init_process_group``,
``torch.cuda.set_device``), as a JAX user calls
``jax.distributed.initialize``.

The shards of one process run one after another: the entry points read
some results on the host (``torch.nonzero`` of the extension-row
queries and of the warm misses), so a shard's call returns only once
its device has answered.  Ranks, one a device, overlap.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import trace as trace_mod
from ..ops import interp, interp_acc, locate


class Sharded(NamedTuple):
    """A batch split across a mesh: ``shards[i]`` lies on mesh entry i's
    device, in mesh order; ``shape`` is the global padded shape, which
    counts the shards of every rank."""

    shards: tuple
    shape: tuple


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _mesh(devices) -> list:
    mesh = [_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def make_mesh(devices=None) -> list:
    """This process's devices, in order: the given ones (a device may
    repeat, giving it several shards), else every visible CUDA device,
    or the rank's current CUDA device in a process that has initialized
    ``torch.distributed``.  Without a CUDA device the default raises."""
    if devices is not None:
        return _mesh(devices)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() takes the CUDA devices and there is none; pass "
            "devices= (e.g. ['cpu'] * 8) for another mesh")
    if _distributed():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def replicate_grid(grid, mesh) -> dict:
    """One copy of ``grid`` on each distinct device of the mesh
    ({device: grid}; the grid itself on its own device)."""
    return {d: grid.to(d) for d in dict.fromkeys(_mesh(mesh))}


def _grid_on(grid, dev):
    if isinstance(grid, dict):
        if dev not in grid:
            raise ValueError(f"the grid is not replicated on {dev}")
        return grid[dev]
    return grid.to(dev)


def _split(x: torch.Tensor, mesh) -> Sharded:
    """Rows of ``x`` (a multiple of the mesh size) in equal shards, each
    moved to its entry's device."""
    per = x.shape[0] // len(mesh)
    return Sharded(
        tuple(x[i * per:(i + 1) * per].to(d) for i, d in enumerate(mesh)),
        tuple(x.shape))


def shard_batch(x, mesh):
    """Split the leading (batch) axis over the mesh, padding with the
    last row to a multiple of the mesh size.  Returns (sharded_x,
    original_b)."""
    mesh = _mesh(mesh)
    x = torch.as_tensor(x)
    b = x.shape[0]
    pad = (-b) % len(mesh)
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return _split(x, mesh), b


def _as_sharded(x, mesh):
    """A Sharded batch of this mesh as it is; a tensor or array split
    evenly over it; None as None."""
    if x is None:
        return None
    if isinstance(x, Sharded):
        if len(x.shards) != len(mesh):
            raise ValueError(f"{len(x.shards)} shards for a mesh of "
                             f"{len(mesh)} entries")
        return x
    x = torch.as_tensor(x)
    if x.shape[0] % len(mesh):
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                         f"{len(mesh)} devices; pad it with shard_batch")
    return _split(x, mesh)


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else (
        contextlib.nullcontext())


def _per_shard(mesh, fn, grid, *batches):
    """[fn(the grid's copy, shard i of each batch) for each mesh entry i],
    each run on its entry's device.  None batches stay None."""
    outs = []
    for i, dev in enumerate(mesh):
        with _on(dev):
            outs.append(fn(_grid_on(grid, dev), *(
                None if b is None else b.shards[i] for b in batches)))
    return outs


def _assemble(outs, rows):
    """Per-shard output tuples as a tuple of Sharded batches of ``rows``
    global rows."""
    return tuple(
        Sharded(tuple(o[k] for o in outs), (rows, *outs[0][k].shape[1:]))
        for k in range(len(outs[0])))


def _batched(mesh, fn, grid, r, *batches):
    mesh = _mesh(mesh)
    r = _as_sharded(r, mesh)
    outs = _per_shard(mesh, fn, grid, r,
                      *(_as_sharded(b, mesh) for b in batches))
    return _assemble(outs, r.shape[0])


def sharded_interpolate_at(mesh):
    """``f(grid, r, i_vars, guess=None) -> (values, i_cell, found)``, each
    a Sharded batch: ``interpolate_at`` on each shard against the grid's
    copy on its device.

    ``i_vars`` is read as Python ints (the JAX package captures it
    statically), so a cold call whose variables are fused into the
    candidate rows takes the fused probe.  Omit ``guess`` on cold
    batches; pass the previous cells (a Sharded result) to warm-start.
    """

    def run(grid, r, i_vars, guess=None):
        iv = list(interp._static_slots(i_vars))
        return _batched(mesh, lambda g, rs, gs: interp.interpolate_at(
            g, rs, iv, gs), grid, r, guess)

    return run


def sharded_interpolate_at_acc(mesh):
    """Sharded accurate mode: ``f(grid, r, i_vars) -> (vals_hi, vals_lo,
    found, i_cell)`` from ``interpolate_at_acc`` on each shard, the grid
    (its ``acc_table`` and df-plane rows from ``prepare_accurate``
    included) replicated; ``i_vars`` read as in
    :func:`sharded_interpolate_at`."""

    def run(grid, r, i_vars):
        iv = interp._static_slots(i_vars)
        return _batched(mesh, lambda g, rs: interp_acc.interpolate_at_acc(
            g, rs, iv), grid, r)

    return run


def sharded_get_cell(mesh):
    """Sharded point location: ``f(grid, r, guess) -> (i_cell, found)``."""

    def run(grid, r, guess=None):
        return _batched(mesh, locate.get_cell, grid, r, guess)

    return run


def sharded_get_cell_scalar_at(mesh):
    """Sharded piecewise-constant cell-data lookup (iu_get_cell_scalar_at,
    m_interp_unstructured.f90:436-448): ``f(grid, r, i_var, guess=None)
    -> (vals, i_cell, found)``; ``i_var`` read as a Python int."""
    return _sharded_cell_lookup(mesh, interp.get_cell_scalar_at)


def sharded_get_icell_scalar_at(mesh):
    """Sharded integer cell-data lookup (iu_get_icell_scalar_at,
    m_interp_unstructured.f90:450-462); see
    :func:`sharded_get_cell_scalar_at`."""
    return _sharded_cell_lookup(mesh, interp.get_icell_scalar_at)


def _sharded_cell_lookup(mesh, lookup_fn):
    def run(grid, r, i_var, guess=None):
        iv = int(i_var)
        return _batched(mesh, lambda g, rs, gs: lookup_fn(g, rs, iv, gs),
                        grid, r, guess)

    return run


def sharded_trace(mesh, **trace_kwargs):
    """Sharded field-line tracing over a batch of seed states.

    Returns ``f(grid, y0, i_field, trace_table=None) -> TraceResult``
    whose batch fields are Sharded; each shard's lines run to their own
    end.  The trace table is built once (or taken as given) and copied
    to each distinct device of the mesh, like the grid.  ``n_rounds`` is
    the total over the shards and, as the JAX package's ``psum``, over
    the ranks.  Padding repeats a whole line, whose rounds count too.
    """

    def run(grid, y0, i_field, trace_table=None):
        mesh_ = _mesh(mesh)
        i_field = interp._static_slots(i_field)
        if trace_table is None:
            trace_table = trace_mod.build_trace_table(
                _grid_on(grid, mesh_[0]), i_field)
        tables = {d: trace_table.to(d) for d in dict.fromkeys(mesh_)}
        y0 = _as_sharded(y0, mesh_)
        outs = _per_shard(mesh_, lambda g, ys: trace_mod.integrate_along_field(
            g, ys, i_field, trace_table=tables[g.device], **trace_kwargs),
            grid, y0)
        n_rounds = torch.stack([o.n_rounds.to(mesh_[0]) for o in outs]).sum(
            dtype=torch.int32)
        if _distributed():
            total = n_rounds.to(_comm_device())
            dist.all_reduce(total)
            n_rounds = total.to(mesh_[0])
        return trace_mod.TraceResult(
            *_assemble([o[:-1] for o in outs], y0.shape[0]), n_rounds)

    return run


# ---------------------------------------------------------------------------
# Multi-process input and output: the only communication
# ---------------------------------------------------------------------------


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _comm_device() -> torch.device:
    """Where collective buffers live: the rank's CUDA device under NCCL,
    else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_ints(values) -> list:
    """Every rank's list of ints, in rank order."""
    t = torch.tensor(values, dtype=torch.int64, device=_comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).tolist()


def distribute_queries(r_local, mesh):
    """Split this process's query block over its mesh, as one part of a
    global batch whose shards lie on every rank's devices.

    Ranks may contribute unequal counts, none included.  The per-device
    size is agreed on across ranks (an allgather of each rank's ceiling),
    so every shard on every rank has the same size; a block is padded by
    repeating its last row, or with zeros where the rank contributes
    nothing.  The global shape counts every rank's devices.  In a single
    process this is :func:`shard_batch` (a shard of one row at least).

    Returns ``(r_sharded, local_b)``, ``local_b`` this rank's unpadded
    count, for :func:`collect_results`.
    """
    mesh = _mesh(mesh)
    r_local = torch.as_tensor(r_local)
    b_local = r_local.shape[0]
    per_device = -(-b_local // len(mesh)) if b_local else 1
    n_devices = len(mesh)
    if _distributed():
        sizes = _allgather_ints([per_device, len(mesh)])
        per_device = max(s[0] for s in sizes)
        n_devices = sum(s[1] for s in sizes)
    pad = per_device * len(mesh) - b_local
    if pad:
        filler = (r_local[-1:].expand(pad, *r_local.shape[1:]) if b_local
                  else r_local.new_zeros((pad, *r_local.shape[1:])))
        r_local = torch.cat([r_local, filler])
    sharded = _split(r_local, mesh)
    return Sharded(sharded.shards,
                   (per_device * n_devices, *r_local.shape[1:])), b_local


def collect_results(x, local_b: int | None = None):
    """A sharded result as one host (numpy) array on every rank.

    Single process: the shards in order, trimmed to ``local_b``.  Across
    ranks, whose blocks may differ in size, an equal-shape protocol:
    allgather each rank's (padded, valid) sizes, copy the local block
    into a zero buffer of the largest size, allgather the buffers, then
    trim each rank's block to its valid rows and concatenate them in
    rank order.  Takes ``TraceResult`` fields too.
    """
    shards = x.shards if isinstance(x, Sharded) else (torch.as_tensor(x),)
    if not _distributed():
        out = torch.cat([s.cpu() for s in shards]).numpy()
        return out if local_b is None else out[:local_b]
    dev = _comm_device()
    local = torch.cat([s.to(dev) for s in shards])
    is_bool = local.dtype == torch.bool
    if is_bool:  # not every backend gathers bool
        local = local.view(torch.uint8)
    padded = local.shape[0]
    sizes = _allgather_ints([padded, padded if local_b is None else local_b])
    buf = local.new_zeros((max(s[0] for s in sizes), *local.shape[1:]))
    buf[:padded] = local
    gathered = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(gathered, buf)
    out = torch.cat([g[:valid] for g, (_, valid) in zip(gathered, sizes)]).cpu()
    return (out.view(torch.bool) if is_bool else out).numpy()
