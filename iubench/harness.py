"""The benchmark's harness: one cell, one run.

Everything that belongs to one configuration, traffic mix, limit set or
metric sits in a file of its own that this module finds by name:

* ``BENCHMARK.json`` (repository root): the cell's configuration and
  traffic names and the metrics it reports;
* ``iubench/configs/<config>.json``: the mesh, the grid's dtype and
  build options, the point data;
* ``iubench/meshes/<generator>.py``: the generator that the
  configuration's ``mesh.generator`` names, which makes its points and
  cells (the contract is in ``iubench/mesh.py``);
* ``iubench/traffic/<traffic>.json``: the parameters of one traffic
  mix; its ``kind`` names the module ``iubench/kinds/<kind>.py`` that
  makes the inputs and calls the system;
* ``iubench/limits/<workload>.json``: the limit of each number that the
  comparison with the reference checks;
* ``iubench/metrics/<metric>.py``: one reader per metric, ``read(rec)``
  returning the value or None.

A run: set-up (the mesh and its data from the seed, ``build_grid``, the
kind's inputs and warm-up), then the window of ``seconds`` (or, with
``trace``, a profiled stretch and CUDA-event spans), then the check
against the plain reference once the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import random
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from . import fields, mesh

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "interpolate_unstructured_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
MIN_CALLS = 8  # a window makes at least this many calls


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the Python file ``path`` (its name may hold dots)."""
    name = "iubench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Spec:
    """Everything one cell's run reads, found by name."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    kind: Any  # the module of the traffic's kind
    end_to_end: list
    per_layer: list
    base: Path = HERE  # the benchmark's folder the files came from

    @property
    def name(self) -> str:
        return self.workload["name"]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_spec(workload: str, root: Path = ROOT) -> Spec:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files
    under ``<root>/iubench``."""
    bench = load_json(root / "BENCHMARK.json")
    base = root / "iubench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "limits" / f"{workload}.json")
    kind = load_module(base / "kinds" / f"{traffic['kind']}.py")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Spec(w, cfg, traffic, limits, kind, e2e, layer, base)


@dataclass
class Cell:
    """What a kind module gets: the cell's files, the inputs made from the
    seed, the port's module and its grid."""

    spec: Spec
    seed: int
    device: torch.device
    tiu: Any
    points: Any = None  # (P, 3) float64 numpy
    cells: Any = None  # (C, nv) int64 numpy
    neighbors: Any = None  # (C, nv) int32 numpy
    data: dict = field(default_factory=dict)  # name -> (P,) float64
    grid: Any = None
    build: dict = field(default_factory=dict)
    tracing: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.spec.config["dtype"]]

    @property
    def traffic(self) -> dict:
        return self.spec.traffic

    def mark(self, name: str):
        """A profiler range around the kind module's code when tracing."""
        if self.tracing:
            return torch.profiler.record_function(f"iubench.{name}")
        return contextlib.nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def generator(spec: Spec):
    """The module ``meshes/<generator>.py`` of the configuration's mesh,
    checked against the configuration's cell type."""
    cfg = spec.config
    name = cfg["mesh"]["generator"]
    path = spec.base / "meshes" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown mesh generator {name!r}")
    gen = load_module(path)
    if gen.CELL_TYPE != cfg["cell_type"]:
        raise ValueError(f"mesh generator {name!r} makes {gen.CELL_TYPE} "
                         f"cells, the configuration {cfg['cell_type']}")
    return gen


def make_mesh(cell: Cell) -> None:
    """The configuration's mesh and point data, made from the seed."""
    cfg = cell.spec.config
    cell.points, cell.cells = generator(cell.spec).make(cfg["mesh"])
    cell.neighbors = mesh.face_neighbors(cell.cells, cfg["cell_type"],
                                         cell.device)
    cell.data = {name: fields.smooth_field(cell.points, cell.seed, name)
                 for name in cell.spec.config["point_data"]}


def build(cell: Cell) -> None:
    """``build_grid`` of the configuration, timed to its last kernel."""
    cfg = cell.spec.config
    tiu = cell.tiu
    timings: dict = {}
    cell.sync()
    t0 = time.perf_counter()
    cell.grid = tiu.build_grid(
        cell.points, cell.cells, cell.neighbors, cfg["cell_type"],
        point_data=dict(cell.data), dtype=cell.dtype,
        config=tiu.IUConfig(**cfg["build"]), device=cell.device,
        timings=timings)
    cell.sync()
    cell.build = {"build_grid_s": time.perf_counter() - t0, **timings}


class Reservoir:
    """Which calls' answers are checked: the last call offered, and a
    uniform sample of ``size - 1`` of the others drawn from the seed
    (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.n, self.sample, self.last = size - 1, 0, [], None
        self.rng = random.Random(fields.child_seed(seed, "reservoir"))

    def offer(self, item) -> None:
        if self.last is not None:
            self.n += 1
            if len(self.sample) < self.size:
                self.sample.append(self.last)
            else:
                j = self.rng.randrange(self.n)
                if j < self.size:
                    self.sample[j] = self.last
        self.last = item

    @property
    def items(self) -> list:
        return self.sample + ([] if self.last is None else [self.last])

    def clear(self) -> None:
        self.sample, self.last = [], None


@dataclass
class Record:
    """What the metric readers read."""

    unit: str  # what one call answers: "queries" or "lines"
    units_per_call: int
    dtype: str
    setup_s: float
    build: dict
    phases: dict = field(default_factory=dict)  # set-up's marks, seconds
    calls: int = 0
    window_s: float = 0.0
    call_ms: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    profile: dict | None = None
    work: dict | None = None
    judge_s: float = 0.0  # the check against the reference, after the window


def window(cell: Cell, state, seconds: float, keep: Reservoir, rec: Record):
    """Closed loop: calls one after another, each ended by a synchronize,
    until ``seconds`` have passed (and MIN_CALLS made); each call timed
    by CUDA events from its issue to its last device operation."""
    kind = cell.spec.kind
    on_card = cell.device.type == "cuda"
    events = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        item = kind.call(cell, state)
        if on_card:
            e1.record()
            torch.cuda.synchronize()
            events.append((e0, e1))
        keep.offer(item)
        rec.calls += 1
        if rec.calls >= MIN_CALLS and time.perf_counter() >= deadline:
            break
    rec.window_s = time.perf_counter() - t0
    rec.call_ms = [a.elapsed_time(b) for a, b in events]


def traced(cell: Cell, state, keep: Reservoir, rec: Record):
    """The profiled stretch (``trace_calls`` calls), then CUDA-event spans
    of the kind's layers, then the work of the last call."""
    kind = cell.spec.kind
    n = int(cell.traffic["trace_calls"])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    cell.tracing = True
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            with cell.mark("window"):
                for _ in range(n):
                    item = kind.call(cell, state)
                    cell.sync()
                    keep.offer(item)
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        from . import devtrace

        rec.profile = devtrace.read(path)
    cell.tracing = False
    rec.calls = n
    rec.spans = kind.spans(cell, state, int(cell.traffic.get("span_calls", 0)))
    rec.work = kind.work(cell, state, item)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def clean(x):
    """A JSON-safe number: None for NaN or infinity."""
    x = float(x)
    return x if math.isfinite(x) else None


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device,
             t_start: float, tiu, control=None, marks=None) -> dict:
    """One run of the cell; returns the result's fields and the checks.

    ``control``: a dtype (or True: the precision below the
    configuration's) in which the reference is also put in the program's
    place; its checks are returned as ``control_checks``.  ``marks``:
    the caller's set-up marks (seconds since ``t_start``), kept with the
    harness's own in the record."""
    device = torch.device(device)
    cell = Cell(spec, seed, device, tiu)
    phases = dict(marks or {}, start_s=time.perf_counter() - t_start)
    make_mesh(cell)
    phases["mesh_s"] = time.perf_counter() - t_start
    build(cell)
    phases["build_s"] = time.perf_counter() - t_start
    kind = spec.kind
    state = kind.setup(cell)
    cell.sync()
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    rec = Record(unit=kind.UNIT, units_per_call=kind.units(cell, state),
                 dtype=spec.config["dtype"], setup_s=setup_s,
                 build=cell.build, phases=phases)
    keep = Reservoir(int(spec.traffic["check_calls"]), seed)
    if trace:
        traced(cell, state, keep, rec)
    else:
        window(cell, state, seconds, keep, rec)
    gc.unfreeze()
    # the process's peak so far: set-up and window, before the reference
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # the program's state goes before the reference runs
    answers = [kind.answers(cell, state, item) for item in keep.items]
    keep.clear()
    cell.grid = state = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = kind.judge(cell, answers)
    rec.judge_s = time.perf_counter() - t_judge
    control_checks = None
    if control is not None:
        control_checks = kind.judge(cell, kind.control(
            cell, answers, None if control is True else control))
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        reader = load_module(spec.base / "metrics" / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {
        "correct": correct,
        "attempted": rec.calls,
        "failed": 0,
        "metrics": metrics,
        "memory_peak_bytes": int(peak),
        "record": rec,
        "checks": checks,
        "control_checks": control_checks,
    }
    return out


def check(value, limit) -> dict:
    return {"value": clean(value), "limit": float(limit)}
