"""The harness finds each cell's files by name, and a cell, a traffic mix
and a metric added as new files (nothing that exists edited) run."""

import json
import shutil
import time

import pytest
import torch

from conftest import ROOT, shrink
from iubench import harness
from iubench.kinds import particles

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_files(workload):
    spec = harness.find_spec(workload)
    assert spec.config["name"] == spec.workload["config"]
    assert spec.kind.UNIT in ("queries", "lines")
    assert any(m["name"] == "setup_s" for m in spec.end_to_end)
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert (ROOT / "iubench" / "metrics" / f"{m['name']}.py").is_file()


def test_benchmark_json_names_and_files():
    assert BENCH["paths"] == ["iubench"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A copy of the benchmark gains a traffic mix, its limits, a metric
    reader and a BENCHMARK.json entry: no file of ``iubench/`` is
    edited, and the new cell runs."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "iubench", root / "iubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "iubench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = dict(json.loads((root / "iubench" / "traffic" /
                           "cold_10m.json").read_text()))
    mix.update(low=0.25, high=0.75)
    (root / "iubench" / "traffic" / "cold_mid.json").write_text(
        json.dumps(mix))
    (root / "iubench" / "limits" / "tet998k_f32.cold_mid.json").write_text(
        (root / "iubench" / "limits" / "tet998k_f32.cold.json").read_text())
    (root / "iubench" / "metrics" / "calls_seen.py").write_text(
        "def read(rec):\n    return rec.calls\n")
    bench["workloads"].append({"name": "tet998k_f32.cold_mid",
                               "config": "tet998k_f32",
                               "traffic": "cold_mid", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tet998k_f32.cold_mid"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    spec = shrink(harness.find_spec("tet998k_f32.cold_mid", root=root))
    assert spec.traffic["low"] == 0.25
    import interpolate_unstructured_tpu_torch as tiu

    out = run(spec, tiu)
    assert out["correct"], out["checks"]
    assert out["metrics"]["calls_seen"]["value"] == out["attempted"]


TRI_SQUARE = '''"""Mesh generator tri_square: [0, 1]^2 in n x n squares, each cut
into two triangles along its diagonal, in the plane z = 0."""

import numpy as np

CELL_TYPE = "triangle"
SMALL = {"squares_per_side": 12}


def make(params):
    n = int(params["squares_per_side"])
    g = np.linspace(0.0, 1.0, n + 1)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    b = (i.ravel() * (n + 1) + j.ravel()).astype(np.int64)
    cells = np.concatenate([np.stack([b, b + n + 1, b + n + 2], 1),
                            np.stack([b, b + n + 2, b + 1], 1)])
    return points, cells
'''


def test_a_cell_on_a_new_mesh_added_as_new_files_runs(tmp_path):
    """A copy of the benchmark gains a triangle mesh generator, a
    configuration that names it, its limits and a cell on the existing
    ``cold_10m`` traffic: no file of ``iubench/`` is edited, the cell
    runs correct on the CPU, and the control does not."""
    root = tmp_path / "checkout"
    bench_dir = root / "iubench"
    shutil.copytree(ROOT / "iubench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench_dir / "meshes" / "tri_square.py").write_text(TRI_SQUARE)
    config = {"name": "tri_square_f32", "cell_type": "triangle",
              "mesh": {"generator": "tri_square", "squares_per_side": 700},
              "dtype": "float32", "build": {}, "point_data": ["phi"]}
    (bench_dir / "configs" / "tri_square_f32.json").write_text(
        json.dumps(config))
    (bench_dir / "limits" / "tri_square_f32.cold.json").write_text(
        (bench_dir / "limits" / "tet998k_f32.cold.json").read_text())
    bench["configs"].append({"name": "tri_square_f32", "source": "a test",
                             "file": "iubench/configs/tri_square_f32.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": "tri_square_f32.cold",
                               "config": "tri_square_f32",
                               "traffic": "cold_10m", "chips": 1,
                               "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    spec = shrink(harness.find_spec("tri_square_f32.cold", root=root))
    assert spec.config["mesh"]["squares_per_side"] == 12
    import interpolate_unstructured_tpu_torch as tiu

    out = run(spec, tiu, control=True)
    assert out["correct"], out["checks"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in out["control_checks"].values()), \
        out["control_checks"]


def run(spec, tiu, seed=5, trace=False, seconds=0.2, control=None):
    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter(), tiu, control=control)


def test_particles_stay_inside_their_box():
    spec = harness.find_spec("tet998k_f64_walk.particles")
    t = spec.traffic
    lo, hi = t["low"], t["high"]
    g = torch.Generator().manual_seed(0)
    r0 = lo + (hi - lo) * torch.rand(20000, 3, generator=g,
                                     dtype=torch.float64)
    v = torch.rand(20000, 3, generator=g, dtype=torch.float64)
    state = particles.State(r0 - lo, v, [0])
    cell = type("C", (), {"traffic": t})()
    prev = particles.positions(cell, state, 0)
    assert torch.allclose(prev, r0, atol=1e-14)
    step = t["dt"] * v.norm(dim=1)
    for k in (1, 2, 57, 1000, 12345, 10 ** 6):
        r = particles.positions(cell, state, k)
        assert float(r.min()) >= lo and float(r.max()) <= hi
        if k in (1, 2):
            # one step moves a particle by at most dt |v| (reflection
            # only shortens it)
            assert bool(((r - prev).norm(dim=1) <= step + 1e-12).all())
        prev = r


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_metrics_on_the_cpu(workload):
    """A traced run on the CPU: the per-layer metrics that need the
    card's trace find nothing and are left out; the grid build's are
    read."""
    import interpolate_unstructured_tpu_torch as tiu

    spec = shrink(harness.find_spec(workload))
    out = run(spec, tiu, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"build_grid_s", "host_geometry_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_run_on_the_card(card, workload):
    """The command itself on the card, one short run a cell."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "iubench/run.py", "--workload", workload, "--seed",
         "4294967391", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
