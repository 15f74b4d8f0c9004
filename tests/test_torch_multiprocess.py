"""The port's multi-process pipeline in real processes: N
``torch.distributed`` gloo ranks on 127.0.0.1, two ``cpu`` mesh entries
each, with UNEQUAL query contributions (``tests/_torch_mh_worker.py``).

The three scenarios of ``tests/test_multiprocess.py``: 2 ranks
interpolating (5 + 4p queries on rank p); 4 ranks with rank 1
contributing none; a 2-rank trace of the circle field.  Every rank must
collect the same arrays, and they must equal, bit for bit, the port's
single-process call on the concatenated contributions.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mh_worker as worker  # tests/, on sys.path under pytest
import interpolate_unstructured_tpu_torch as tiu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mh_worker.py")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Warm torch.sqrt on every intra-op thread first (PERF.md §7)."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, n_procs, scenario, timeout=420):
    port = str(_free_port())
    outs = [str(tmp_path / f"out{p}.npz") for p in range(n_procs)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, port, str(n_procs), str(p), outs[p],
             scenario],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO,
        )
        for p in range(n_procs)
    ]
    try:
        for p, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {p} timed out")
            assert proc.returncode == 0, f"rank {p} failed:\n{out}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [dict(np.load(o)) for o in outs]


def _same(got, want):
    got = torch.from_numpy(np.ascontiguousarray(got))
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        got, want = got.view(torch.int64), want.view(torch.int64)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "n_procs,scenario", [(2, "interp"), (4, "interp_zero")],
)
def test_multiprocess_pipeline_unequal_contributions(tmp_path, n_procs,
                                                     scenario):
    results = _run_workers(tmp_path, n_procs, scenario)
    for r in results[1:]:  # every rank collects the same full result
        for f in ("vals", "i_cell", "found"):
            np.testing.assert_array_equal(r[f], results[0][f])

    r_all = np.concatenate([r["r_local"] for r in results])
    for p, r in enumerate(results):  # each rank's own block, regenerated
        np.testing.assert_array_equal(
            r["r_local"], worker.interp_queries(p, scenario))
    if scenario == "interp_zero":
        assert results[1]["r_local"].shape[0] == 0
    # every rank pads to the same per-device size; 2 entries a rank
    per_device = max(-(-len(r["r_local"]) // 2) or 1 for r in results)
    assert int(results[0]["global_rows"]) == per_device * 2 * n_procs

    want = tiu.interpolate_at(worker.interp_grid(), torch.from_numpy(r_all),
                              [0])
    for f, w in zip(("vals", "i_cell", "found"), want):
        _same(results[0][f], w)
    assert results[0]["found"].all()
    np.testing.assert_allclose(results[0]["vals"][:, 0], r_all.sum(1) + 1.0,
                               rtol=0, atol=1e-12)


def test_multiprocess_sharded_trace(tmp_path):
    results = _run_workers(tmp_path, 2, "trace")
    fields = ("y", "y_field", "n_steps", "boundary_material", "n_iterations")
    for r in results[1:]:
        for f in fields + ("n_rounds",):
            np.testing.assert_array_equal(r[f], results[0][f])

    y_local = np.concatenate([r["y_local"] for r in results])
    assert y_local.shape[0] == 8  # 3 + 5 lines
    want = tiu.integrate_along_field(worker.trace_grid(),
                                     torch.from_numpy(y_local), [0, 1],
                                     **worker.TRACE_KW)
    for f in fields:
        _same(results[0][f], getattr(want, f))
    assert int(results[0]["n_rounds"]) == 0  # float64: the generic path

    y, n_steps = results[0]["y"], results[0]["n_steps"]
    for b in range(y.shape[0]):
        n = min(int(n_steps[b]), y.shape[1])
        assert n > 3
        curve = y[b, :n, :2]
        np.testing.assert_allclose(curve[0], y_local[b], atol=1e-12)
        # closed orbit: every accepted point stays on the seed circle
        np.testing.assert_allclose(np.linalg.norm(curve - 1.0, axis=1), 0.5,
                                   atol=5e-3)
