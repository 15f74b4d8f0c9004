"""The port's instrumentation and build-directory modules.

``utils/timing.py`` against the JAX package's: the same report keys and
counts for the same scopes and counts, ``timed``, ``env_ticker`` on and
off, and the ticks that ``IU_BUILD_PROFILE`` prints from the host
candidate builder at the JAX package's counterparts; on the card, that
``scope(sync=...)`` waits for a kernel's output.  ``utils/cache.py``:
``enable_compile_cache`` moves where both compiled libraries (the CUDA
kernels and the serial oracle) are built, read from the paths they
report, so nothing is built here.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.ops import _kernels, geometry
from interpolate_unstructured_tpu_torch.utils import (
    cache,
    meshgen,
    serial_oracle,
    timing,
)


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests:
    on some virtualized hosts a worker thread's first float32
    torch.sqrt in a process is off by ~1e-4 relative."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _jax_timing():
    pytest.importorskip("jax")
    from interpolate_unstructured_tpu.utils import timing as jt

    return jt


def _drive(m, t):
    """One sequence of scopes (with and without ``sync``) and counts."""
    for i in range(3):
        with m.scope("build", sync=t):
            pass
        m.count("queries", 10)
    with m.scope("trace", sync=(t, [t], {"a": t})):
        pass
    m.count("steps")
    m.count("steps", 2.5)


def test_metrics_report_matches_jax():
    """Same scopes and counts: the same report keys, call counts and
    counters as the JAX package's Metrics; reset clears all three."""
    jt = _jax_timing()
    import jax.numpy as jnp

    mine, theirs = timing.Metrics(), jt.Metrics()
    _drive(mine, torch.ones(4))
    _drive(theirs, jnp.ones(4))
    a, b = mine.report(), theirs.report()
    assert a.keys() == b.keys() == {"times_s", "calls", "counters"}
    assert a["times_s"].keys() == b["times_s"].keys() == {"build", "trace"}
    assert a["calls"] == b["calls"] == {"build": 3, "trace": 1}
    assert a["counters"] == b["counters"] == {"queries": 30.0, "steps": 3.5}
    assert all(v >= 0.0 for v in a["times_s"].values())
    mine.reset()
    assert mine.report() == {"times_s": {}, "calls": {}, "counters": {}}


def test_dump_and_scope_sync_on_the_cpu(capsys):
    """dump prints the report as sorted JSON; sync takes a tensor, a
    tuple, list or dict of them, or a TraceResult (CPU tensors need no
    wait), and a scope that raises still records its time."""
    import json

    m = timing.Metrics()
    res = tiu.TraceResult(*(torch.zeros(2) for _ in tiu.TraceResult._fields))
    for sync in (torch.ones(2), (torch.ones(2),), [torch.ones(2)],
                 {"x": torch.ones(2)}, res, 3.0):
        with m.scope("s", sync=sync):
            pass
    with pytest.raises(ValueError):
        with m.scope("raises"):
            raise ValueError("inside")
    m.dump()
    out = json.loads(capsys.readouterr().out)
    assert out["calls"] == {"s": 6, "raises": 1}
    assert timing.block_until_ready(res) is res


def test_timed_accumulates_into_metrics():
    """timed(name) keeps the function's name and result and adds one
    call and its time to the process-wide registry."""
    calls = timing.metrics.calls.get("scaled", 0)

    @timing.timed("scaled")
    def scale(x, by=2.0):
        return x * by

    assert scale.__name__ == "scale"
    assert torch.equal(scale(torch.ones(3), by=3.0), torch.full((3,), 3.0))
    assert timing.metrics.calls["scaled"] == calls + 1
    assert timing.metrics.times["scaled"] >= 0.0


@pytest.mark.parametrize("value", ["", "1"])
def test_env_ticker(monkeypatch, capsys, value):
    """Unset or empty: a no-op that prints nothing; set: one line a
    tick with the label, the tag and the seconds since the last tick."""
    monkeypatch.setenv("IU_TEST_TICKER", value)
    tick = timing.env_ticker("IU_TEST_TICKER", "lbl")
    tick("first")
    tick("second")
    out = capsys.readouterr().out.splitlines()
    if not value:
        assert out == []
    else:
        assert [line.split(":")[0] for line in out] == [
            "  [lbl] first", "  [lbl] second"]
        assert all(line.endswith("s") for line in out)


def _cand_inputs():
    """Host float64 geometry of a 6x6x6 tet box, as build_grid hands it
    to the candidate builder."""
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float64,
                       locate_mode="walk", device="cpu")
    return (g.cell_points.numpy(), g.face_normals.numpy(),
            g.face_offsets.numpy(), g.rmin.numpy(), g.rmax.numpy(), 3, 8)


@pytest.mark.parametrize("profile", ["", "1"])
def test_candidate_builder_ticks_like_jax(monkeypatch, capsys, profile):
    """IU_BUILD_PROFILE set: the port's host candidate builder prints
    the JAX package's ticks, tag for tag (several cell chunks, then
    concat, lexsort, rank, fill main, ext), with the same lists; unset,
    neither prints."""
    pytest.importorskip("jax")
    from interpolate_unstructured_tpu.ops import geometry as jgeo

    monkeypatch.setenv("IU_BUILD_PROFILE", profile)
    args = _cand_inputs()
    capsys.readouterr()  # build_grid's own ticks
    kw = dict(bins_per_cell=0.3, eps=1e-10, pair_chunk=2000, ext_max_k=16)
    tags = []
    outs = []
    for build in (geometry.build_candidate_bins, jgeo.build_candidate_bins):
        outs.append(build(*args, **kw))
        tags.append([line.split(":")[0].strip()
                     for line in capsys.readouterr().out.splitlines()])
    assert tags[0] == tags[1]
    if profile:
        assert sum(t.startswith("[cand-build] chunk") for t in tags[0]) > 1
        assert tags[0][-5:] == [f"[cand-build] {t}" for t in (
            "concat", "lexsort", "rank", "fill main", "ext")]
    else:
        assert tags[0] == []
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def default_cache_dir():
    """Put the build directory back to the default after the test."""
    yield cache.DEFAULT_DIR
    cache.enable_compile_cache()


def test_enable_compile_cache_moves_both_libraries(tmp_path,
                                                   default_cache_dir):
    """Both libraries build under the directory enable_compile_cache
    sets (kernels/ and serial_oracle/ beside each other), keep their
    source-hash names, and go back to build/ at the repository root
    with no argument; calling it again is harmless.  Nothing is built:
    the paths are the ones the two modules report."""
    root = default_cache_dir
    assert root.name == "build" and (root.parent / "native").is_dir()
    k0, o0 = _kernels.library_path(), serial_oracle.library_path()
    assert k0.parent == root / "kernels" == _kernels.build_dir()
    assert o0.parent == root / "serial_oracle"
    for _ in range(2):
        tiu.utils.cache.enable_compile_cache(tmp_path / "cc")
    k1, o1 = _kernels.library_path(), serial_oracle.library_path()
    assert k1 == tmp_path / "cc" / "kernels" / k0.name
    assert o1 == tmp_path / "cc" / "serial_oracle" / o0.name
    assert not (tmp_path / "cc").exists()
    cache.enable_compile_cache()
    assert (_kernels.library_path(), serial_oracle.library_path()) == (k0, o0)


@pytest.mark.cuda
def test_cuda_scope_sync_waits_for_the_kernel():
    """scope(sync=...) returns only once the card has run the work
    queued on the device of its tensors: B1 launched behind a spin
    kernel of ~0.1 s is done at the scope's exit, and the scope's time
    covers it; with only CPU tensors in ``sync`` the scope does not
    wait."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from interpolate_unstructured_tpu_torch.ops import interp_kernel

    dev = torch.device("cuda")
    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    grid = tiu.build_grid(pts, cells, nbrs, "tetra",
                          point_data={"p": pts.sum(1)}, device=dev)
    r = torch.rand((1 << 16, 3), device=dev)
    interp_kernel.interpolate_bruteforce_cuda(grid, r, [0])  # build, load
    torch.cuda.synchronize()
    m = timing.Metrics()
    start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    before = interp_kernel.launches
    with m.scope("b1", sync={"queries": r}):
        start.record()
        torch.cuda._sleep(200_000_000)
        out = interp_kernel.interpolate_bruteforce_cuda(grid, r, [0])
        done.record()
    assert interp_kernel.launches == before + 1
    assert done.query()
    assert m.times["b1"] * 1e3 >= start.elapsed_time(done)
    assert bool(torch.isfinite(out[0]).all())
    spin = torch.cuda.Event()
    with m.scope("cpu tensors only", sync=torch.ones(1)):
        torch.cuda._sleep(200_000_000)
        spin.record()
    assert not spin.query()
    torch.cuda.synchronize()
