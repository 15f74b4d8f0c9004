"""Kernel B4 (every line's RK loop) and its stages against the JAX
package's kernel.

From one numpy state — anchors at cell centers, random unit stage-1
derivatives and step sizes, a few inactive lanes — the JAX package's
``pallas_trace.trace_round`` runs in interpret mode, round after round
until no lane walks (the loop of its ``trace._fused_stages``), and the
port's :func:`trace_kernel.trace_plain` (the stages of one iteration)
runs once.  Both read the same float32 trace table (the JAX package's
grid carried over with ``grid_from_numpy``).  Tolerances: cells, failure
flags, failure cells and every lane's round count identical; k2, k3, k4,
the stage-4 field and the failure point within 1e-6 (a few float32 ulp
of values of order 1: XLA on the CPU contracts the JAX side's float32
products and sums into FMAs, torch rounds each operation).

The whole loop (:func:`trace_kernel.trace_loop_plain`, which
``integrate_along_field`` runs on the fused path on the CPU): bit for
bit what ``integrate_along_field`` computed before the loop moved into
one kernel (the host loop kept here as ``_integrate_before``); tracing a
subset of the lines gives those lines' rows of the full batch bit for
bit (each line depends on itself only, which the one-thread-a-line
kernel relies on); and the JAX package's fused trace (interpret mode)
agrees as ``tests/test_torch_trace.py`` holds it, ``n_rounds`` equal.

On a card, the CUDA kernel is held to its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch import build_trace_table, grid_from_numpy
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.ops import interp, locate, trace_kernel
from interpolate_unstructured_tpu_torch.trace import (
    BM_NOT_REACHED,
    BM_STEP_CAP,
    MIN_RADIUS,
    SAFETY_FAC,
    _shrink_eps,
)
from interpolate_unstructured_tpu_torch.utils import meshgen
from interpolate_unstructured_tpu_torch.utils.config import (
    huge_distance,
    tiny_distance,
    walk_tolerances,
)

N_LANES = 300
TOL = 1e-6
MESHES = {
    "triangle": lambda: meshgen.triangle_rect_mesh(9, 8),
    "quad": lambda: meshgen.quad_rect_mesh(9, 8),
    "tetra": lambda: meshgen.tet_box_mesh(6, 6, 6),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests.

    On some virtualized x86 hosts the first float32 torch.sqrt that a
    worker thread runs in a process returns values off by ~1e-4 relative
    for that thread's chunk; every later call is exact.  The kernel's
    plain version calls torch.sqrt every round, so the first, discarded
    call is made here."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _field(cell_type, p):
    if cell_type == "tetra":
        return 0.5 - p[:, 1], p[:, 0] - 0.5, np.full(len(p), 0.3)
    return -p[:, 1], p[:, 0]


def _lanes(cell_points, ndim, seed=21):
    """(anchor, k1, dx, ic_start, act) in numpy: anchors at the centers of
    random cells, unit k1, steps up to 0.3 (some walks leave the domain),
    every tenth lane inactive."""
    rng = np.random.default_rng(seed)
    ic = rng.integers(0, len(cell_points), N_LANES).astype(np.int32)
    anchor = cell_points[ic].mean(axis=1).astype(np.float32)
    k1 = rng.normal(size=(N_LANES, 3))
    k1[:, ndim:] = 0.0
    k1 = (k1 / np.linalg.norm(k1, axis=1, keepdims=True)).astype(np.float32)
    dx = (0.01 + 0.29 * rng.random(N_LANES)).astype(np.float32)
    act = np.arange(N_LANES) % 10 != 3
    return anchor, k1, dx, ic, act


def _jax_rounds(ug, table, anchor, k1, dx, ic, act, kw, tile=128):
    """The JAX package's round loop on the same state: the F/I blocks as
    trace._fused_stages sets them up, then trace_round (interpret mode)
    until no lane walks.  Returns (F, I, per-lane rounds)."""
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu.ops import pallas_trace as pt

    f32 = jnp.float32
    a = jnp.asarray(anchor.T)
    k = jnp.asarray(k1.T)
    d = jnp.asarray(dx)
    tgt = a + (0.5 * d)[None, :] * k
    if kw["axisymmetric"]:
        tgt = tgt.at[0].set(jnp.maximum(tgt[0], kw["min_radius"]))
    delta = tgt - a
    total = jnp.sqrt(delta[0] * delta[0] + delta[1] * delta[1]
                     + delta[2] * delta[2])
    invt = jnp.where(total > kw["tiny"],
                     1.0 / jnp.where(total > kw["tiny"], total, 1.0), 0.0)
    F = jnp.concatenate([a, tgt, delta * invt[None], total[None], k,
                         jnp.zeros((12, len(dx)), f32), a, a, d[None]])
    i32 = jnp.int32
    ones = jnp.ones((1, len(dx)), i32)
    act_j = jnp.asarray(act)
    I = jnp.concatenate([  # noqa: E741
        jnp.maximum(jnp.asarray(ic), 0)[None], -ones, 0 * ones,
        act_j[None].astype(i32), jnp.where(act_j, 2, 5)[None].astype(i32),
        0 * ones, -ones, 0 * ones,
    ])
    bp = -(-len(dx) // tile) * tile
    F = jnp.pad(F, ((0, 0), (0, bp - len(dx))))
    I = jnp.pad(I, ((0, 0), (0, bp - len(dx))))  # noqa: E741
    step = jax.jit(lambda g, t, F, I: pt.trace_round(  # noqa: E741
        g, t, F, I, nudge=kw["nudge"], eps_arrive=kw["eps_arrive"],
        tiny=kw["tiny"], reverse=kw["reverse"],
        axisymmetric=kw["axisymmetric"], max_steps=kw["max_steps"],
        min_radius=kw["min_radius"], tile=tile, interpret=True))
    rounds = np.zeros(bp, np.int32)
    n_act = int(act.sum())
    n = 0
    while n_act > 0 and n < trace_kernel.round_cap(kw["max_steps"]):
        rounds += np.asarray(I[pt._WACT]) != 0
        F, I, n_act = step(ug, jnp.asarray(table), F, I)  # noqa: E741
        n_act = int(n_act)
        n += 1
    return np.asarray(F)[:, : len(dx)], np.asarray(I)[:, : len(dx)], \
        rounds[: len(dx)]


def _setup(cell_type, reverse=False, axisymmetric=False, max_steps=128):
    jnp = pytest.importorskip("jax.numpy")
    import interpolate_unstructured_tpu as jiu

    pts, cells, nbrs = MESHES[cell_type]()
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float32,
                        locate_mode="walk")
    p = np.asarray(ug.points, np.float64)
    i_field = []
    for name, v in zip("xyz", _field(cell_type, p)):
        ug, i = jiu.add_point_data(ug, name, v)
        i_field.append(i)
    tg = grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    table = build_trace_table(tg, i_field)
    nudge, eps_arrive = walk_tolerances(torch.float32, tg.rmin, tg.rmax)
    kw = dict(nudge=nudge, eps_arrive=eps_arrive,
              tiny=tiny_distance(np.float32), reverse=reverse,
              axisymmetric=axisymmetric, max_steps=max_steps,
              min_radius=MIN_RADIUS)
    return ug, tg, table, kw


def _port_kw(tg, kw):
    return dict(kw, cell_type=tg.cell_type, ndim=tg.ndim,
                big=huge_distance(np.float32))


@pytest.mark.parametrize("case", ["triangle", "quad", "tetra", "reverse",
                                  "axisymmetric", "step-cap"])
def test_trace_plain_matches_jax_kernel(case):
    from interpolate_unstructured_tpu.ops import pallas_trace as pt

    cell_type = {"reverse": "triangle", "axisymmetric": "quad",
                 "step-cap": "tetra"}.get(case, case)
    ug, tg, table, kw = _setup(cell_type, reverse=case == "reverse",
                               axisymmetric=case == "axisymmetric",
                               max_steps=2 if case == "step-cap" else 128)
    lanes = _lanes(tg.cell_points.numpy(), tg.ndim)
    F, I, rounds = _jax_rounds(ug, table.numpy(), *lanes, kw)  # noqa: E741

    st = trace_kernel.trace_plain(
        table, *(torch.from_numpy(x) for x in lanes), **_port_kw(tg, kw))
    act = lanes[4]
    np.testing.assert_array_equal(st.rounds.numpy(), rounds)
    np.testing.assert_array_equal(st.ic.numpy(), I[pt._IC])
    np.testing.assert_array_equal(st.fail.numpy(), I[pt._FAIL] != 0)
    np.testing.assert_array_equal(st.ic_fail.numpy(), I[pt._ICF])
    assert (I[pt._STAGE] == 5).all() and (I[pt._WACT] == 0).all()
    for name, row in (("k2", pt._K2), ("k3", pt._K3), ("k4", pt._K4),
                      ("field4", pt._FLD4), ("rp_fail", pt._RPF)):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   F[row: row + 3].T, rtol=0, atol=TOL,
                                   err_msg=name)
    # inactive lanes take no round and keep their zero derivatives
    assert (st.rounds.numpy()[~act] == 0).all()
    assert (st.k2.numpy()[~act] == 0).all()
    # the lanes exercise both endings, and stages that took several hops
    fail = st.fail.numpy()
    assert fail[act].any() and (~fail[act]).any()
    if case == "step-cap":
        assert (st.ic_fail.numpy()[fail] >= 0).any()  # capped inside
    else:
        assert st.rounds.max() > 6


def _loop_kw(tg, kw, n_steps=40):
    """trace_loop's keywords for a float32 trace of ``n_steps`` points."""
    return dict(_port_kw(tg, kw), walk_steps=kw["max_steps"],
                min_dx=1e-4, max_dx=0.1, max_steps=n_steps, rtol=1e-3,
                atol=1e-3, shrink_eps=_shrink_eps(np.float32),
                max_iterations=50 * n_steps + 1000)


def _loop_inputs(tg, y0):
    """(y0, field0, ic0, done, bm) as integrate_along_field sets them up
    for start points y0 (no icell mask)."""
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=tg.device)
    r0 = trace_kernel.pad3(y0)
    ic0, found = locate.get_cell(tg, r0)
    ic0 = torch.where(found, ic0, -1).to(torch.int32)
    field0 = interp.interpolate_at_icell(tg, r0, range(tg.ndim),
                                         ic0.clamp_min(0))
    field0 = trace_kernel.pad3(torch.where(found[:, None], field0, 0.0))
    bm = torch.where(found, BM_NOT_REACHED, -1).to(torch.int32)
    return y0, field0, ic0, ~found, bm


def _integrate_before(table, y0, field0, ic0, done, bm, *, cell_type, ndim,
                      nudge, eps_arrive, tiny, big, reverse, axisymmetric,
                      walk_steps, min_radius, min_dx, max_dx, max_steps,
                      rtol, atol, shrink_eps, max_iterations):
    """The fused path of integrate_along_field before its loop moved
    into one kernel: the host loop with Python-scalar divisions and
    torch's row sum, verbatim, around the stages of trace_plain."""
    b = y0.shape[0]
    i32 = torch.int32
    pad3 = trace_kernel.pad3
    fused_kw = dict(cell_type=cell_type, ndim=ndim, nudge=nudge,
                    eps_arrive=eps_arrive, tiny=tiny, big=big,
                    reverse=reverse, axisymmetric=axisymmetric,
                    max_steps=walk_steps, min_radius=min_radius)

    def derivs(field):
        norm = trace_kernel.norm3(field)
        u = field[:, :ndim] / norm.clamp_min(tiny)[:, None]
        return -u if reverse else u

    def clamp_axi(r):
        if axisymmetric:
            return torch.cat([r[:, :1].clamp_min(min_radius), r[:, 1:]], 1)
        return r

    y_buf = torch.zeros((b, max_steps + 1, ndim))
    y_buf[:, 0] = y0
    yf_buf = torch.zeros((b, max_steps + 1, ndim))
    yf_buf[:, 0] = field0[:, :ndim]
    rows = torch.arange(b)
    anchor, field_a, i_cell_prev = y0, field0, ic0
    n_idx = torch.zeros(b, dtype=i32)
    dx = torch.full((b,), max_dx)
    last_rejected = torch.full((b,), -100, dtype=i32)
    iteration = torch.zeros(b, dtype=i32)
    overflow = torch.zeros(b, dtype=torch.bool)
    n_rounds = torch.zeros((), dtype=i32)
    it = 0
    while it < max_iterations and bool((~done).any()):
        act = ~done
        r0 = pad3(anchor[:, :ndim])
        k1 = derivs(field_a)
        st = trace_kernel.trace_plain(table, r0, pad3(k1), dx, i_cell_prev,
                                      act, **fused_kw)
        k2, k3, k4 = (k[:, :ndim] for k in (st.k2, st.k3, st.k4))
        field4, ic4, r_p, ic_fail = st.field4, st.ic, st.rp_fail, st.ic_fail
        n_rounds = n_rounds + st.rounds.max()
        ok = act & ~st.fail
        failed = act & st.fail
        cap_fail = failed & (ic_fail >= 0)
        ys3 = anchor + dx[:, None] * trace_kernel.k123(k1, k2, k3)
        y2nd = anchor + dx[:, None] * (
            7.0 * k1 + 6.0 * k2 + 8.0 * k3 + 3.0 * k4
        ) / 24.0
        scales = atol + torch.maximum(ys3.abs(), y2nd.abs()) * rtol
        err = torch.sqrt((((ys3 - y2nd) / scales) ** 2).sum(dim=1) / 3.0)
        accept = ok & ((err <= 1.0) | (dx < 2.0 * min_dx))
        d_boundary = trace_kernel.norm3(r_p - r0)
        dx_fail = torch.minimum((1.0 - shrink_eps) * d_boundary, 0.75 * dx)
        hit_boundary = failed & (dx_fail < min_dx)
        n_new = torch.where(accept, n_idx + 1, n_idx)
        overflow_now = accept & (n_new >= max_steps)
        write = accept & ~overflow_now
        ys_store = clamp_axi(ys3)
        slot = torch.where(write, n_new, max_steps).long()
        y_buf[rows, slot] = ys_store
        yf_buf[rows, slot] = field4[:, :ndim]
        anchor = torch.where(write[:, None], ys_store, anchor)
        field_a = torch.where(write[:, None], field4, field_a)
        i_cell_prev = torch.where(accept, ic4, i_cell_prev)
        last_rejected = torch.where(act & (failed | ~accept), it,
                                    last_rejected)
        max_growth = torch.where(last_rejected > it - 2, 1.0, 2.0)
        dx_factor = torch.minimum(
            max_growth, SAFETY_FAC * (1.0 / err) ** (1.0 / 3.0))
        dx_ok = torch.clamp(dx * dx_factor, min_dx, max_dx)
        dx = torch.where(act, torch.where(failed, dx_fail, dx_ok), dx)
        done = done | hit_boundary | overflow_now
        bm = torch.where(hit_boundary,
                         torch.where(cap_fail, BM_STEP_CAP, -1), bm).to(i32)
        n_idx = torch.where(write, n_new, n_idx)
        iteration = torch.where(act, it + 1, iteration).to(i32)
        overflow = overflow | overflow_now
        it += 1
    n_steps = torch.where(overflow, max_steps + 1, n_idx + 1).to(i32)
    return (y_buf[:, :max_steps], yf_buf[:, :max_steps], n_steps, bm,
            iteration, n_rounds)


LOOP_CASES = {  # cell type, reverse, axisymmetric
    "triangle": ("triangle", False, False),
    "quad": ("quad", False, False),
    "tetra": ("tetra", False, False),
    "reverse": ("triangle", True, False),
    "axisymmetric": ("quad", False, True),
}


def _seeds(tg, n=24, seed=5):
    """Start points: random points of the mesh's box (a few fall outside
    a triangle/quad domain's cells only at the edges) and one far
    outside."""
    rng = np.random.default_rng(seed)
    lo = tg.points.min(0).values.cpu().numpy()[:tg.ndim]
    hi = tg.points.max(0).values.cpu().numpy()[:tg.ndim]
    y0 = lo + (0.02 + 0.96 * rng.random((n, tg.ndim))) * (hi - lo)
    y0[-1] = -5.0
    return y0


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_trace_loop_plain_matches_before_and_jax(monkeypatch, case):
    """The extracted plain loop: bit for bit the loop it replaced, and
    the JAX package's fused trace within tests/test_torch_trace.py's
    bounds, n_rounds equal."""
    from interpolate_unstructured_tpu.ops import pallas_trace
    from interpolate_unstructured_tpu.trace import integrate_along_field

    cell_type, reverse, axi = LOOP_CASES[case]
    ug, tg, table, kw = _setup(cell_type, reverse=reverse, axisymmetric=axi)
    y0 = _seeds(tg)
    inputs = _loop_inputs(tg, y0)
    lkw = _loop_kw(tg, kw)
    got = trace_kernel.trace_loop_plain(table, *inputs, **lkw)
    want = _integrate_before(table, *inputs, **lkw)
    for name, a, b in zip(("y", "y_field", "n_steps", "bm", "iterations",
                           "n_rounds"), got, want):
        assert torch.equal(a, b), name
    # integrate_along_field takes this loop on the CPU
    res = tiu.integrate_along_field(
        tg, torch.from_numpy(y0), range(tg.ndim), min_dx=1e-4, max_dx=0.1,
        max_steps=40, rtol=1e-3, atol=1e-3, reverse=reverse,
        axisymmetric=axi, trace_table=table)
    for a, b in zip(res, got):
        assert torch.equal(a, b)
    assert int(got[2].max()) > 5 and int(got[5]) > 0

    import jax.numpy as jnp

    monkeypatch.setattr(pallas_trace, "supported", lambda *a: True)
    rj = integrate_along_field(
        ug, jnp.asarray(y0, jnp.float32), tuple(range(tg.ndim)), min_dx=1e-4,
        max_dx=0.1, max_steps=40, rtol=1e-3, atol=1e-3, reverse=reverse,
        axisymmetric=axi)
    np.testing.assert_array_equal(res.n_steps.numpy(), np.asarray(rj.n_steps))
    np.testing.assert_array_equal(res.boundary_material.numpy(),
                                  np.asarray(rj.boundary_material))
    assert int(res.n_rounds) == int(rj.n_rounds)
    for b, n in enumerate(res.n_steps.tolist()):
        m = min(n, 40)
        np.testing.assert_allclose(res.y[b, :m].numpy(),
                                   np.asarray(rj.y[b, :m]), rtol=0, atol=5e-5)


@pytest.mark.parametrize("cell_type", ["triangle", "quad", "tetra"])
def test_trace_loop_lines_are_independent(cell_type):
    """Tracing any subset of the lines gives the same rows as the full
    batch, bit for bit: a line's loop reads nothing of the others."""
    _, tg, table, kw = _setup(cell_type)
    y0 = _seeds(tg, n=30, seed=8)
    lkw = _loop_kw(tg, kw)
    full = trace_kernel.trace_loop_plain(table, *_loop_inputs(tg, y0), **lkw)
    rng = np.random.default_rng(9)
    for sub in (np.array([3]), np.sort(rng.choice(30, 11, replace=False)),
                np.arange(29, -1, -2)):
        part = trace_kernel.trace_loop_plain(
            table, *_loop_inputs(tg, y0[sub]), **lkw)
        for name, a, b in zip(("y", "y_field", "n_steps", "bm",
                               "iterations"), part, full):
            assert torch.equal(a, b[torch.from_numpy(sub)]), name
        assert int(part[5]) <= int(full[5])


def test_trace_stages_dispatches_by_device():
    """CPU tensors take the plain loop: no launch is counted."""
    ug, tg, table, kw = _setup("triangle")
    inputs = _loop_inputs(tg, _seeds(tg, n=6))
    lkw = _loop_kw(tg, kw, n_steps=8)
    before = trace_kernel.launches
    a = trace_kernel.trace_loop(table, *inputs, **lkw)
    b = trace_kernel.trace_loop_plain(table, *inputs, **lkw)
    assert trace_kernel.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert trace_kernel.supported(tg, None, 0)
    assert not trace_kernel.supported(tg, 0, 0)
    assert not trace_kernel.supported(tg, None, 1)


def _cuda_setup(case, dev):
    cell_type = {"reverse": "triangle", "axisymmetric": "quad"}.get(case,
                                                                   case)
    pts, cells, nbrs = MESHES[cell_type]()
    p = np.asarray(pts, np.float64)
    pd = dict(zip("xyz", _field(cell_type, p)))
    g = tiu.build_grid(pts, cells, nbrs, cell_type, point_data=pd,
                       dtype=torch.float32, locate_mode="walk", device=dev)
    table = tiu.build_trace_table(g, range(g.ndim))
    nudge, eps_arrive = walk_tolerances(torch.float32, g.rmin, g.rmax)
    kw = dict(nudge=nudge, eps_arrive=eps_arrive,
              tiny=tiny_distance(np.float32), reverse=case == "reverse",
              axisymmetric=case == "axisymmetric", max_steps=128,
              min_radius=MIN_RADIUS)
    return g, table, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["triangle", "quad", "tetra", "reverse",
                                  "axisymmetric"])
def test_cuda_trace_matches_plain(case):
    """B4 on the card against its plain loop on the same CUDA tensors:
    every output bit for bit, n_rounds included, in one launch (the port
    alone; the card has no jax)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, table, kw = _cuda_setup(case, "cuda")
    inputs = _loop_inputs(g, _seeds(g, n=500))
    lkw = _loop_kw(g, kw, n_steps=64)
    before = trace_kernel.launches
    k = trace_kernel.trace_loop(table, *inputs, **lkw)
    torch.cuda.synchronize()
    assert trace_kernel.launches == before + 1
    p = trace_kernel.trace_loop_plain(table, *inputs, **lkw)
    for name, x, y in zip(("y", "y_field", "n_steps", "bm", "iterations",
                           "n_rounds"), k, p):
        assert torch.equal(x, y), name
    assert int(k[2].max()) > 5 and int(k[5]) > 0


@pytest.mark.cuda
def test_cuda_integrate_makes_one_launch():
    """integrate_along_field on the fused path launches B4 once a call,
    whatever the number of iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, table, kw = _cuda_setup("tetra", "cuda")
    y0 = torch.from_numpy(_seeds(g, n=200))
    before = trace_kernel.launches
    res = tiu.integrate_along_field(g, y0, (0, 1, 2), min_dx=1e-4,
                                    max_dx=0.05, max_steps=100, rtol=1e-3,
                                    atol=1e-3, trace_table=table)
    torch.cuda.synchronize()
    assert trace_kernel.launches == before + 1
    assert int(res.n_iterations.max()) > 20
