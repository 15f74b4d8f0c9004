"""Kernel B4 (the fused tracer stages) against the JAX package's kernel.

From one numpy state — anchors at cell centers, random unit stage-1
derivatives and step sizes, a few inactive lanes — the JAX package's
``pallas_trace.trace_round`` runs in interpret mode, round after round
until no lane walks (the loop of its ``trace._fused_stages``), and the
port's :func:`trace_kernel.trace_plain` runs once.  Both read the same
float32 trace table (the JAX package's grid carried over with
``grid_from_numpy``).

Tolerances: cells, failure flags, failure cells and every lane's round
count identical; k2, k3, k4, the stage-4 field and the failure point
within 1e-6 (a few float32 ulp of values of order 1: XLA on the CPU
contracts the JAX side's float32 products and sums into FMAs, torch
rounds each operation).  On a card, the CUDA kernel is held to its plain
version bit for bit.
"""

import numpy as np
import pytest
import torch

from interpolate_unstructured_tpu_torch import build_trace_table, grid_from_numpy
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.ops import trace_kernel
from interpolate_unstructured_tpu_torch.trace import MIN_RADIUS
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


def test_trace_stages_dispatches_by_device():
    """CPU tensors take the plain version: no launch is counted."""
    ug, tg, table, kw = _setup("triangle")
    lanes = [torch.from_numpy(x) for x in _lanes(tg.cell_points.numpy(), 2)]
    before = trace_kernel.launches
    a = trace_kernel.trace_stages(table, *lanes, **_port_kw(tg, kw))
    b = trace_kernel.trace_plain(table, *lanes, **_port_kw(tg, kw))
    assert trace_kernel.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert trace_kernel.supported(tg, None, 0)
    assert not trace_kernel.supported(tg, 0, 0)
    assert not trace_kernel.supported(tg, None, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["triangle", "quad", "tetra", "reverse",
                                  "axisymmetric"])
def test_cuda_trace_matches_plain(case):
    """B4 on the card against its plain version on the same CUDA
    tensors: bit for bit (the port alone; the card has no jax)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import interpolate_unstructured_tpu_torch as tiu

    cell_type = {"reverse": "triangle", "axisymmetric": "quad"}.get(case,
                                                                   case)
    pts, cells, nbrs = MESHES[cell_type]()
    p = np.asarray(pts, np.float64)
    pd = dict(zip("xyz", _field(cell_type, p)))
    g = tiu.build_grid(pts, cells, nbrs, cell_type, point_data=pd,
                       dtype=torch.float32, locate_mode="walk", device="cuda")
    table = tiu.build_trace_table(g, range(g.ndim))
    nudge, eps_arrive = walk_tolerances(torch.float32, g.rmin, g.rmax)
    kw = dict(cell_type=cell_type, ndim=g.ndim, nudge=nudge,
              eps_arrive=eps_arrive, tiny=tiny_distance(np.float32),
              big=huge_distance(np.float32), reverse=case == "reverse",
              axisymmetric=case == "axisymmetric", max_steps=128,
              min_radius=MIN_RADIUS)
    lanes = [torch.from_numpy(x).cuda()
             for x in _lanes(g.cell_points.cpu().numpy(), g.ndim)]
    before = trace_kernel.launches
    k = trace_kernel.trace_stages(table, *lanes, **kw)
    torch.cuda.synchronize()
    assert trace_kernel.launches == before + 1
    p = trace_kernel.trace_plain(table, *lanes, **kw)
    for name, x, y in zip(k._fields, k, p):
        assert torch.equal(x, y), name
    assert int(k.rounds.max()) > 6
