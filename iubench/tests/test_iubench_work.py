"""iubench/work.py's counts on a hand-counted two-tet mesh."""

import types

import numpy as np
import torch

from iubench import work


def two_tets(dtype):
    # two tets sharing the face (1, 2, 3); 5 points
    cells = np.array([[0, 1, 2, 3], [4, 1, 2, 3]])
    spec = types.SimpleNamespace(config={"dtype": dtype,
                                         "cell_type": "tetra"})
    return types.SimpleNamespace(spec=spec, cells=cells)


def test_query_work_one_cell_float32():
    cell = two_tets("float32")
    # 3 queries, all in cell 0; 1 variable, no guess
    w = work.query_work(cell, torch.tensor([0, 0, 0]), n_queries=3,
                        n_vars=1, guess=False)
    # per query: 12 B coordinates + 4 B value + 4 B id + 1 B flag = 21;
    # one cell's connectivity 16 B; its 4 vertices x (3 + 1) x 4 B = 64
    assert w["bytes"] == 3 * 21 + 16 + 64
    assert w["ops"] == 3 * (28 + 7)
    assert (w["distinct_cells"], w["distinct_points"]) == (1, 4)
    assert w["bound_by"] == "bytes"
    assert w["least_s"] == w["bytes"] / 3.35e12


def test_query_work_both_cells_float64_with_guess():
    cell = two_tets("float64")
    w = work.query_work(cell, torch.tensor([0, 1]), n_queries=2, n_vars=3,
                        guess=True)
    # per query: 24 + 4 (guess) + 24 + 4 + 1 = 57; 2 cells x 16; 5 points
    # x (3 + 3) x 8
    assert w["bytes"] == 2 * 57 + 32 + 240
    assert w["ops"] == 2 * (28 + 21)
    assert (w["distinct_cells"], w["distinct_points"]) == (2, 5)


def test_least_time_takes_the_larger_bound():
    t, by = work.least_time("float64", 0, 34e12)
    assert (t, by) == (1.0, "operations")
    t, by = work.least_time("float32", 3.35e12, 1)
    assert (t, by) == (1.0, "bytes")


def test_triangle_and_unknown_cell_types():
    assert work.query_ops("triangle", 2) == 15 + 10
    try:
        work.query_ops("quad", 1)
    except ValueError:
        pass
    else:
        raise AssertionError("quad cells have no count yet")
