"""Run every example of the PyTorch port end to end on the CPU.

Each ``examples/torch_port/*.py`` runs in-process as ``__main__`` with
``--device cpu`` (their default is the CUDA device), in a temporary
directory for the files they write.  An example exits non-zero when its
own check fails.
"""

import os
import runpy
import sys

import pytest
import torch

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
    "torch_port",
)
EXAMPLES = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Warm torch.sqrt on every intra-op thread first (PERF.md §7)."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def test_examples_discovered():
    # an empty list would silently skip the parametrized test
    assert len(EXAMPLES) >= 4


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_runs_on_the_cpu(example, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = os.path.join(EXAMPLES_DIR, example)
    monkeypatch.setattr(sys, "argv", [path, "--device", "cpu"])
    runpy.run_path(path, run_name="__main__")
