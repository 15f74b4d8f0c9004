"""CPU tests of the benchmark: ``python -m pytest iubench/tests -q``
from the repository root (tests marked ``cuda`` skip without a card)."""

import copy
import sys
from pathlib import Path

import pytest
import torch

# several test workers share the CPU: one thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# a cell shrunk to what a test can hold: the mesh by its generator's
# SMALL, and the traffic's sizes
SMALL = {"n_queries": 6000, "n_particles": 6000, "n_lines": 16,
         "check_queries": 6000, "check_lines": 16, "max_steps": 64,
         "trace_calls": 2, "span_calls": 0, "check_calls": 2}


def shrink(spec):
    """``spec`` with its mesh shrunk by the generator's ``SMALL`` and small
    batches."""
    from iubench import harness

    spec.config = copy.deepcopy(spec.config)
    spec.traffic = dict(spec.traffic)
    spec.config["mesh"].update(harness.generator(spec).SMALL)
    for k, v in SMALL.items():
        if k in spec.traffic:
            spec.traffic[k] = v
    return spec


@pytest.fixture
def card():
    """The CUDA device, or a skip: tests marked ``cuda`` take it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
