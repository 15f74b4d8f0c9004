"""Inputs made from ``--seed``: point data, and the streams of random
numbers that the traffic draws.

Every random stream has its own seed, derived from ``--seed`` and a
name, so one stream never shifts another.  ``--seed`` may be any whole
number up to 2**64 - 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def child_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run ``seed``."""
    tag = [ord(ch) for ch in name]
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, name: str, device) -> torch.Generator:
    """A torch generator on ``device`` seeded for the stream ``name``."""
    g = torch.Generator(device=device)
    g.manual_seed(child_seed(seed, name))
    return g


def smooth_field(points, seed: int, name: str, n_modes: int = 4):
    """(P,) float64 values of a smooth nonlinear function at ``points``:
    a sum of ``n_modes`` plane waves of unit-order amplitude, wave
    vectors up to 3 periods across the unit box, all drawn from the
    seed, plus a linear part.  Bounded by about 2 in magnitude."""
    rng = np.random.default_rng(child_seed(seed, name))
    p = torch.as_tensor(points, dtype=torch.float64)
    out = p @ torch.as_tensor(rng.uniform(-0.5, 0.5, 3))
    for _ in range(n_modes):
        k = torch.as_tensor(rng.uniform(-3.0, 3.0, 3)) * (2 * math.pi)
        amp, phase = rng.uniform(0.1, 0.3), rng.uniform(0, 2 * math.pi)
        out = out + amp * torch.sin(p @ k + phase)
    return out.numpy()


def helix(points):
    """(P, 3) float64 helical field (-(y - 0.5), x - 0.5, 0.25) of
    ``bench.py``'s ``trace_at_scale``."""
    p = np.asarray(points, dtype=np.float64)
    return np.stack([-(p[:, 1] - 0.5), p[:, 0] - 0.5,
                     np.full(len(p), 0.25)], axis=1)
