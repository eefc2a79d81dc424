"""Phase timing for the demos.

The analogue of the reference demo's timing machinery (reference
demos/spmv.cpp:84-130: MPI_Barrier-fenced phase timers with a min/max-over-
ranks report). Here a phase is fenced by ``block_until_ready``: JAX returns
before the device finishes, so a timing without it measures the enqueue.
A timing loop must consume its carry — feed each output into the next
input — or XLA hoists the loop-invariant work and times one iteration.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np


def device_sync(x: jax.Array) -> float:
    """Block until ``x`` is computed; return its last element."""
    x = jax.block_until_ready(x)
    return float(np.asarray(x if x.ndim == 0 else x.ravel()[-1]))


class PhaseTimer:
    """Accumulating named phase timers (demos/spmv.cpp:33 timing-map parity)."""

    def __init__(self):
        self.acc: dict[str, float] = {}

    def time(self, name: str, fn: Callable, *args, sync=None):
        t0 = time.perf_counter()
        out = fn(*args)
        if sync is not None:
            device_sync(sync(out) if callable(sync) else out)
        dt = time.perf_counter() - t0
        self.acc[name] = self.acc.get(name, 0.0) + dt
        return out

    def add(self, name: str, seconds: float) -> None:
        self.acc[name] = self.acc.get(name, 0.0) + seconds

    def report(self) -> str:
        total = sum(self.acc.values())
        lines = ["[------------------ Timings ------------------]",
                 f"{'Phase':<24}{'seconds':>12}"]
        for name in sorted(self.acc):
            lines.append(f"{name:<24}{self.acc[name]:>12.6f}")
        lines.append(f"{'Total':<24}{total:>12.6f}")
        return "\n".join(lines)
