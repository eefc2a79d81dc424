"""Profiler integration.

The reference brackets its solver region with MPI_Pcontrol so external MPI
profilers capture only the solve (reference demos/cg.cpp:22,68-73), and
hand-rolls phase timing maps (demos/spmv.cpp:84-130 — spmv_tpu mirrors those
in utils.timing). The equivalents here wrap jax.profiler: traces land in
TensorBoard/XProf format and named regions show up on the device
timeline.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import jax


@contextlib.contextmanager
def profile_region(name: str):
    """Annotate a named region on the device trace (TraceAnnotation) — the
    MPI_Pcontrol analogue at sub-trace granularity."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_to(logdir: str | None = None):
    """Capture a device trace for the enclosed region; view with
    ``tensorboard --logdir <dir>`` or xprof. The Pcontrol analogue at
    whole-solve granularity. Default directory: spmv_tpu_trace under the
    temporary directory ($TMPDIR)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "spmv_tpu_trace")
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(fn, name: str | None = None):
    """Wrap a function so its device execution is labeled in traces."""
    label = name or getattr(fn, "__name__", "region")

    def wrapped(*args, **kwargs):
        with jax.profiler.TraceAnnotation(label):
            return fn(*args, **kwargs)

    return wrapped
