"""Float32 matrix products at full precision on every solver path.

On GPUs a float32 ``dot_general`` at default precision may run in TF32,
which keeps about three decimal digits — too few for Gram matrices,
projections and residual dots. Library code passes
``precision=HIGHEST`` where it builds an einsum itself; the solver entry
points are wrapped in ``highest_precision`` so every product they (and
the operators and preconditioners they call) trace runs in full float32.
"""
from __future__ import annotations

import functools

import jax

HIGHEST = jax.lax.Precision.HIGHEST


def highest_precision(fn):
    """Trace ``fn`` inside ``jax.default_matmul_precision("highest")``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
