"""Double-single (two-float32) arithmetic building blocks.

Double-single representation — v = hi + lo with both f32,
|lo| <= ulp(hi)/2 — carries ~48 significand bits (vs f32's 24, f64's 53)
at f32 storage and arithmetic cost: the error-free transformations below
(Dekker/Knuth, no FMA required) run as plain f32 vector ops under XLA.

Used by ops.spmv_dia_ds and ops.spmv_well (float64-class SpMV from f32
storage) and usable standalone for vector math on any backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# 2^12 + 1 (f32 has 24 significand bits); kept a plain Python float so
# kernels do not capture a module-level jax array as a constant
_SPLITTER = 4097.0


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 bits (exact
    products hi*hi fit in f32). No FMA needed."""
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, ~17 flops)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_add(ah, al, bh, bl):
    """(ah+al) + (bh+bl) as a normalized double-single (sloppy variant:
    error O(2^-48) relative, 11 flops)."""
    sh, se = two_sum(ah, bh)
    se = se + (al + bl)
    return fast_two_sum(sh, se)


def ds_mul_f32(ah, al, bh, bl):
    """(ah+al) * (bh+bl) as a normalized double-single. Drops the al*bl
    term (O(2^-48) relative)."""
    ph, pe = two_prod(ah, bh)
    pe = pe + (ah * bl + al * bh)
    return fast_two_sum(ph, pe)


# ---------------------------------------------------------------------------
# host-side conversions
# ---------------------------------------------------------------------------


def ds_from_f64(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 array -> (hi, lo) f32 pair with hi + lo == f64(v) to ~2^-48."""
    hi = np.asarray(v, dtype=np.float32)
    lo = np.asarray(v - hi.astype(np.float64), dtype=np.float32)
    return hi, lo


def ds_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
