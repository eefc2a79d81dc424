"""Paired-slot WELL (formats/well.py module doc, round 3).

Merging complementary half-full slots cuts K (storage/traffic) 20-30% on
boundary-straddling band structure. The two leg segments ride in the pos
ENDPOINT lanes (lane 0 = leg a, lane 127 = leg b); each element's own pos
carries its segment, so the gather apply needs no leg select. Pairing is
opt-in (``pair=True``); these tests pin the bitwise contract either way.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.formats.well import csr_to_well, LANES
from spmv_tpu.gen import create_laplace_2d, random_csr
from spmv_tpu.ops.spmv_well import (
    csr_to_well_ds,
    spmv_well,
    spmv_well_ds,
)


def _apply(w, a, x):
    xp = jnp.asarray(np.pad(x, (0, w.ncols_pad - a.ncols)))
    return np.asarray(spmv_well(w, xp))[: a.nrows]


def _band_random(n=2000, seed=0):
    """Banded-random structure whose 128-groups straddle segment
    boundaries — the case pairing was built for."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in (-170, -1, 0, 1, 130):
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < 0.85
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    return CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(np.float32), n, n)


def test_paired_reduces_k_and_matches_oracle():
    a = _band_random()
    wu = csr_to_well(a, tile_groups=2, dtype=np.float32, pair=False)
    wp = csr_to_well(a, tile_groups=2, dtype=np.float32, pair=True)
    assert wp.paired and not wu.paired
    assert wp.k_slots < wu.k_slots  # the merge actually fires
    assert wp.format_size_bytes() < wu.format_size_bytes()
    x = np.random.default_rng(1).standard_normal(a.ncols).astype(np.float32)
    want = a.matvec(x).astype(np.float64)
    for w in (wu, wp):
        y = _apply(w, a, x)
        err = np.abs(y - want).max() / (np.abs(want).max() + 1)
        assert err < 1e-6, err


def test_paired_random_scatter_oracle():
    # arbitrary scatter (not just bands): merges pair ANY disjoint masks
    rng = np.random.default_rng(7)
    n, nnz = 1200, 7000
    rows = rng.integers(0, n, nnz)
    cols = np.clip(rows + rng.integers(-500, 500, nnz), 0, n - 1)
    a = CSRHost.from_coo(rows, cols,
                         rng.standard_normal(nnz).astype(np.float32), n, n)
    wp = csr_to_well(a, tile_groups=2, dtype=np.float32, pair=True)
    x = rng.standard_normal(n).astype(np.float32)
    y = _apply(wp, a, x)
    want = a.matvec(x)
    err = np.abs(y - want).max() / (np.abs(want).max() + 1)
    assert err < 1e-6, err


def test_paired_endpoint_invariant():
    """The kernel contract: lane 0's segment is leg a, lane 127's leg b,
    and every real entry's segment is one of the two."""
    a = _band_random(seed=3)
    wp = csr_to_well(a, tile_groups=2, dtype=np.float32, pair=True)
    p = np.asarray(wp.pos).astype(np.int64)
    v = np.asarray(wp.values)
    seg = p // LANES
    sa = seg[:, :, 0:1]
    sb = seg[:, :, LANES - 1:]
    real = v != 0
    assert bool(np.all(~real | (seg == sa) | (seg == sb)))


def test_paired_stencil_unchanged():
    # banded stencils have no straddle waste at these sizes — pairing may
    # or may not fire, but the result must stay at oracle accuracy
    a = create_laplace_2d(40, 40, dtype=np.float32)
    wp = csr_to_well(a, tile_groups=2, dtype=np.float32, pair=True)
    x = np.random.default_rng(0).standard_normal(a.ncols).astype(np.float32)
    y = _apply(wp, a, x)
    want = a.matvec(x)
    err = np.abs(y - want).max() / (np.abs(want).max() + 1)
    assert err < 1e-6, err


def test_paired_ds_f64_class():
    a32 = _band_random(seed=5)
    a64 = CSRHost(rowptr=a32.rowptr, colind=a32.colind,
                  values=a32.values.astype(np.float64), ncols=a32.ncols)
    wp = csr_to_well_ds(a64, tile_groups=2, pair=True)
    assert wp.paired
    x = np.random.default_rng(2).standard_normal(2000)
    y = spmv_well_ds(wp, x)[:2000]
    want = a64.matvec(x)
    err = np.abs(y - want).max() / (np.abs(want).max() + 1)
    assert err < 1e-12, err  # double-single floor, not f32
