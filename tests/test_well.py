"""WELL (windowed gather-ELL) format + its gather apply vs the host oracle.

The general-sparsity device path (reference parity: cuSPARSE cusparseSpMV on
arbitrary CSR, reference spmv/cuda/csr_kernels.cuda.cu:106-151). The apply
is plain JAX, so the CPU runs the same program the GPU compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.formats.well import csr_to_well, well_occupancy
from spmv_tpu.gen import create_laplace_2d, random_csr
from spmv_tpu.ops.spmv_well import spmv_well


def _check(a: CSRHost, tile_groups: int, seed: int = 0, tol: float = 1e-6):
    w = csr_to_well(a, tile_groups=tile_groups, dtype=np.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.ncols).astype(np.float32)
    xp = jnp.asarray(np.pad(x, (0, w.ncols_pad - a.ncols)))
    y = np.asarray(spmv_well(w, xp))
    want = a.matvec(x).astype(np.float32)
    err = np.linalg.norm(y[: a.nrows] - want) / max(np.linalg.norm(want), 1e-30)
    assert err < tol, (tile_groups, err)
    # padding rows stay exactly zero
    if len(y) > a.nrows:
        assert np.abs(y[a.nrows:]).max() == 0.0
    return w


@pytest.mark.parametrize("tile_groups", [2, 4])
def test_well_random(tile_groups):
    _check(random_csr(300, 300, 6, seed=1), tile_groups)


def test_well_stencil():
    _check(create_laplace_2d(20, 17), 2)


def test_well_rectangular_wide():
    _check(random_csr(200, 900, 4, seed=2), 2)


def test_well_rectangular_tall():
    _check(random_csr(700, 150, 3, seed=3), 4)


def test_well_duplicate_segment_entries():
    """Rows with several entries in the same 128-column segment need
    multiplicity slots."""
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(50), 6)
    cols = (np.tile(np.arange(6), 50) * 3 + rng.integers(0, 3, 300)) % 100
    a = CSRHost.from_coo(rows, cols, rng.standard_normal(300), 50, 100)
    _check(a, 2)


def test_well_end_of_matrix_window():
    """Windows referencing the last columns must not drop entries (the
    round-2 clamp bug: seg_rel >= wseg for end-of-matrix tiles)."""
    rng = np.random.default_rng(5)
    n = 3000
    rows, cols, vals = [], [], []
    for off in (-900, -1, 0, 2, 1100):
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < 0.8
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    a = CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, n
    )
    w = _check(a, 2)
    assert w.ncols_pad >= w.wseg * 128


def test_well_occupancy_gate():
    a = create_laplace_2d(16, 16)
    occ = well_occupancy(a, tile_groups=2)
    w = csr_to_well(a, tile_groups=2)
    assert abs(occ - w.occupancy) < 1e-12
    # a pathological group must trip max_k
    rng = np.random.default_rng(6)
    rows = np.zeros(3000, np.int64)
    cols = rng.choice(120_000, 3000, replace=False)
    bad = CSRHost.from_coo(rows, cols, np.ones(3000), 128, 120_000)
    with pytest.raises(ValueError, match="max_k"):
        csr_to_well(bad, tile_groups=2, max_k=64)


def test_well_empty_matrix():
    a = CSRHost(np.zeros(5, np.int64), np.zeros(0, np.int32), np.zeros(0), 4)
    w = csr_to_well(a, tile_groups=2)
    y = np.asarray(
        spmv_well(w, jnp.ones(w.ncols_pad, jnp.float64))
    )
    assert np.all(y == 0)


def test_well_int16_positions():
    """16-aligned tiles with small windows store int16 positions (half the
    index traffic); results identical to int32."""
    a = create_laplace_2d(64, 64)  # small window
    w16 = csr_to_well(a, tile_groups=16, dtype=np.float32)
    w32 = csr_to_well(a, tile_groups=4, dtype=np.float32)
    assert w16.pos.dtype == jnp.int16
    assert w32.pos.dtype == jnp.int32
    x = np.random.default_rng(8).standard_normal(a.ncols).astype(np.float32)
    y16 = np.asarray(spmv_well(
        w16, jnp.asarray(np.pad(x, (0, w16.ncols_pad - a.ncols)))))
    y32 = np.asarray(spmv_well(
        w32, jnp.asarray(np.pad(x, (0, w32.ncols_pad - a.ncols)))))
    np.testing.assert_array_equal(y16[: a.nrows], y32[: a.nrows])


def test_split_window_near_far():
    """Globally-scattered matrices split into a window-local near part (WELL)
    and a far remainder; the parts sum to the original exactly."""
    from spmv_tpu.formats.well import split_window
    from spmv_tpu.gen import random_csr

    a = random_csr(2000, 2000, 6, seed=1)
    near, far = split_window(a, tile_groups=2, wseg_cap=8)
    assert near.nnz + far.nnz == a.nnz
    assert far.nnz > 0  # scattered: some entries must leave the window
    np.testing.assert_allclose(near.to_dense() + far.to_dense(), a.to_dense())
    w = csr_to_well(near, tile_groups=2)
    assert w.wseg <= 8


def test_banded_matrix_has_no_far_part():
    from spmv_tpu.formats.well import split_window

    a = create_laplace_2d(20, 20)
    near, far = split_window(a, tile_groups=2, wseg_cap=64)
    assert far.nnz == 0 and near.nnz == a.nnz


# ----- symmetric dual-WELL (L + pre-built L^T, no scatters) -----


def _scrambled_spd(n, seed, k=5, dtype=np.float32):
    from spmv_tpu.gen import random_csr

    a = random_csr(n, n, k, seed=seed, symmetric=True, spd_shift=1.0)
    from spmv_tpu.formats.csr import CSRHost

    return CSRHost(a.rowptr, a.colind, a.values.astype(dtype), a.ncols)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sym_well_oracle(dtype):
    from spmv_tpu.formats.well import csr_to_well_sym
    from spmv_tpu.ops.spmv_well import spmv_well_sym

    a = _scrambled_spd(500, seed=11, dtype=dtype)
    sw = csr_to_well_sym(a, tile_groups=8, dtype=dtype)
    x = np.random.default_rng(12).standard_normal(500).astype(dtype)
    y = spmv_well_sym(sw, jnp.asarray(x))
    want = a.matvec(x)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert (np.linalg.norm(np.asarray(y)[:500] - want)
            / np.linalg.norm(want)) < tol


def test_sym_well_with_far_remainder():
    """A tight wseg_cap forces entries into the far COO remainders of both
    triangles; the combined apply must still match the oracle."""
    from spmv_tpu.formats.well import csr_to_well_sym
    from spmv_tpu.ops.spmv_well import spmv_well_sym

    a = _scrambled_spd(1500, seed=13, k=6)
    sw = csr_to_well_sym(a, tile_groups=2, wseg_cap=8)
    assert sw.farl is not None or sw.faru is not None  # split actually hit
    x = np.random.default_rng(14).standard_normal(1500).astype(np.float32)
    y = spmv_well_sym(sw, jnp.asarray(x))
    want = a.matvec(x)
    assert (np.linalg.norm(np.asarray(y)[:1500] - want)
            / np.linalg.norm(want)) < 1e-5


def test_sym_well_jit_chain():
    """jit + lane-layout chaining (solver usage pattern)."""
    from spmv_tpu.formats.well import csr_to_well_sym
    from spmv_tpu.ops.spmv_well import spmv_well_sym_2d

    a = _scrambled_spd(400, seed=15)
    sw = csr_to_well_sym(a, tile_groups=8, dtype=np.float32)
    npad = sw.nrows_pad
    x = np.zeros(npad, np.float32)
    x[:400] = np.random.default_rng(16).standard_normal(400)
    x2 = jnp.asarray(x.reshape(-1, 128))
    f = jax.jit(lambda m, v: spmv_well_sym_2d(m, v))
    y2 = f(sw, f(sw, x2))  # chained applies, shapes closed
    want = a.matvec(a.matvec(x[:400]))
    got = np.asarray(y2).reshape(-1)[:400]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4


# ----- block apply (matrix read once for all right-hand sides) -----


def _well_fixture(seed=21, n=2000, pair=False):
    a = random_csr(n, n, 6, seed=seed)
    a = CSRHost(a.rowptr, a.colind, a.values.astype(np.float32), a.ncols)
    w = csr_to_well(a, tile_groups=2, dtype=np.float32, pair=pair)
    return a, w


@pytest.mark.parametrize("pair", [False, True])
def test_well_block_apply_matches_columns(pair):
    """spmm_well_2d gathers each x row once for all columns; every column
    equals its single-vector apply and the host oracle."""
    from spmv_tpu.ops.spmv_dia import columns_to_block, block_to_columns
    from spmv_tpu.ops.spmv_well import spmm_well_2d, spmv_well_2d

    a, w = _well_fixture(seed=23, pair=pair)
    X = np.random.default_rng(24).standard_normal(
        (w.ncols_pad, 3)).astype(np.float32)
    X[a.ncols:] = 0
    Y = np.asarray(block_to_columns(spmm_well_2d(w, columns_to_block(jnp.asarray(X)))))
    for r in range(3):
        yr = np.asarray(spmv_well_2d(w, jnp.asarray(X[:, r].reshape(-1, 128))))
        np.testing.assert_allclose(Y[:, r], yr.reshape(-1), rtol=1e-6, atol=1e-6)
        want = a.matvec(X[: a.ncols, r])
        assert (np.linalg.norm(Y[: a.nrows, r] - want)
                / np.linalg.norm(want)) < 1e-5


def test_well_apply_jit_chain():
    """jit + lane-layout chaining of the vanilla apply (square operators
    are pad-equalized, so y feeds the next apply unchanged)."""
    from spmv_tpu.ops.spmv_well import spmv_well_2d

    a, w = _well_fixture(seed=25)
    assert w.nrows_pad == w.ncols_pad
    x = np.zeros(w.ncols_pad, np.float32)
    x[: a.ncols] = np.random.default_rng(26).standard_normal(a.ncols)
    f = jax.jit(spmv_well_2d)
    y2 = f(w, f(w, jnp.asarray(x.reshape(-1, 128))))
    want = a.matvec(a.matvec(x[: a.ncols]))
    got = np.asarray(y2).reshape(-1)[: a.nrows]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_sym_well_storage_halves_value_memory():
    """The dual-WELL stores ~nnz values total (L and L^T each ~nnz/2) —
    comparable to full WELL value slots, but the reference-parity check is
    that nnz accounting matches Matrix.cpp:443-444 semantics (lower + diag
    stored; effective nnz = 2*lower + diag)."""
    from spmv_tpu.formats.well import csr_to_well, csr_to_well_sym

    a = _scrambled_spd(800, seed=17)
    sw = csr_to_well_sym(a, tile_groups=8, dtype=np.float32)
    w = csr_to_well(a, tile_groups=8, dtype=np.float32)
    # stored slots of the two triangles are within 2.5x of the full matrix's
    # (occupancy varies per packing) — no pathological blowup
    assert sw.format_size_bytes() < 2.5 * w.format_size_bytes()
