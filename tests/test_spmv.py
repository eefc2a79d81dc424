"""Single-device SpMV vs the sequential oracle.

Mirrors the reference's oracle strategy (reference tests/test_spmv.cpp:72-80:
dense row-loop computed redundantly, compared by global L2 norm) — plus
elementwise comparison, fp32 coverage, and the transpose product the
reference never tests (SURVEY.md section 4 "what is NOT tested").
Includes the reference's hard-coded 5x5/15-nnz fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.formats.dia import csr_to_dia
from spmv_tpu.formats.ell import csr_to_ell
from spmv_tpu.gen import create_laplace_1d, create_laplace_2d, gaussian_bump, random_csr
from spmv_tpu.ops.spmv_dia import spmv_dia
from spmv_tpu.ops.spmv_ell import spmv_ell, spmv_ell_transpose


def fixture_5x5():
    """The reference test fixture: 5x5, 15 nnz, symmetric
    (reference tests/test_spmv.cpp:56-70 uses a small hard-coded CSR)."""
    dense = np.array(
        [
            [4.0, -1.0, 0.0, -1.0, 0.0],
            [-1.0, 4.0, -1.0, 0.0, -1.0],
            [0.0, -1.0, 4.0, 0.0, 0.0],
            [-1.0, 0.0, 0.0, 4.0, -1.0],
            [0.0, -1.0, 0.0, -1.0, 4.0],
        ]
    )
    assert (dense != 0).sum() == 15
    return CSRHost.from_dense(dense)


def rel_err(got, want):
    got = np.asarray(got)[: len(want)]
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def test_fixture_ell_matches_oracle():
    a = fixture_5x5()
    x = gaussian_bump(5)
    want = a.matvec(x)
    got = spmv_ell(csr_to_ell(a), jnp.asarray(x))
    assert rel_err(got, want) < 1e-14
    np.testing.assert_allclose(np.asarray(got)[5:], 0)


def test_fixture_symmetric_storage_matches():
    a = fixture_5x5()
    x = gaussian_bump(5)
    want = a.matvec(x)
    got = spmv_ell(csr_to_ell(a, symmetric=True), jnp.asarray(x))
    assert rel_err(got, want) < 1e-14


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13), (np.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(5, 5), (64, 64), (100, 37), (33, 129)])
def test_ell_random(dtype, tol, shape):
    a = random_csr(*shape, 5, seed=shape[0], dtype=dtype)
    x = np.random.default_rng(9).standard_normal(shape[1]).astype(dtype)
    got = spmv_ell(csr_to_ell(a, k_align=4), jnp.asarray(x))
    assert rel_err(got, a.matvec(x)) < tol


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13), (np.float32, 1e-5)])
def test_ell_symmetric_random(dtype, tol):
    a = random_csr(40, 40, 4, seed=11, dtype=dtype, symmetric=True)
    x = np.random.default_rng(12).standard_normal(40).astype(dtype)
    got = spmv_ell(csr_to_ell(a, symmetric=True), jnp.asarray(x))
    assert rel_err(got, a.matvec(x)) < tol


def test_ell_alpha_beta():
    """GEMV semantics of SubMatrix::mult(alpha, in, beta, out)
    (reference spmv/sub_matrix.h)."""
    a = random_csr(24, 24, 3, seed=13)
    e = csr_to_ell(a)
    x = np.random.default_rng(14).standard_normal(24)
    y = np.random.default_rng(15).standard_normal(e.nrows_pad)
    got = spmv_ell(e, jnp.asarray(x), alpha=2.5, beta=-0.5, y=jnp.asarray(y))
    want = 2.5 * a.matvec(x) - 0.5 * y[:24]
    assert rel_err(np.asarray(got)[:24], want) < 1e-13


def test_ell_transpose():
    a = random_csr(20, 31, 4, seed=16)
    x = np.random.default_rng(17).standard_normal(20)
    got = spmv_ell_transpose(csr_to_ell(a), jnp.asarray(x))
    want = a.to_dense().T @ x
    assert rel_err(np.asarray(got)[:31], want) < 1e-13


@pytest.mark.parametrize("gen", ["lap1d", "lap2d"])
def test_dia_matches_ell_and_oracle(gen):
    a = create_laplace_1d(200, 0.3) if gen == "lap1d" else create_laplace_2d(17, 13)
    x = gaussian_bump(a.ncols)
    want = a.matvec(x)
    got_dia = spmv_dia(csr_to_dia(a), jnp.asarray(x))
    got_ell = spmv_ell(csr_to_ell(a), jnp.asarray(x))
    assert rel_err(got_dia, want) < 1e-14
    assert rel_err(got_ell, want) < 1e-14


def test_dia_alpha_beta():
    a = create_laplace_1d(50)
    d = csr_to_dia(a)
    x = np.random.default_rng(18).standard_normal(50)
    y = np.random.default_rng(19).standard_normal(d.nrows_pad)
    got = spmv_dia(d, jnp.asarray(x), alpha=3.0, beta=2.0, y=jnp.asarray(y))
    want = 3.0 * a.matvec(x) + 2.0 * y[:50]
    assert rel_err(np.asarray(got)[:50], want) < 1e-13


def test_dia_rectangular_wide():
    """Band reaching beyond the square part (ncols > nrows)."""
    rows = np.array([0, 0, 1, 1, 2])
    cols = np.array([0, 3, 1, 4, 2])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    a = CSRHost.from_coo(rows, cols, vals, 3, 5)
    x = np.arange(1.0, 6.0)
    got = spmv_dia(csr_to_dia(a), jnp.asarray(x))
    assert rel_err(np.asarray(got)[:3], a.matvec(x)) < 1e-14


def test_dia_pallas_interpret_matches_oracle():
    """The lane-layout DIA apply (spmv_dia_2d, the solver hot path) vs the
    oracle — including lane-crossing offsets (+-1) and row offsets
    (+-nx)."""
    from spmv_tpu.ops.spmv_dia import dia_to_2d, spmv_dia_2d

    a = create_laplace_2d(128, 16)  # offsets (-128, -1, 0, 1, 128)
    d = csr_to_dia(a, dtype=np.float32)
    x = np.random.default_rng(77).standard_normal(a.ncols).astype(np.float32)
    x2 = dia_to_2d(d, jnp.asarray(x))
    got = np.asarray(jax.jit(spmv_dia_2d)(d, x2)).reshape(-1)[: a.nrows]
    want = a.matvec(x.astype(np.float64))
    assert rel_err(got, want) < 1e-5


def test_dia_pallas_interpret_odd_offsets():
    """Offsets with arbitrary lane remainders (nx not a multiple of 128)."""
    from spmv_tpu.ops.spmv_dia import dia_to_2d, spmv_dia_2d

    a = create_laplace_2d(70, 16)  # offsets (-70, -1, 0, 1, 70): r=70, 58
    d = csr_to_dia(a, dtype=np.float32)
    x = np.random.default_rng(78).standard_normal(a.ncols).astype(np.float32)
    got = np.asarray(spmv_dia_2d(d, dia_to_2d(d, jnp.asarray(x))))
    want = a.matvec(x.astype(np.float64))
    assert rel_err(got.reshape(-1)[: a.nrows], want) < 1e-5


def test_dia_symmetric_matches_full():
    """Lower-triangle-only DIA (no scatter needed: transpose of a diagonal
    is a shifted diagonal) must equal the full-storage result."""
    for gen_a in (create_laplace_1d(200, 0.3), create_laplace_2d(17, 13)):
        x = gaussian_bump(gen_a.ncols)
        d_full = csr_to_dia(gen_a)
        d_sym = csr_to_dia(gen_a, symmetric=True)
        assert all(o <= 0 for o in d_sym.offsets)
        assert d_sym.nnz_stored < d_full.nnz_stored
        y_full = spmv_dia(d_full, jnp.asarray(x))
        y_sym = spmv_dia(d_sym, jnp.asarray(x))
        want = gen_a.matvec(x)
        assert rel_err(y_sym, want) < 1e-14
        np.testing.assert_allclose(
            np.asarray(y_sym)[: gen_a.nrows], np.asarray(y_full)[: gen_a.nrows],
            rtol=1e-13, atol=1e-15,
        )


def test_dia_symmetric_random_banded():
    """Symmetric banded matrix with non-constant diagonal values."""
    rng = np.random.default_rng(90)
    n = 100
    dense = np.zeros((n, n))
    for off in (0, 1, 3):
        v = rng.standard_normal(n - off)
        dense += np.diag(v, off)
        if off:
            dense += np.diag(v, -off)
    a = CSRHost.from_dense(dense)
    x = rng.standard_normal(n)
    d_sym = csr_to_dia(a, symmetric=True)
    got = spmv_dia(d_sym, jnp.asarray(x))
    assert rel_err(got, dense @ x) < 1e-13


def test_dia_sym_pallas_interpret():
    """Symmetric DIA storage through the lane-layout apply: lane-crossing
    and row offsets, vs the oracle."""
    from spmv_tpu.ops.spmv_dia import dia_to_2d, spmv_dia_2d

    for nx, ny in ((128, 64), (70, 120)):
        a = create_laplace_2d(nx, ny)
        d = csr_to_dia(a, dtype=np.float32, symmetric=True, row_align=4096)
        x = np.random.default_rng(91).standard_normal(a.ncols).astype(np.float32)
        x2 = dia_to_2d(d, jnp.asarray(x))
        got = np.asarray(spmv_dia_2d(d, x2)).reshape(-1)
        want = a.matvec(x.astype(np.float64))
        assert rel_err(got[: a.nrows], want) < 1e-5, (nx, ny)


def test_bf16_storage_ell_and_dia():
    """bfloat16 matrix storage (halves HBM traffic for bandwidth-bound SpMV);
    accuracy degrades to ~1e-2 relative, which is the expected bf16 epsilon
    for short dot products."""
    a = create_laplace_2d(20, 20)
    x = gaussian_bump(a.nrows, dtype=np.float32)
    want = a.matvec(x.astype(np.float64))
    e = csr_to_ell(a, dtype=jnp.bfloat16)
    d = csr_to_dia(a, dtype=jnp.bfloat16)
    y_e = np.asarray(spmv_ell(e, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    y_d = np.asarray(spmv_dia(d, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    assert rel_err(y_e[: a.nrows], want) < 4e-2
    assert rel_err(y_d[: a.nrows], want) < 4e-2


@pytest.mark.parametrize("row_align", [128, 1024, 12288])
def test_dia_sym_padding_sweep(row_align):
    """Symmetric storage with padding rows past the matrix: the shifted
    transpose terms must read zeros there, whatever the padding."""
    from spmv_tpu.ops.spmv_dia import dia_to_2d, spmv_dia_2d

    a = create_laplace_2d(64, 96)
    d = csr_to_dia(a, dtype=np.float32, symmetric=True, row_align=row_align)
    x = np.random.default_rng(17).standard_normal(a.ncols).astype(np.float32)
    got = np.asarray(spmv_dia_2d(d, dia_to_2d(d, jnp.asarray(x)))).reshape(-1)
    want = a.matvec(x.astype(np.float64))
    assert rel_err(got[: a.nrows], want) < 1e-5
    assert np.all(got[a.nrows:] == 0)


def test_dia_sym_pallas_bf16_interpret():
    """bf16 symmetric storage through the lane-layout apply."""
    from spmv_tpu.ops.spmv_dia import dia_to_2d, spmv_dia_2d

    a = create_laplace_2d(48, 48)
    d = csr_to_dia(a, dtype=jnp.bfloat16, symmetric=True, row_align=2048)
    x = np.random.default_rng(19).standard_normal(a.ncols).astype(np.float32)
    x2 = dia_to_2d(d, jnp.asarray(x)).astype(jnp.bfloat16)
    got = np.asarray(spmv_dia_2d(d, x2)).astype(np.float64).reshape(-1)
    want = a.matvec(x.astype(np.float64))
    assert rel_err(got[: a.nrows], want) < 3e-2


@pytest.mark.parametrize("symmetric", [False, True])
def test_dia_2d_bitwise_equals_flat(symmetric):
    """The lane-layout apply and the flat spmv_dia are one computation:
    bitwise-equal results."""
    from spmv_tpu.ops.spmv_dia import spmv_dia_2d

    a = create_laplace_2d(128, 128, dtype=np.float32)
    d = csr_to_dia(a, dtype=np.float32, symmetric=symmetric)
    x = np.random.default_rng(5).standard_normal(d.nrows_pad).astype(
        np.float32)
    y2 = np.asarray(spmv_dia_2d(d, jnp.asarray(x.reshape(-1, 128))))
    y1 = np.asarray(spmv_dia(d, jnp.asarray(x)))
    np.testing.assert_array_equal(y2.reshape(-1), y1)
    want = a.matvec(x[: a.nrows])
    assert rel_err(y1[: a.nrows], want) < 1e-6


@pytest.mark.parametrize("symmetric", [False, True])
def test_dia_block_apply_matches_columns(symmetric):
    """The block (nrhs*128-lane) apply reads the matrix once for all
    columns; each column equals its own single-vector apply."""
    from spmv_tpu.ops.spmv_dia import spmm_dia_2d, spmm_from_layout, spmm_to_layout, spmv_dia_2d

    a = create_laplace_2d(128, 128, dtype=np.float32)
    d = csr_to_dia(a, dtype=np.float32, symmetric=symmetric)
    X = np.random.default_rng(7).standard_normal(
        (d.nrows_pad, 3)).astype(np.float32)
    Y = np.asarray(spmm_from_layout(
        spmm_dia_2d(d, spmm_to_layout(d, jnp.asarray(X))), 3))
    for r in range(3):
        yr = np.asarray(spmv_dia_2d(d, jnp.asarray(X[:, r].reshape(-1, 128))))
        np.testing.assert_array_equal(Y[:, r], yr.reshape(-1))
