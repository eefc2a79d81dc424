"""Multi-RHS SpMM (matrix read once per block — see ops/spmv_dia.py and
ops/spmv_well.py; the reference applies one vector at a time)."""
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.formats.dia import csr_to_dia
from spmv_tpu.gen import create_laplace_2d, create_laplace_3d
from spmv_tpu.ops.spmv_dia import spmm_dia


@pytest.mark.parametrize("nrhs", [1, 2, 4, 5])
def test_spmm_matches_per_vector_oracle(nrhs):
    a = create_laplace_2d(64, 64)
    d = csr_to_dia(a, dtype=np.float32, row_align=4096)
    X = np.random.default_rng(nrhs).standard_normal(
        (a.nrows, nrhs)).astype(np.float32)
    Y = np.asarray(spmm_dia(d, jnp.asarray(X)))
    for r in range(nrhs):
        want = a.matvec(X[:, r].astype(np.float64))
        err = np.linalg.norm(Y[: a.nrows, r] - want) / np.linalg.norm(want)
        assert err < 1e-5, (nrhs, r, err)


def test_spmm_3d_stencil_large_halo():
    a = create_laplace_3d(16)
    d = csr_to_dia(a, dtype=np.float32, row_align=4096)
    nrhs = 3
    X = np.random.default_rng(7).standard_normal(
        (a.nrows, nrhs)).astype(np.float32)
    Y = np.asarray(spmm_dia(d, jnp.asarray(X)))
    for r in range(nrhs):
        want = a.matvec(X[:, r].astype(np.float64))
        err = np.linalg.norm(Y[: a.nrows, r] - want) / np.linalg.norm(want)
        assert err < 1e-5, (r, err)


def test_spmm_layout_roundtrip():
    from spmv_tpu.ops.spmv_dia import spmm_from_layout, spmm_to_layout

    a = create_laplace_2d(32, 32)
    d = csr_to_dia(a, dtype=np.float32, row_align=1024)
    X = np.random.default_rng(3).standard_normal((a.nrows, 4)).astype(np.float32)
    lay = spmm_to_layout(d, jnp.asarray(X))
    back = np.asarray(spmm_from_layout(lay, 4))
    np.testing.assert_array_equal(back[: a.nrows], X)


import jax
import pytest


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_dist_matmat_matches_per_column(n_dev, fmt):
    """DistMatrix.matmat: block apply across meshes equals per-column
    matvec for every local format path."""
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(16, 24)
    A = build_dist_matrix(a, n_devices=n_dev, local_format=fmt)
    rng = np.random.default_rng(50 + n_dev)
    X = rng.standard_normal((a.nrows, 3))
    Y = A.from_dist_block(
        jax.jit(lambda M, v: M.matmat(v))(A, A.to_dist_block(X)))
    for r in range(3):
        want = a.matvec(X[:, r])
        err = np.linalg.norm(Y[:, r] - want) / np.linalg.norm(want)
        assert err < 1e-12, (n_dev, fmt, r, err)


def test_dist_matmat_symmetric_and_well():
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a_sym = create_laplace_2d(20, 20)
    A = build_dist_matrix(a_sym, n_devices=4, symmetric=True)
    rng = np.random.default_rng(60)
    X = rng.standard_normal((a_sym.nrows, 2))
    Y = A.from_dist_block(
        jax.jit(lambda M, v: M.matmat(v))(A, A.to_dist_block(X)))
    for r in range(2):
        want = a_sym.matvec(X[:, r])
        assert np.linalg.norm(Y[:, r] - want) < 1e-12 * np.linalg.norm(want)

    a_w = random_csr(700, 700, 6, seed=61)
    W = build_dist_matrix(a_w, n_devices=2, local_format="well")
    Xw = rng.standard_normal((700, 2))
    Yw = W.from_dist_block(
        jax.jit(lambda M, v: M.matmat(v))(W, W.to_dist_block(Xw)))
    for r in range(2):
        want = a_w.matvec(Xw[:, r])
        assert np.linalg.norm(Yw[:, r] - want) < 1e-12 * np.linalg.norm(want)


def test_dist_block_cg():
    """Distributed block CG: block_cg over DistMatrix.matmat (gram einsums
    psum under jit)."""
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
    from spmv_tpu.solvers.block_cg import block_cg

    a = create_laplace_2d(20, 20)
    A = build_dist_matrix(a, n_devices=4)
    rng = np.random.default_rng(70)
    B = rng.standard_normal((a.nrows, 3))
    bd = A.to_dist_block(B)
    res = jax.jit(
        lambda M, b_: block_cg(M.matmat, b_, 3, kmax=600, rtol=1e-10)
    )(A, bd)
    assert bool(res.converged)
    X = A.from_dist_block(res.x)
    for r in range(3):
        rel = np.linalg.norm(a.matvec(X[:, r]) - B[:, r]) \
            / np.linalg.norm(B[:, r])
        assert rel < 1e-9, (r, rel)


@pytest.mark.parametrize("nrhs", [1, 3])
def test_spmm_symmetric_storage(nrhs):
    """Multi-RHS through symmetric (lower-triangle) storage: the SPD class
    gets both 40% less matrix traffic and one read per block."""
    a = create_laplace_2d(64, 64)
    d = csr_to_dia(a, dtype=np.float32, row_align=4096, symmetric=True)
    X = np.random.default_rng(nrhs + 30).standard_normal(
        (a.nrows, nrhs)).astype(np.float32)
    Y = np.asarray(spmm_dia(d, jnp.asarray(X)))
    for r in range(nrhs):
        want = a.matvec(X[:, r].astype(np.float64))
        err = np.linalg.norm(Y[: a.nrows, r] - want) / np.linalg.norm(want)
        assert err < 1e-5, (nrhs, r, err)


def test_block_cg_symmetric_storage():
    from spmv_tpu.gen import gaussian_bump
    from spmv_tpu.solvers.block_cg import block_cg_dia

    a = create_laplace_2d(48, 48)
    d = csr_to_dia(a, dtype=np.float64, row_align=4096, symmetric=True)
    rng = np.random.default_rng(99)
    B = np.stack([gaussian_bump(a.nrows), rng.standard_normal(a.nrows)],
                 axis=1)
    X, res = block_cg_dia(d, B, kmax=800, rtol=1e-10)
    assert bool(res.converged)
    for r in range(2):
        rel = np.linalg.norm(a.matvec(np.asarray(X[:, r])) - B[:, r]) \
            / np.linalg.norm(B[:, r])
        assert rel < 1e-9, (r, rel)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_dist_matmat_mrhs_fast_path_with_ghosts(n_dev):
    """The production multichip configuration: f32 DIA local blocks take the
    block apply WITH nonempty ghost rounds — must match the f64 oracle per
    column."""
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(40, 32)  # banded, ghosts across shards
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia",
                          dtype=np.float32)
    assert A.local_values.dtype == np.float32
    rng = np.random.default_rng(80 + n_dev)
    X = rng.standard_normal((a.nrows, 3)).astype(np.float32)
    Y = A.from_dist_block(
        jax.jit(lambda M, v: M.matmat(v))(A, A.to_dist_block(X)))
    for r in range(3):
        want = a.matvec(X[:, r].astype(np.float64))
        err = np.linalg.norm(Y[:, r] - want) / np.linalg.norm(want)
        assert err < 1e-5, (n_dev, r, err)


@pytest.mark.parametrize("fmt", ["ell", "well", "dia"])
def test_matmat_collective_count_independent_of_nrhs(fmt):
    """Batched halo for the GENERIC matmat path (VERDICT r2 item 8): the
    lowered HLO's ppermute (collective-permute) count must not grow with
    nrhs for ANY local format."""
    from spmv_tpu.gen import create_laplace_2d, random_csr
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    if fmt == "dia":
        a = create_laplace_2d(32, 32, dtype=np.float32)
    else:
        a = random_csr(1024, 1024, 5, seed=7, dtype=np.float32)
    A = build_dist_matrix(a, n_devices=4, local_format=fmt,
                          dtype=np.float32)
    counts = {}
    for nrhs in (1, 4):
        X = np.random.default_rng(8).standard_normal(
            (a.nrows, nrhs)).astype(np.float32)
        xb = A.to_dist_block(X)
        hlo = jax.jit(lambda M, v: M.matmat(v)).lower(A, xb).compile()
        txt = hlo.as_text()
        counts[nrhs] = txt.count("collective-permute-start(") + txt.count(
            "collective-permute(")
    assert counts[4] == counts[1], counts


def test_matmat_symmetric_batched_reverse():
    """Symmetric matmat: forward AND reverse halo move as one block —
    collective count independent of nrhs, result matches per-column."""
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
    from spmv_tpu.formats.csr import CSRHost

    a0 = random_csr(600, 600, 4, seed=9, symmetric=True, spd_shift=1.0)
    a = CSRHost(a0.rowptr, a0.colind, a0.values.astype(np.float32), a0.ncols)
    A = build_dist_matrix(a, n_devices=4, local_format="ell",
                          symmetric=True, dtype=np.float32)
    X = np.random.default_rng(10).standard_normal((600, 3)).astype(np.float32)
    got = A.from_dist_block(
        jax.jit(lambda M, v: M.matmat(v))(A, A.to_dist_block(X)))
    want = a.to_dense() @ X
    np.testing.assert_allclose(got[:600], want, rtol=2e-4, atol=2e-4)
    counts = {}
    for nrhs in (1, 3):
        Xn = X[:, :nrhs]
        xb = A.to_dist_block(Xn)
        txt = jax.jit(
            lambda M, v: M.matmat(v)).lower(A, xb).compile().as_text()
        counts[nrhs] = txt.count("collective-permute-start(") + txt.count(
            "collective-permute(")
    assert counts[3] == counts[1], counts


def test_dist_matmat_well_block_fast_path():
    """f32 WELL local blocks take the block SpMM kernel
    (ops/spmv_well: matrix and positions read once for the block);
    must match the host oracle per column, with ghosts and (scattered
    matrices) the far remainder exercised."""
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    rng = np.random.default_rng(62)
    for n_dev in (1, 4):
        a_w = random_csr(900, 900, 6, seed=63, dtype=np.float32)
        W = build_dist_matrix(a_w, n_devices=n_dev, local_format="well",
                              dtype=np.float32)
        assert W.local_well_values.dtype == jnp.float32  # gate active
        Xw = rng.standard_normal((900, 3)).astype(np.float32)
        Yw = W.from_dist_block(
            jax.jit(lambda M, v: M.matmat(v))(W, W.to_dist_block(Xw)))
        for r in range(3):
            want = a_w.matvec(Xw[:, r])
            err = (np.linalg.norm(Yw[:, r] - want)
                   / max(np.linalg.norm(want), 1e-30))
            assert err < 1e-6, (n_dev, r, err)


def _banded_random_spd(n=2000, seed=0, diag=3.0):
    """Unique-columns banded-random symmetric SPD host matrix (the WELL
    window split keeps everything near; multiplicity 1 keeps K small)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in (-170, -1, 1, 130):
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < 0.8
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)) * 0.1)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    i = np.concatenate([rows, cols, np.arange(n)])
    j = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, diag)])
    from spmv_tpu.formats.csr import CSRHost

    return CSRHost.from_coo(i, j, v, n, n)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_well_ds_matmat_ds_f64_class(n_dev):
    """DS WELL block SpMM through the distributed path: every column at
    the double-single floor (ops/spmv_well DS block gather + per-column
    DS far chains + DS block halos)."""
    from spmv_tpu.ds import ds_from_f64
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    rng = np.random.default_rng(1)
    n, nrhs = 1700, 3
    rows = rng.integers(0, n, 9000)
    cols = np.clip(rows + rng.integers(-500, 500, 9000), 0, n - 1)
    from spmv_tpu.formats.csr import CSRHost

    a = CSRHost.from_coo(rows, cols, rng.standard_normal(9000), n, n)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="well_ds")
    X = rng.standard_normal((n, nrhs))
    Xh, Xl = ds_from_f64(X)
    yh, yl = jax.jit(lambda M, h, l: M.matmat_ds(h, l))(
        A, A.to_dist_block(Xh), A.to_dist_block(Xl))
    Yh = A.from_dist_block(yh)
    Yl = A.from_dist_block(yl)
    for r in range(nrhs):
        got = Yh[:, r].astype(np.float64) + Yl[:, r].astype(np.float64)
        want = a.matvec(X[:, r])
        err = np.abs(got - want).max() / (np.abs(want).max() + 1)
        assert err < 1e-13, (n_dev, r, err)


def test_block_cg_refined_dist_well():
    """f64-class distributed multi-RHS refinement on GENERAL sparsity:
    fp32 WELL block SpMM inner + DS WELL block-SpMM true residuals."""
    from spmv_tpu.solvers.block_cg import block_cg_refined_dist

    a = _banded_random_spd()
    rng = np.random.default_rng(2)
    B = rng.standard_normal((a.nrows, 3))
    X, outers, inners, rnorms = block_cg_refined_dist(
        a, B, n_devices=4, local_format="well", rtol=1e-12, max_outer=8)
    for r in range(3):
        rel = (np.linalg.norm(a.matvec(X[:, r]) - B[:, r])
               / np.linalg.norm(B[:, r]))
        assert rel < 1e-12, (r, rel)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_dist_matmat_well_symmetric_block(n_dev):
    """Symmetric dual-WELL block matmat: two SpMM passes (L, pre-built
    L^T) + per-column diag/far terms + batched reverse exchange — must
    match the host oracle per column."""
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    rng = np.random.default_rng(64)
    a0 = random_csr(700, 700, 5, seed=65, symmetric=True, spd_shift=2.0)
    from spmv_tpu.formats.csr import CSRHost

    a = CSRHost(a0.rowptr, a0.colind, a0.values.astype(np.float32),
                a0.ncols)
    A = build_dist_matrix(a, n_devices=n_dev, symmetric=True,
                          local_format="well", dtype=np.float32)
    X = rng.standard_normal((700, 3)).astype(np.float32)
    Y = A.from_dist_block(
        jax.jit(lambda M, v: M.matmat(v))(A, A.to_dist_block(X)))
    for r in range(3):
        want = a.matvec(X[:, r])
        err = (np.linalg.norm(Y[:, r] - want)
               / max(np.linalg.norm(want), 1e-30))
        assert err < 1e-5, (n_dev, r, err)
