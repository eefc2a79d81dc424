"""Hub-row degree-skew split (parallel/dist_matrix hub_* fields).

The reference's CSR row loop is indifferent to row-degree skew
(reference spmv/csr_kernels.cpp:42-50; cuSPARSE likewise,
reference spmv/cuda/csr_kernels.cuda.cu:106-151) — a 16k-nnz hub row
costs 16k ops. The row-uniform formats are NOT: one hub row inflates
every ELL row to K=16k (an observed 33 GB allocation on the 500k-row
power-law corpus matrix, BENCH_r04 corpus_error). These tests pin the
fix: hub rows leave the row-uniform formats into a gather-side hub block
(oracle parity at np in {1, 8}), the auto cap keeps the build small, and
the ELL byte ceiling fails loudly when the split is unavailable.
"""
import jax
import numpy as np
import pytest

from spmv_tpu.corpus import powerlaw_laplacian
from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.parallel.dist_matrix import _hub_split, build_dist_matrix
from spmv_tpu.reorder import rcm_reorder


def _skewed(n=2000, seed=0, hub_rows=3, hub_deg=700):
    """Uniform sparse matrix plus a few dense hub rows."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.integers(0, n, 4 * n)
    vals = rng.standard_normal(4 * n)
    for h in rng.choice(n, hub_rows, replace=False):
        c = rng.choice(n, hub_deg, replace=False)
        rows = np.concatenate([rows, np.full(hub_deg, h)])
        cols = np.concatenate([cols, c])
        vals = np.concatenate([vals, rng.standard_normal(hub_deg)])
    return CSRHost.from_coo(rows, cols, vals.astype(np.float32), n, n)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_hub_split_oracle_parity(n_dev):
    a = _skewed()
    A = build_dist_matrix(a, n_devices=n_dev, local_format="ell",
                          dtype=np.float32, hub_cap=64)
    assert A.hub_nnz > 0
    # body K is capped: the stacked local ELL no longer carries hub width
    assert A.local_values.shape[-1] <= 64
    x = np.random.default_rng(1).standard_normal(a.ncols).astype(np.float32)
    y = A.from_dist(jax.jit(lambda A_, v: A_.matvec(v))(A, A.to_dist(x)))
    want = a.matvec(x.astype(np.float64))
    err = np.linalg.norm(y[: a.nrows] - want) / np.linalg.norm(want)
    assert err < 5e-6, err


@pytest.mark.parametrize("n_dev", [1, 8])
def test_hub_transpose_parity(n_dev):
    a = _skewed(seed=3)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="ell",
                          dtype=np.float32, hub_cap=64)
    x = np.random.default_rng(2).standard_normal(a.nrows).astype(np.float32)
    yt = A.from_dist(
        jax.jit(lambda A_, v: A_.matvec_transpose(v))(
            A, A.to_dist(x, side="row")), side="col")
    want = a.transpose().matvec(x.astype(np.float64))
    err = np.linalg.norm(yt[: a.ncols] - want) / np.linalg.norm(want)
    assert err < 5e-6, err
    # the pre-built transpose operator also carries the hubs
    At = A.transposed()
    y2 = At.from_dist(At.matvec(At.to_dist(x)))
    err2 = np.linalg.norm(y2[: a.ncols] - want) / np.linalg.norm(want)
    assert err2 < 5e-6, err2


def test_hub_matmat_parity():
    a = _skewed(seed=5)
    A = build_dist_matrix(a, n_devices=8, local_format="ell",
                          dtype=np.float32, hub_cap=64)
    nrhs = 3
    x = np.random.default_rng(4).standard_normal(
        (a.ncols, nrhs)).astype(np.float32)
    y = A.from_dist_block(
        jax.jit(lambda A_, v: A_.matmat(v))(A, A.to_dist_block(x)))
    want = np.stack(
        [a.matvec(x[:, r].astype(np.float64)) for r in range(nrhs)], axis=1)
    err = np.linalg.norm(y[: a.nrows] - want) / np.linalg.norm(want)
    assert err < 5e-6, err


def test_hub_auto_cap_powerlaw():
    """The round-4 OOM config in miniature: powerlaw through auto format.
    The build must stay small and match the oracle."""
    a = powerlaw_laplacian(8000, seed=2)
    a2, _ = rcm_reorder(a)
    A = build_dist_matrix(a2, n_devices=8, local_format="auto",
                          dtype=np.float32)
    kmax = int(a2.row_nnz().max())
    if A.hub_nnz == 0:
        pytest.skip(f"degree distribution too mild to split (kmax={kmax})")
    # without the split the local ELL alone would be nrows*kmax slots
    assert A.format_size_bytes() < 0.5 * a2.nrows * kmax * 8
    x = np.random.default_rng(3).standard_normal(a2.ncols).astype(np.float32)
    y = A.from_dist(jax.jit(lambda A_, v: A_.matvec(v))(A, A.to_dist(x)))
    want = a2.matvec(x.astype(np.float64))
    err = np.linalg.norm(y[: a2.nrows] - want) / np.linalg.norm(want)
    assert err < 5e-6, err


def test_hub_split_auto_skips_uniform():
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(500), 5)
    a = CSRHost.from_coo(rows, rng.integers(0, 500, 2500),
                         rng.standard_normal(2500), 500, 500)
    body, hubs = _hub_split(a, "auto")
    assert hubs is None and body is a


def test_ell_bytes_ceiling_actionable():
    """hub_cap=None + a skewed matrix must raise the actionable ceiling
    error instead of attempting the allocation."""
    a = _skewed(n=1000, hub_deg=900)
    with pytest.raises(ValueError, match="hub_cap"):
        build_dist_matrix(a, n_devices=1, local_format="ell",
                          dtype=np.float32, hub_cap=None,
                          ell_bytes_cap=1e6)


def test_hub_checkpoint_roundtrip(tmp_path):
    from spmv_tpu.io.checkpoint import load_dist_matrix, save_dist_matrix

    a = _skewed(seed=9)
    A = build_dist_matrix(a, n_devices=8, local_format="ell",
                          dtype=np.float32, hub_cap=64)
    p = str(tmp_path / "hub_op")
    save_dist_matrix(p, A)
    B = load_dist_matrix(p)
    assert B.hub_nnz == A.hub_nnz
    x = np.random.default_rng(8).standard_normal(a.ncols).astype(np.float32)
    ya = A.from_dist(A.matvec(A.to_dist(x)))
    yb = B.from_dist(B.matvec(B.to_dist(x)))
    np.testing.assert_array_equal(ya, yb)
