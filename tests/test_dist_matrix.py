"""Distributed SpMV + CG on the virtual 8-device mesh vs the serial oracle.

Exercises the full public path like the reference base test
(reference tests/test_spmv.cpp:127-144: create_matrix -> update -> mult),
across device counts {1, 2, 4, 8} and {vanilla, symmetric} — and adds the
distributed-CG coverage the reference never had.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.gen import create_laplace_1d, create_laplace_2d, gaussian_bump, random_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix
from spmv_tpu.solvers.cg import cg


def dist_matvec_oracle_check(a, n_dev, symmetric, tol=1e-12):
    A = build_dist_matrix(a, n_devices=n_dev, symmetric=symmetric)
    x_host = np.random.default_rng(a.nrows).standard_normal(a.nrows)
    x = A.to_dist(x_host)
    y = jax.jit(A.matvec)(x)
    got = A.from_dist(y)
    want = a.matvec(x_host)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < tol, (n_dev, symmetric, err)
    return A


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("gen", ["lap1d", "lap2d", "random"])
def test_dist_spmv_vanilla(n_dev, gen):
    if gen == "lap1d":
        a = create_laplace_1d(101, gamma=0.3)
    elif gen == "lap2d":
        a = create_laplace_2d(13, 11)
    else:
        a = random_csr(97, 97, 6, seed=50)
    dist_matvec_oracle_check(a, n_dev, symmetric=False)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("gen", ["lap1d", "lap2d", "random"])
def test_dist_spmv_symmetric(n_dev, gen):
    """Symmetric lower-triangle storage with remote reduce-scatter."""
    if gen == "lap1d":
        a = create_laplace_1d(101, gamma=0.3)
    elif gen == "lap2d":
        a = create_laplace_2d(13, 11)
    else:
        a = random_csr(64, 64, 5, seed=51, symmetric=True)
    A = dist_matvec_oracle_check(a, n_dev, symmetric=True)
    # symmetric stores ~half the off-diagonal entries
    assert A.symmetric


def test_dist_spmv_matches_across_device_counts():
    """The same matrix must produce identical results on any mesh size."""
    a = create_laplace_2d(16, 16)
    x_host = gaussian_bump(a.nrows)
    results = []
    for n_dev in (1, 2, 8):
        A = build_dist_matrix(a, n_devices=n_dev)
        y = A.from_dist(jax.jit(A.matvec)(A.to_dist(x_host)))
        results.append(y)
    # summation-order differences across meshes allow a few ULPs
    np.testing.assert_allclose(results[0], results[1], rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(results[0], results[2], rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("symmetric", [False, True])
def test_dist_cg_laplace(n_dev, symmetric):
    """Distributed CG to the reference demo tolerance (demos/cg.cpp:64-65),
    verified by independent residual recomputation (demos/cg.cpp:76-96)."""
    a = create_laplace_2d(12, 12)
    A = build_dist_matrix(a, n_devices=n_dev, symmetric=symmetric)
    b_host = gaussian_bump(a.nrows)
    b = A.to_dist(b_host)
    res = jax.jit(
        lambda bb: cg(A.as_linear_operator(), bb, kmax=300, rtol=1e-10)
    )(b)
    assert bool(res.converged), (n_dev, symmetric)
    x_host = A.from_dist(res.x)
    r = a.matvec(x_host) - b_host
    assert np.linalg.norm(r) / np.linalg.norm(b_host) < 1e-9


def test_dist_cg_iterations_match_serial():
    """Iteration counts and final residuals must be invariant to the mesh."""
    a = create_laplace_1d(96, gamma=0.45)
    b_host = gaussian_bump(96)
    stats = []
    for n_dev in (1, 4):
        A = build_dist_matrix(a, n_devices=n_dev)
        res = cg(A.as_linear_operator(), A.to_dist(b_host), kmax=200, rtol=1e-10)
        stats.append((int(res.iterations), float(res.rnorm)))
    assert stats[0][0] == stats[1][0]
    np.testing.assert_allclose(stats[0][1], stats[1][1], rtol=1e-6)


def test_format_size_accounting():
    a = create_laplace_1d(64)
    A = build_dist_matrix(a, n_devices=4)
    assert A.format_size_bytes() > 0
    A_sym = build_dist_matrix(a, n_devices=4, symmetric=True)
    # lower-triangle storage holds fewer stored values
    assert A_sym.local_values.shape[2] <= A.local_values.shape[2]


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_transpose_matvec(n_dev):
    """A^T x across meshes — the transpose product the reference never
    delivered (spmv/Matrix.cpp:144-148)."""
    from spmv_tpu.gen import random_csr

    a = random_csr(60, 60, 5, seed=60)
    A = build_dist_matrix(a, n_devices=n_dev)
    x_host = np.random.default_rng(61).standard_normal(60)
    got = A.from_dist(jax.jit(A.matvec_transpose)(A.to_dist(x_host)))
    want = a.to_dense().T @ x_host
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


def test_dist_transpose_symmetric_equals_forward():
    a = random_csr(40, 40, 4, seed=62, symmetric=True)
    A = build_dist_matrix(a, n_devices=4, symmetric=True)
    x = A.to_dist(np.random.default_rng(63).standard_normal(40))
    np.testing.assert_allclose(
        np.asarray(A.matvec_transpose(x)), np.asarray(A.matvec(x)), rtol=1e-12
    )


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_dia_local_format(n_dev):
    """Stencil fast path: DIA local blocks must match ELL results exactly."""
    a = create_laplace_2d(40, 26)  # 1040 rows, banded
    x_host = gaussian_bump(a.nrows)
    A_ell = build_dist_matrix(a, n_devices=n_dev)
    A_dia = build_dist_matrix(a, n_devices=n_dev, local_format="dia")
    y_ell = A_ell.from_dist(jax.jit(A_ell.matvec)(A_ell.to_dist(x_host)))
    y_dia = A_dia.from_dist(jax.jit(A_dia.matvec)(A_dia.to_dist(x_host)))
    want = a.matvec(x_host)
    assert np.linalg.norm(y_dia - want) / np.linalg.norm(want) < 1e-12
    np.testing.assert_allclose(y_dia, y_ell, rtol=1e-12, atol=1e-14)


def test_dist_dia_cg():
    a = create_laplace_2d(16, 16)
    A = build_dist_matrix(a, n_devices=4, local_format="dia")
    b_host = gaussian_bump(a.nrows)
    res = cg(A.as_linear_operator(), A.to_dist(b_host), kmax=400, rtol=1e-10)
    assert bool(res.converged)
    r = a.matvec(A.from_dist(res.x)) - b_host
    assert np.linalg.norm(r) / np.linalg.norm(b_host) < 1e-9


def test_dist_dia_rejects_unstructured():
    a = random_csr(256, 256, 8, seed=80)
    with pytest.raises(ValueError, match="diagonals"):
        build_dist_matrix(a, n_devices=2, local_format="dia")


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_dia_symmetric(n_dev):
    """Symmetric lower-triangle DIA local blocks + ELL remote reduce-scatter."""
    a = create_laplace_2d(40, 26)
    x_host = gaussian_bump(a.nrows)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia", symmetric=True)
    got = A.from_dist(jax.jit(A.matvec)(A.to_dist(x_host)))
    want = a.matvec(x_host)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
    # storage really is lower-triangle only
    assert all(o <= 0 for o in A.dia_offsets)


def test_dist_dia_symmetric_cg():
    a = create_laplace_2d(16, 16)
    A = build_dist_matrix(a, n_devices=4, local_format="dia", symmetric=True)
    b_host = gaussian_bump(a.nrows)
    res = cg(A.as_linear_operator(), A.to_dist(b_host), kmax=400, rtol=1e-10)
    assert bool(res.converged)
    r = a.matvec(A.from_dist(res.x)) - b_host
    assert np.linalg.norm(r) / np.linalg.norm(b_host) < 1e-9


def test_dist_matrix_is_pytree_jit_argument():
    """DistMatrix must pass THROUGH jit as an argument — closing over it
    embeds the matrix as literal constants in the lowered program (observed
    2 GB shipped to the compiler at 100M rows)."""
    a = create_laplace_2d(12, 10)
    A = build_dist_matrix(a, n_devices=2, symmetric=True)
    x_host = gaussian_bump(a.nrows)
    x = A.to_dist(x_host)
    f = jax.jit(lambda A_, x_: A_.matvec(x_))
    got = A.from_dist(f(A, x))
    np.testing.assert_allclose(got, a.matvec(x_host), rtol=1e-12)
    # dia variant too
    B = build_dist_matrix(a, n_devices=2, local_format="dia")
    got2 = B.from_dist(f(B, B.to_dist(x_host)))
    np.testing.assert_allclose(got2, a.matvec(x_host), rtol=1e-12)


@pytest.mark.parametrize("n_dev", [3, 5, 7])
def test_dist_spmv_odd_mesh_sizes(n_dev):
    """Non-power-of-two meshes (uneven owner ranges differ by one row)."""
    a = create_laplace_2d(13, 17)
    x_host = np.random.default_rng(99).standard_normal(a.nrows)
    A = build_dist_matrix(a, n_devices=n_dev, symmetric=True)
    got = A.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host)))
    want = a.matvec(x_host)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


def test_dist_cg_medium_scale_8dev():
    """Medium-scale sanity: 160k-row Laplacian, 8 shards, DIA local blocks,
    symmetric storage — the shape of the weak-scaling runs (BASELINE.md
    config 5) at CPU-testable size."""
    a = create_laplace_2d(400, 400)
    A = build_dist_matrix(a, n_devices=8, local_format="dia", symmetric=True)
    b_host = gaussian_bump(a.nrows)
    res = jax.jit(
        lambda A_, bb: cg(A_.as_linear_operator(), bb, kmax=60, rtol=1e-10)
    )(A, A.to_dist(b_host))
    # 60 iterations cannot converge at this size; check the residual
    # recurrence against an independent recomputation instead
    x_host = A.from_dist(res.x)
    r_true = a.matvec(x_host) - b_host
    assert abs(np.linalg.norm(r_true) - float(res.rnorm)) / float(res.rnorm) < 1e-6
    assert int(res.iterations) == 60


@pytest.mark.parametrize("n_dev", [2, 5, 8])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_dist_random_banded_fuzz(n_dev, fmt):
    """Random banded matrices (non-constant diagonals, asymmetric values,
    random missing entries) across formats and mesh sizes vs the oracle."""
    rng = np.random.default_rng(1000 + n_dev)
    n = 300
    rows, cols, vals = [], [], []
    for off in (-17, -5, -1, 0, 2, 9):
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < 0.8  # random holes
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    from spmv_tpu.formats.csr import CSRHost
    a = CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, n
    )
    x_host = rng.standard_normal(n)
    A = build_dist_matrix(a, n_devices=n_dev, local_format=fmt)
    got = A.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host)))
    want = a.matvec(x_host)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12, (n_dev, fmt)


@pytest.mark.parametrize("n_dev", [1, 2, 5, 8])
def test_dist_dia_transpose_fuzz(n_dev):
    """Distributed A^T x with DIA local blocks: random banded NON-symmetric
    matrices across mesh sizes (the round-1 NotImplementedError, now a
    DiaMatrix transform — negated offsets + shifted data)."""
    from spmv_tpu.formats.csr import CSRHost

    rng = np.random.default_rng(2000 + n_dev)
    n = 260
    rows, cols, vals = [], [], []
    for off in (-13, -4, 0, 1, 7):
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < 0.75
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    a = CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, n
    )
    x_host = rng.standard_normal(n)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia")
    got = A.from_dist(
        jax.jit(lambda A_, x_: A_.matvec_transpose(x_))(A, A.to_dist(x_host))
    )
    want = a.to_dense().T @ x_host
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12, n_dev


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_well_local_format(n_dev):
    """Distributed WELL local blocks (the general-sparsity gather path) vs
    the oracle and vs the ELL path."""
    from spmv_tpu.gen import random_csr

    a = random_csr(700, 700, 6, seed=90)
    x_host = np.random.default_rng(91).standard_normal(700)
    A_w = build_dist_matrix(a, n_devices=n_dev, local_format="well")
    A_e = build_dist_matrix(a, n_devices=n_dev, local_format="ell")
    y_w = A_w.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A_w, A_w.to_dist(x_host)))
    y_e = A_e.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A_e, A_e.to_dist(x_host)))
    want = a.matvec(x_host)
    assert np.linalg.norm(y_w - want) / np.linalg.norm(want) < 1e-12
    np.testing.assert_allclose(y_w, y_e, rtol=1e-12, atol=1e-14)


def test_dist_well_cg():
    """CG through the distributed WELL path (SPD random matrix)."""
    from spmv_tpu.gen import random_csr

    a = random_csr(300, 300, 5, seed=92, symmetric=True, spd=True) \
        if "spd" in random_csr.__code__.co_varnames else None
    if a is None:
        # diagonally dominant SPD: A = B + B^T + n*I
        b = random_csr(300, 300, 5, seed=92)
        import numpy as _np
        dense = b.to_dense()
        dense = dense + dense.T + 300 * _np.eye(300)
        from spmv_tpu.formats.csr import CSRHost
        a = CSRHost.from_dense(dense)
    A = build_dist_matrix(a, n_devices=4, local_format="well")
    b_host = gaussian_bump(a.nrows)
    res = jax.jit(
        lambda A_, bb: cg(A_.as_linear_operator(), bb, kmax=200, rtol=1e-10)
    )(A, A.to_dist(b_host))
    x_host = A.from_dist(res.x)
    r = a.matvec(x_host) - b_host
    assert np.linalg.norm(r) / np.linalg.norm(b_host) < 1e-9


def test_local_format_auto_selection():
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import select_local_format

    # f64 inputs auto-route to the double-single formats (the reference is
    # double-throughout, reference spmv/Matrix.cpp:565-566; the XLA-f64
    # emulation path)
    assert select_local_format(create_laplace_2d(16, 16)) == "dia_ds"
    assert select_local_format(random_csr(700, 700, 6, seed=1)) == "well_ds"
    assert select_local_format(
        create_laplace_2d(16, 16, dtype=np.float32)) == "dia"
    assert select_local_format(
        random_csr(700, 700, 6, seed=1, dtype=np.float32)) == "well"
    # an f32 dtype override on f64 values picks the f32 formats
    assert select_local_format(
        create_laplace_2d(16, 16), dtype=np.float32) == "dia"
    # symmetric stays on the XLA/ELL path (DS stores the full matrix)
    assert select_local_format(
        random_csr(100, 100, 4, seed=2, symmetric=True), symmetric=True
    ) == "ell"
    # auto end-to-end, f32
    a = random_csr(260, 260, 5, seed=93, dtype=np.float32)
    A = build_dist_matrix(a, n_devices=2, local_format="auto",
                          dtype=np.float32)
    assert A.local_format in ("well", "dia", "ell")
    x_host = np.random.default_rng(94).standard_normal(260).astype(np.float32)
    got = A.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host)))
    want = a.matvec(x_host)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_local_format_auto_f64_ds_end_to_end():
    """f64 matrix + auto -> DS operator whose plain matvec transparently
    splits/recombines f64 vectors (drop-in for the f64 user)."""
    a = create_laplace_2d(24, 24)  # f64
    A = build_dist_matrix(a, n_devices=2, local_format="auto")
    assert A.local_format == "dia_ds"
    x_host = np.random.default_rng(95).standard_normal(a.nrows)
    got = A.from_dist(
        jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host))
    )
    want = a.matvec(x_host)
    # DS envelope ~2^-48, far beyond f32's 2^-24
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


def test_well_gate_falls_back_on_memory_blowup():
    """Occupancy above the floor but stored bytes >> ELL: the size-aware
    gate must warn and fall back to ELL (VERDICT r2 weak item 3). Rows with
    ~4 nnz scattered over 40 distinct 128-wide segments give per-group slot
    counts K ~ 10x the ELL row width at occupancy ~0.07."""
    import warnings

    from spmv_tpu.formats.csr import CSRHost
    from spmv_tpu.parallel.dist_matrix import select_local_format

    nr, nc = 1280, 5120
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(nr), 4)
    cols = rng.integers(0, nc, size=4 * nr)
    a = CSRHost.from_coo(rows, cols,
                         rng.standard_normal(len(rows)).astype(np.float32),
                         nr, nc)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fmt = select_local_format(a, dtype=np.float32)
    assert fmt == "ell"
    assert any("WELL packing" in str(x.message) for x in w)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_well_ds_symmetric_f64_class(n_dev):
    """Symmetric general sparsity at f64-class accuracy: dual-WELL DS
    stacks + DS diagonal + error-free reverse exchange
    (comm_plan.halo_scatter_add_ds) — BOUNDARY rows included. Closes the
    last {storage mode} x {format} x {precision class} cell."""
    from spmv_tpu.ds import ds_from_f64
    from spmv_tpu.gen import random_csr

    a = random_csr(700, 700, 5, seed=95, symmetric=True, spd_shift=1.0)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="well_ds",
                          symmetric=True)
    assert A.symmetric and A.local_wellT_values is not None
    x = np.random.default_rng(96).standard_normal(700)
    xh_g, xl_g = ds_from_f64(x)
    xh = A.to_dist(xh_g.astype(np.float32))
    xl = A.to_dist(xl_g.astype(np.float32))
    yh, yl = jax.jit(lambda M, h, l: M.matvec_ds(h, l))(A, xh, xl)
    got = (A.from_dist(yh).astype(np.float64)
           + A.from_dist(yl).astype(np.float64))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


def test_dist_well_ds_symmetric_transparent_f64_matvec():
    """auto-selected symmetric f64 general matrix: plain matvec on an f64
    vector rides the DS path transparently."""
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import select_local_format

    a = random_csr(600, 600, 4, seed=97, symmetric=True, spd_shift=1.0)
    assert select_local_format(a, symmetric=True) == "well_ds"
    A = build_dist_matrix(a, n_devices=4, local_format="auto",
                          symmetric=True)
    assert A.local_format == "well_ds"
    x = np.random.default_rng(98).standard_normal(600)
    got = A.from_dist(
        jax.jit(lambda M, v: M.matvec(v))(A, A.to_dist(x)))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


def test_dist_well_ds_symmetric_two_tier():
    """Two-tier (dcn, ici) mesh: the DS reverse runs the two-tier
    error-free variant (halo_scatter_add_two_tier_ds)."""
    from jax.sharding import Mesh

    from spmv_tpu.ds import ds_from_f64
    from spmv_tpu.gen import random_csr

    a = random_csr(640, 640, 4, seed=99, symmetric=True, spd_shift=1.0)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("dcn", "ici"))
    A = build_dist_matrix(a, mesh=mesh, local_format="well_ds",
                          symmetric=True)
    x = np.random.default_rng(100).standard_normal(640)
    xh_g, xl_g = ds_from_f64(x)
    yh, yl = jax.jit(lambda M, h, l: M.matvec_ds(h, l))(
        A, A.to_dist(xh_g.astype(np.float32)),
        A.to_dist(xl_g.astype(np.float32)))
    got = (A.from_dist(yh).astype(np.float64)
           + A.from_dist(yl).astype(np.float64))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_well_symmetric_matvec(n_dev):
    """Symmetric general sparsity on the WELL device path (dual-WELL:
    L + pre-built L^T as two gather stacks, VERDICT r2 item 1) matches the
    host oracle across mesh sizes."""
    from spmv_tpu.gen import random_csr

    a = random_csr(700, 700, 5, seed=96, symmetric=True, spd_shift=1.0)
    a = CSRHost(a.rowptr, a.colind, a.values.astype(np.float32), a.ncols)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="well",
                          symmetric=True, dtype=np.float32)
    assert A.local_format == "well" and A.symmetric
    assert A.local_wellT_values is not None
    x_host = np.random.default_rng(97).standard_normal(700).astype(np.float32)
    got = A.from_dist(
        jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host))
    )
    want = a.matvec(x_host)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_dist_well_symmetric_matches_ell_bitwise_structure():
    """The dual-WELL symmetric result agrees with the ELL symmetric path
    (same partitioning, same reverse plan) to fp32 rounding."""
    from spmv_tpu.gen import random_csr

    a = random_csr(500, 500, 4, seed=98, symmetric=True, spd_shift=1.0)
    a = CSRHost(a.rowptr, a.colind, a.values.astype(np.float32), a.ncols)
    x_host = np.random.default_rng(99).standard_normal(500).astype(np.float32)
    outs = {}
    for fmt in ("well", "ell"):
        A = build_dist_matrix(a, n_devices=4, local_format=fmt,
                              symmetric=True, dtype=np.float32)
        outs[fmt] = A.from_dist(
            jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host))
        )
    np.testing.assert_allclose(outs["well"], outs["ell"], rtol=2e-5,
                               atol=2e-5)


def test_dist_well_symmetric_cg():
    """Distributed CG on a symmetric WELL operator converges and solves."""
    from spmv_tpu.gen import random_csr
    from spmv_tpu.solvers.cg import cg

    a = random_csr(600, 600, 4, seed=101, symmetric=True, spd_shift=1.2)
    a = CSRHost(a.rowptr, a.colind, a.values.astype(np.float32), a.ncols)
    A = build_dist_matrix(a, n_devices=2, local_format="well",
                          symmetric=True, dtype=np.float32)
    x_true = np.random.default_rng(102).standard_normal(600).astype(np.float32)
    b_host = a.matvec(x_true)
    res = jax.jit(
        lambda A_, bb: cg(A_.as_linear_operator(), bb, kmax=400, rtol=1e-6)
    )(A, A.to_dist(b_host))
    x_got = A.from_dist(res.x)
    rel = np.linalg.norm(a.matvec(x_got) - b_host) / np.linalg.norm(b_host)
    assert rel < 1e-5


def test_select_local_format_symmetric_well():
    from spmv_tpu.gen import random_csr
    from spmv_tpu.parallel.dist_matrix import select_local_format

    a32 = random_csr(700, 700, 5, seed=103, symmetric=True, spd_shift=1.0)
    a32 = CSRHost(a32.rowptr, a32.colind, a32.values.astype(np.float32),
                  a32.ncols)
    assert select_local_format(a32, symmetric=True) == "well"


@pytest.mark.parametrize("n_dev", [1, 4])
def test_dist_well_scattered_matrix(n_dev):
    """Globally-scattered columns: the WELL local format now handles them
    via the near/far window split (far remainder rides the ELL local arrays)
    instead of failing conversion."""
    from spmv_tpu.gen import random_csr

    a = random_csr(3000, 3000, 6, seed=7)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="well")
    x = np.random.default_rng(8).standard_normal(3000)
    got = A.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x)))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
    assert A.local_format == "well"


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_well_transpose(n_dev):
    """A^T x with WELL local blocks (was a guided NotImplementedError):
    the windowed positions scatter back to shard columns deterministically;
    the far remainder rides the ELL transpose scatter."""
    from spmv_tpu.gen import random_csr

    a = random_csr(700, 700, 6, seed=96)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="well")
    x_host = np.random.default_rng(97).standard_normal(700)
    got = A.from_dist(
        jax.jit(lambda A_, x_: A_.matvec_transpose(x_))(A, A.to_dist(x_host)),
        side="col",
    )
    want = a.to_dense().T @ x_host
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


def test_dist_well_transpose_scattered():
    """WELL transpose on a globally-scattered matrix with a tight window cap
    — exercises BOTH the windowed scatter and a non-trivial far remainder
    (forward matvec checked against the same oracle first)."""
    from spmv_tpu.gen import random_csr

    a = random_csr(8000, 8000, 6, seed=98)
    A = build_dist_matrix(a, n_devices=4, local_format="well",
                          well_wseg_cap=8)
    assert A.well_far_nnz > 0 and A.far_vals is not None, \
        "fixture should produce a far remainder"
    x_host = np.random.default_rng(99).standard_normal(8000)
    fwd = A.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x_host)))
    assert np.linalg.norm(fwd - a.matvec(x_host)) < 1e-12 * np.linalg.norm(fwd)
    got = A.from_dist(
        jax.jit(lambda A_, x_: A_.matvec_transpose(x_))(A, A.to_dist(x_host)),
        side="col",
    )
    want = a.to_dense().T @ x_host
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


def test_f64_silent_downcast_warns_when_x64_off():
    """With jax x64 OFF (the plain-process JAX default; this suite forces
    it on), f64 values through the ELL/DIA paths are silently downcast to
    f32 at device upload — build_dist_matrix must warn with guidance
    (local_format='auto' routes to the x64-independent DS formats). An
    explicit dtype, a DS format, or x64 on must stay silent."""
    import warnings

    from spmv_tpu.gen import random_csr

    a = random_csr(64, 64, 3, seed=0)  # float64 values
    assert a.dtype == np.float64
    assert jax.config.jax_enable_x64
    # x64 ON (suite default): no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        build_dist_matrix(a, n_devices=2)
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.warns(UserWarning, match="silently downcast"):
            build_dist_matrix(a, n_devices=2)
        # explicit dtype is an acknowledgement — silent
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            build_dist_matrix(a, n_devices=2, dtype=np.float32)
        # DS formats are x64-independent — silent (banded f64 auto-routes
        # to dia_ds; the random fixture above would fall back to ELL)
        ab = create_laplace_2d(8, 8)
        assert ab.dtype == np.float64
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Ads = build_dist_matrix(ab, n_devices=2, local_format="auto")
        assert Ads.local_format == "dia_ds"
    finally:
        jax.config.update("jax_enable_x64", True)
