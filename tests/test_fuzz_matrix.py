"""Cross-format consistency fuzz: every local format must produce the same
answer on the same random matrix across mesh shapes and dtypes.

One sweep replaces many hand-written cases: random banded matrices (holes,
asymmetric values, uneven diagonals) are built once per seed; every
(format, mesh) combination must match the host oracle AND each other.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.parallel.dist_matrix import build_dist_matrix


def _random_banded(n, offsets, seed, density=0.8):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < density
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    return CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, n
    )


MESHES = [("1d", 1), ("1d", 3), ("1d", 8), ("2d", (2, 4))]


def _mesh(kind, shape):
    if kind == "1d":
        return Mesh(np.array(jax.devices()[:shape]), ("shards",))
    devs = np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, ("dcn", "ici"))


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("mesh_kind,mesh_shape", MESHES)
def test_formats_agree_across_meshes(seed, mesh_kind, mesh_shape):
    a = _random_banded(400, (-37, -5, -1, 0, 2, 19), seed)
    x = np.random.default_rng(seed + 1).standard_normal(a.nrows)
    want = a.matvec(x)
    mesh = _mesh(mesh_kind, mesh_shape)
    results = {}
    for fmt in ("ell", "dia", "well"):
        A = build_dist_matrix(a, mesh=mesh, local_format=fmt)
        got = A.from_dist(
            jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x))
        )
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < 1e-12, (fmt, mesh_kind, mesh_shape, err)
        results[fmt] = got
    # formats agree with each other to the same bar
    np.testing.assert_allclose(results["ell"], results["dia"], rtol=1e-12)
    np.testing.assert_allclose(results["ell"], results["well"], rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dtype_sweep(dtype):
    a = _random_banded(300, (-9, -1, 0, 3), 21)
    x = np.random.default_rng(22).standard_normal(a.nrows)
    tol = 2e-6 if dtype == np.float32 else 1e-12
    for fmt in ("ell", "dia", "well"):
        A = build_dist_matrix(a, n_devices=4, local_format=fmt, dtype=dtype)
        got = A.from_dist(
            jax.jit(lambda A_, x_: A_.matvec(x_))(
                A, A.to_dist(x.astype(dtype))
            )
        ).astype(np.float64)
        err = np.linalg.norm(got - a.matvec(x)) / np.linalg.norm(a.matvec(x))
        assert err < tol, (fmt, dtype, err)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_transpose_consistency_fuzz(seed):
    """<A^T y, x> == <y, A x> for random matrices across formats."""
    a = _random_banded(260, (-13, -4, 0, 1, 7), seed, density=0.75)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal(a.nrows)
    y = rng.standard_normal(a.nrows)
    for fmt in ("ell", "dia"):
        A = build_dist_matrix(a, n_devices=4, local_format=fmt)
        ax = A.from_dist(jax.jit(lambda A_, v: A_.matvec(v))(A, A.to_dist(x)))
        aty = A.from_dist(
            jax.jit(lambda A_, v: A_.matvec_transpose(v))(
                A, A.to_dist(y, side="row")
            ),
            side="col",
        )
        np.testing.assert_allclose(np.dot(aty, x), np.dot(y, ax), rtol=1e-11)


def test_complex_spmv_parity():
    """Complex dtype parity: the reference's dtype traits cover
    complex<float>/complex<double> (reference spmv/mpi_utils.h:55-77,
    latent — Matrix only instantiates float/double). Here complex SpMV works
    through the ELL path single-device AND distributed."""
    import jax.numpy as jnp

    from spmv_tpu.formats.ell import csr_to_ell
    from spmv_tpu.ops.spmv_ell import spmv_ell

    rng = np.random.default_rng(0)
    n = 120
    rows = rng.integers(0, n, 600)
    cols = rng.integers(0, n, 600)
    vals = rng.standard_normal(600) + 1j * rng.standard_normal(600)
    a = CSRHost.from_coo(rows, cols, vals, n, n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = a.to_dense() @ x

    y = np.asarray(spmv_ell(csr_to_ell(a), jnp.asarray(x)))[:n]
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-14
    # oracle matvec handles complex too
    np.testing.assert_allclose(a.matvec(x), want, rtol=1e-13)

    A = build_dist_matrix(a, n_devices=4)
    got = A.from_dist(jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(x)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-14


def test_complex_dia_path_and_solver():
    """Complex banded matrices through the DIA conversion (bincount splits
    real/imag) and XLA apply, end-to-end into GMRES."""
    import jax.numpy as jnp

    from spmv_tpu.formats.dia import csr_to_dia
    from spmv_tpu.ops.spmv_dia import spmv_dia
    from spmv_tpu.solvers.gmres import gmres

    rng = np.random.default_rng(4)
    n = 300
    rows, cols, vals = [], [], []
    for off in (-3, 0, 2):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        v = rng.standard_normal(len(i)) + 1j * rng.standard_normal(len(i))
        if off == 0:
            v = v + 8.0
        vals.append(v)
    a = CSRHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), n, n)
    d = csr_to_dia(a)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = np.asarray(spmv_dia(
        d, jnp.asarray(np.pad(x, (0, d.nrows_pad - n)))))[:n]
    want = a.to_dense() @ x
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-13

    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    bp = jnp.asarray(np.pad(b, (0, d.nrows_pad - n)))
    res = gmres(lambda v: spmv_dia(d, v), bp,
                restart=25, max_cycles=20, rtol=1e-10)
    assert bool(res.converged)
    xs = np.asarray(res.x)[:n]
    rel = np.linalg.norm(a.to_dense() @ xs - b) / np.linalg.norm(b)
    assert rel < 1e-9, rel


def test_complex_dia_distributed():
    """Complex banded matrices through build_dist_matrix(local_format='dia')
    — the assembly bincount splits real/imag like the single-device
    converter (auto-selection picks 'dia' for banded complex input)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    n = 260
    rows, cols, vals = [], [], []
    for off in (-2, 0, 1):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i))
                    + 1j * rng.standard_normal(len(i)))
    a = CSRHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), n, n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = a.to_dense() @ x
    A = build_dist_matrix(a, n_devices=4, local_format="auto")
    assert A.local_format == "dia"
    got = A.from_dist(jax.jit(lambda M, v: M.matvec(v))(A, A.to_dist(x)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


def _random_symmetric(n, offsets, seed, density=0.8):
    """Symmetric SPD-ish banded random (built sparse — no dense blowup)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(len(i)) < density
        i = i[keep]
        rows.append(i)
        cols.append(i + off)
        vals.append(-np.abs(rng.standard_normal(len(i))))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals)
    r2 = np.concatenate([r, c])
    c2 = np.concatenate([c, r])
    v2 = np.concatenate([v, v])
    d = np.zeros(n)
    np.add.at(d, r2, np.abs(v2))
    r3 = np.concatenate([r2, np.arange(n)])
    c3 = np.concatenate([c2, np.arange(n)])
    v3 = np.concatenate([v2, d + 1.0])
    return CSRHost.from_coo(r3, c3, v3, n, n)


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("mesh_kind,mesh_shape", MESHES)
def test_symmetric_formats_agree_across_meshes(seed, mesh_kind, mesh_shape):
    """Symmetric storage sweep: ELL scatter-add, DIA carry, dual-WELL, and
    the f64-class dual-WELL DS all match the oracle and each other on
    every mesh shape."""
    from spmv_tpu.ds import ds_from_f64

    a = _random_symmetric(520, (-41, -7, -1), seed)
    a32 = CSRHost(a.rowptr, a.colind, a.values.astype(np.float32), a.ncols)
    x = np.random.default_rng(seed + 1).standard_normal(a.nrows)
    want = a.matvec(x)
    mesh = _mesh(mesh_kind, mesh_shape)
    results = {}
    for fmt in ("ell", "dia", "well"):
        src = a32 if fmt == "well" else a
        A = build_dist_matrix(src, mesh=mesh, local_format=fmt,
                              symmetric=True,
                              dtype=np.float32 if fmt == "well" else None)
        got = A.from_dist(
            jax.jit(lambda A_, x_: A_.matvec(x_))(
                A, A.to_dist(x.astype(A.dtype))))
        tol = 2e-5 if fmt == "well" else 1e-12
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < tol, (fmt, mesh_kind, mesh_shape, err)
        results[fmt] = got
    # f64-class symmetric general path
    A = build_dist_matrix(a, mesh=mesh, local_format="well_ds",
                          symmetric=True)
    xh_g, xl_g = ds_from_f64(x)
    yh, yl = jax.jit(lambda M, h, l: M.matvec_ds(h, l))(
        A, A.to_dist(xh_g.astype(np.float32)),
        A.to_dist(xl_g.astype(np.float32)))
    got = (A.from_dist(yh).astype(np.float64)
           + A.from_dist(yl).astype(np.float64))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-13, ("well_ds", mesh_kind, mesh_shape, err)
