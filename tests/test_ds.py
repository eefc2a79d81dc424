"""Double-single (two-float32) arithmetic + the DS DIA kernel vs f64 oracle.

Double-single carries ~48 significand bits from f32 storage and arithmetic
(the reference is double-throughout, reference spmv/Matrix.cpp:565-566).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.ds import (
    ds_add,
    ds_from_f64,
    ds_mul_f32,
    ds_to_f64,
    two_prod,
    two_sum,
)
from spmv_tpu.gen import create_laplace_1d, create_laplace_2d
from spmv_tpu.ops.spmv_dia_ds import (
    csr_to_dia_ds,
    spmv_dia_ds,
)


def test_two_sum_exact():
    a = jnp.float32(1e8)
    b = jnp.float32(1.5)
    s, e = two_sum(a, b)
    assert float(s) + float(e) == 1e8 + 1.5  # exact in f64
    assert float(e) != 0.0  # the f32 sum alone loses the 1.5... partially


def test_two_prod_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact
    )


def test_ds_roundtrip_and_arithmetic():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(1000) * np.exp(rng.uniform(-20, 20, 1000))
    hi, lo = ds_from_f64(v)
    np.testing.assert_allclose(ds_to_f64(hi, lo), v, rtol=2e-15)
    w = rng.standard_normal(1000)
    whi, wlo = ds_from_f64(w)
    sh, sl = ds_add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(whi), jnp.asarray(wlo))
    np.testing.assert_allclose(ds_to_f64(np.asarray(sh), np.asarray(sl)), v + w,
                               rtol=1e-13)
    ph, plo = ds_mul_f32(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(whi), jnp.asarray(wlo))
    np.testing.assert_allclose(ds_to_f64(np.asarray(ph), np.asarray(plo)), v * w,
                               rtol=1e-13)


@pytest.mark.parametrize("gen", ["lap2d", "lap1d"])
def test_ds_dia_kernel_f64_class(gen):
    rng = np.random.default_rng(2)
    a = (create_laplace_2d(40, 33) if gen == "lap2d"
         else create_laplace_1d(5000, gamma=0.37))
    # perturb values below f32 resolution so plain-f32 storage would fail
    a.values[:] = a.values * (1 + 1e-9 * rng.standard_normal(a.nnz))
    d = csr_to_dia_ds(a, row_align=1024)
    x = rng.standard_normal(a.nrows) * 1e3
    y = spmv_dia_ds(d, x)[: a.nrows]
    want = a.matvec(x)
    err = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert err < 1e-13, err
    # an f32-storage path cannot see the 1e-9 value perturbations at all
    f32_err = np.linalg.norm(
        a.matvec(x.astype(np.float32).astype(np.float64)).astype(np.float32)
        .astype(np.float64) - want
    ) / np.linalg.norm(want)
    assert err < f32_err / 10


def test_ds_well_general_sparsity_f64_class():
    """Double-single WELL: f64-class GENERAL sparsity (values perturbed
    below f32 resolution must survive)."""
    from spmv_tpu.gen import random_csr
    from spmv_tpu.ops.spmv_well import csr_to_well_ds, spmv_well_ds

    rng = np.random.default_rng(0)
    a = random_csr(600, 600, 6, seed=1)
    a.values[:] = a.values * (1 + 1e-10 * rng.standard_normal(a.nnz))
    w = csr_to_well_ds(a, tile_groups=2)
    x = rng.standard_normal(a.ncols) * 1e2
    y = spmv_well_ds(w, x)[: a.nrows]
    want = a.matvec(x)
    err = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert err < 1e-13, err
