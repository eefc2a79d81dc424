"""DistMatrix — the sharded distributed matrix (reference L4, Matrix<T>).

Holds the local/remote ELL blocks of every shard stacked along a 1-D device
mesh axis, plus the CommPlan. ``mult`` runs inside ``jax.shard_map``:

    ghosts = halo_gather(x)            # ppermute rounds over ICI
    y  = local_block @ x               # no dependence on the halo
    y += remote_block @ ghosts         # first use of received values

Because the local block never reads the ghost buffer, XLA's latency-hiding
scheduler can run the halo collectives concurrently with the interior SpMV —
the comm/compute overlap the reference gets from nonblocking MPI plus an
explicit split mult (reference spmv/Matrix.cpp:498-511 ``spmv_overlap``,
spmv/L2GMap.cpp:528-561). The local/remote column split itself mirrors
reference spmv/Matrix.h:116-117.

Rectangular operators (restriction/prolongation — the intent of the
reference's broken restrictmain demo, reference demos/restrictmain.cpp:60-91)
partition rows and columns independently: input vectors are column-
partitioned (each shard owns cols [col_ranges[s], col_ranges[s+1])), outputs
row-partitioned, and the CommPlan is compiled over the COLUMN ownership.
Square matrices reduce to identical partitions on both sides.

The symmetric path (square only) stores the strict lower triangle plus
diagonal (reference spmv/Matrix.cpp:337-349): transpose contributions to
owned columns are a deterministic scatter-add, and contributions to ghost
columns are pushed back to their owners with the reverse plan — the "remote
reduce-scatter".

Distributed CG needs no separate implementation: ``DistMatrix.matvec`` plugs
into ``spmv_tpu.solvers.cg`` as the operator, and global dots over sharded
vectors lower to psum automatically under jit (replacing the reference's
MPI_Allreduce calls, spmv/cg.cpp:49,65,75).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.ops.spmv_dia import block_to_columns, columns_to_block, dia_apply
from spmv_tpu.ops.spmv_dia_ds import dia_ds_apply
from spmv_tpu.ops.spmv_well import well_apply_block, well_ds_apply
from spmv_tpu.parallel.partition import ShardCSR, owner_ranges, partition_csr
from spmv_tpu.parallel.comm_plan import (
    CommPlan,
    CommPlan2,
    compile_plan,
    compile_plan_two_tier,
    halo_gather,
    halo_gather_two_tier,
    halo_scatter_add,
    halo_scatter_add_two_tier,
)


_HI = jax.lax.Precision.HIGHEST


def _plan_tables(plan):
    """The per-device index tables a plan ships into shard_map."""
    if isinstance(plan, CommPlan2):
        return (plan.ici_send_idx, plan.ici_recv_pos,
                plan.dcn_send_idx, plan.dcn_recv_pos)
    return (plan.send_idx, plan.recv_pos)


def _plan_gather(plan, x, tables, axes):
    if isinstance(plan, CommPlan2):
        return halo_gather_two_tier(
            x, *tables, plan.rounds_ici, plan.rounds_dcn,
            plan.n_dcn, plan.n_ici, plan.nghost_pad, axes[0], axes[1],
        )
    return halo_gather(
        x, tables[0], tables[1], plan.rounds, plan.n_devices,
        plan.nghost_pad, axes[0],
    )


def _plan_scatter_add(plan, gz, y, tables, axes):
    if isinstance(plan, CommPlan2):
        return halo_scatter_add_two_tier(
            gz, y, *tables, plan.rounds_ici, plan.rounds_dcn,
            plan.n_dcn, plan.n_ici, axes[0], axes[1],
        )
    return halo_scatter_add(
        gz, y, tables[0], tables[1], plan.rounds, plan.n_devices, axes[0],
    )


def _plan_scatter_add_ds(plan, gzh, gzl, acc_h, acc_l, tables, axes):
    """Error-free double-single reverse exchange (see
    comm_plan.halo_scatter_add_ds)."""
    from spmv_tpu.parallel.comm_plan import (
        halo_scatter_add_ds,
        halo_scatter_add_two_tier_ds,
    )

    if isinstance(plan, CommPlan2):
        return halo_scatter_add_two_tier_ds(
            gzh, gzl, acc_h, acc_l, *tables, plan.rounds_ici,
            plan.rounds_dcn, plan.n_dcn, plan.n_ici, axes[0], axes[1],
        )
    return halo_scatter_add_ds(
        gzh, gzl, acc_h, acc_l, tables[0], tables[1], plan.rounds,
        plan.n_devices, axes[0],
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stack_ell(
    blocks: list[CSRHost], nrows_pad: int, k: int, dtype=None
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-shard CSR blocks into (D, nrows_pad, k) ELL arrays."""
    d = len(blocks)
    colind = np.zeros((d, nrows_pad, k), dtype=np.int32)
    values = np.zeros((d, nrows_pad, k), dtype=dtype or blocks[0].dtype)
    for s, b in enumerate(blocks):
        lens = b.row_nnz()
        if b.nnz == 0:
            continue
        rows = np.repeat(np.arange(b.nrows), lens)
        slot = np.arange(b.nnz) - np.repeat(b.rowptr[:-1], lens)
        colind[s, rows, slot] = b.colind
        values[s, rows, slot] = b.values
    return colind, values


@dataclasses.dataclass
class DistMatrix:
    """Row-block-sharded sparse matrix on a 1-D mesh axis."""

    local_colind: jax.Array   # (D, R, Kl) int32, columns in [0, col_pad)
    local_values: jax.Array   # (D, R, Kl)
    remote_colind: jax.Array  # (D, R, Kr) int32, columns into ghost buffer
    remote_values: jax.Array  # (D, R, Kr)
    diagonal: jax.Array | None  # (D, R) when symmetric
    jacobi_diag: jax.Array      # (D, R) dense diagonal (preconditioning)
    plan: CommPlan            # compiled over the COLUMN partition
    nrows_global: int
    ncols_global: int
    row_pad: int              # per-shard padded row count R
    symmetric: bool
    nnz_global: int
    mesh: Mesh
    axis_name: str
    # stencil path: when local_format == "dia", the local block is stored
    # diagonally (lane layout, see DiaMatrix.data) and multiplied by the
    # shifted multiply-adds of spmv_tpu.ops.spmv_dia; remote/ghost entries
    # stay ELL. Square matrices only.
    local_format: str = "ell"
    local_dia_data: jax.Array | None = None  # (D, R/128, Kd*128) interleaved
    # double-single lo planes (local_format == "dia_ds"): local_dia_data is
    # the hi plane; remote values split likewise for the DS remote term
    local_dia_data_lo: jax.Array | None = None
    remote_values_lo: jax.Array | None = None
    dia_offsets: tuple[int, ...] = ()
    # general-sparsity path: when local_format == "well", the local block
    # is stored as windowed gather-ELL (spmv_tpu.formats.well) and
    # multiplied by the gather of spmv_tpu.ops.spmv_well.
    local_well_values: jax.Array | None = None  # (D, Kw, G, 128)
    local_well_pos: jax.Array | None = None     # (D, Kw, G, 128) int32
    local_well_w0: jax.Array | None = None      # (D, n_tiles) int32
    well_meta: tuple[int, ...] = ()  # (k_slots, wseg, tile_groups[, paired])
    # double-single lo planes for local_format == "well_ds"
    local_well_values_lo: jax.Array | None = None
    local_values_lo: jax.Array | None = None  # far-block lo plane
    # far remainder of the WELL window split as compact COO (local_format
    # == "well"): gathers/scatters far_nnz elements instead of streaming an
    # (R, K) ELL rectangle that is mostly padding.
    # well_ds keeps the ELL far arrays (its ds_add chain needs them) but
    # skips them statically when well_far_nnz == 0.
    far_rows: jax.Array | None = None  # (D, F) int32 local row indices
    far_cols: jax.Array | None = None  # (D, F) int32 local col indices
    far_vals: jax.Array | None = None  # (D, F)
    well_far_nnz: int = 0              # static: max per-shard far nnz
    # symmetric general-sparsity (local_format == "well" + symmetric): the
    # local block's transpose L^T PRE-BUILT as a second WELL stack, so the
    # symmetric apply is two gathers + diag axpy — no O(nnz) scatter-add
    # (the dual-WELL formulation; the reference's symmetric kernels use
    # conflict maps/atomics)
    local_wellT_values: jax.Array | None = None  # (D, KwT, G, 128)
    local_wellT_pos: jax.Array | None = None     # (D, KwT, G, 128) int32
    local_wellT_w0: jax.Array | None = None      # (D, n_tiles) int32
    wellT_meta: tuple[int, ...] = ()  # (k_slots, wseg, tile_groups[, paired])
    farT_rows: jax.Array | None = None  # transpose far remainder: COO
    farT_cols: jax.Array | None = None  #   (D, F) for "well"; ELL
    farT_vals: jax.Array | None = None  #   (D, R, Kf) for "well_ds"
    well_farT_nnz: int = 0             # static: max per-shard farT nnz
    # symmetric well_ds extras: DS lo planes for the transpose stack, the
    # farT ELL values, and the diagonal
    local_wellT_values_lo: jax.Array | None = None
    farT_vals_lo: jax.Array | None = None
    diagonal_lo: jax.Array | None = None
    # symmetric operators with ghosts: the remote block transposed, an ELL
    # over ghost slots (D, nghost_pad, Kg) whose columns are local rows —
    # the producer side of the reverse exchange (a gather, no scatter)
    remoteT_colind: jax.Array | None = None
    remoteT_vals: jax.Array | None = None
    remoteT_vals_lo: jax.Array | None = None
    # hub rows (degree-skew safety, VERDICT r4 item 2): rows whose nnz
    # exceeds the hub cap leave the row-uniform formats entirely — a
    # 16k-nnz hub row would otherwise inflate EVERY row of the ELL
    # fallback to K=16k (an observed 33 GB colind allocation on a 500k-row
    # power-law graph; the reference's CSR row loop is indifferent to
    # skew, reference spmv/csr_kernels.cpp:42-50, cuda/csr_kernels.cuda.cu:
    # 106-151). Hub entries are stored COMPACT (per-entry COO over
    # PADDED-GLOBAL columns) and applied against an all-gathered x (hub
    # rows intrinsically read the whole vector): one hub_nnz-sized gather
    # + one hub_nnz-sized scatter-add onto the few hub rows. Compactness
    # matters: a padded (H, Kmax) layout would gather its padding too (34M
    # padded vs 0.55M real elements on the 500k-row power-law matrix).
    # Composes with any local_format; see _hub_apply.
    hub_rownum: jax.Array | None = None  # (D, F) int32 local row per entry
    hub_colind: jax.Array | None = None  # (D, F) int32 padded-global col
    hub_values: jax.Array | None = None  # (D, F)
    hub_nnz: int = 0                     # static: total real hub entries

    # ----- static geometry -----
    @property
    def comm_axes(self) -> tuple[str, ...]:
        """Mesh axis names for collectives: (axis,) on a 1-D mesh,
        (dcn_axis, ici_axis) on a two-tier 2-D mesh."""
        return self.axis_name if isinstance(self.axis_name, tuple) else (self.axis_name,)

    @property
    def n_devices(self) -> int:
        return self.plan.n_devices

    @property
    def col_pad(self) -> int:
        """Per-shard padded INPUT (column-side) vector length."""
        return self.plan.nlocal_pad

    @property
    def nlocal_pad(self) -> int:
        """Back-compat alias: per-shard padded size (square matrices)."""
        return self.plan.nlocal_pad

    @property
    def padded_global(self) -> int:
        """Length of the distributed padded input layout (D * col_pad)."""
        return self.n_devices * self.col_pad

    @property
    def dtype(self):
        return self.local_values.dtype

    def format_size_bytes(self) -> int:
        """Device bytes actually held across every array field of whatever
        local format this matrix uses (reference Matrix::format_size parity,
        spmv/Matrix.h:94-111)."""
        total = 0
        for name in DIST_DATA_FIELDS:
            if name in ("plan", "jacobi_diag"):
                continue  # plan tables are comm metadata, jacobi_diag is
                # an optional preconditioner extract, not matrix storage
            arr = getattr(self, name)
            if arr is not None:
                total += arr.size * arr.dtype.itemsize
        return total

    @property
    def lane_rows(self) -> int:
        """Per-shard input-vector rows in the (rows, 128) lane layout."""
        return self.col_pad // 128

    @property
    def row_lane_rows(self) -> int:
        """Per-shard output-vector rows in the lane layout."""
        return self.row_pad // 128

    # ----- vector layout helpers -----
    def _side(self, side: str) -> tuple[int, int]:
        if side == "col":
            return self.ncols_global, self.col_pad
        if side == "row":
            return self.nrows_global, self.row_pad
        raise ValueError(f"side must be 'row' or 'col', got {side!r}")

    def to_dist(self, x_global: np.ndarray, side: str = "col") -> jax.Array:
        """Scatter a host global vector into the sharded 2-D lane layout
        (D*pad/128, 128). ``side='col'`` (default) produces matvec INPUT
        vectors; ``side='row'`` produces output-side vectors (for
        matvec_transpose inputs)."""
        n_glob, pad = self._side(side)
        ranges = owner_ranges(n_glob, self.n_devices)
        out = np.zeros((self.n_devices, pad), dtype=x_global.dtype)
        for s in range(self.n_devices):
            r0, r1 = int(ranges[s]), int(ranges[s + 1])
            out[s, : r1 - r0] = x_global[r0:r1]
        arr = out.reshape(self.n_devices * (pad // 128), 128)
        sharding = NamedSharding(self.mesh, P(self.axis_name, None))
        return jax.device_put(jnp.asarray(arr), sharding)

    def from_dist(self, x: jax.Array, side: str = "row") -> np.ndarray:
        """Gather the sharded lane layout back to a host global vector.
        ``side='row'`` (default) reads matvec OUTPUTS; ``side='col'`` reads
        input-side vectors (e.g. matvec_transpose outputs)."""
        n_glob, pad = self._side(side)
        ranges = owner_ranges(n_glob, self.n_devices)
        mat = np.asarray(x).reshape(self.n_devices, pad)
        return np.concatenate(
            [mat[s, : int(ranges[s + 1] - ranges[s])] for s in range(self.n_devices)]
        )

    # ----- distributed SpMV -----
    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x: x in the col-side lane layout (D*col_pad/128, 128),
        y in the row-side layout (D*row_pad/128, 128)."""
        if self.local_format in ("dia_ds", "well_ds"):
            # transparent f64 path (auto-selected DS operators stay drop-in):
            # split x into an error-free hi/lo f32 pair, run the DS SpMV,
            # recombine. Power users chain matvec_ds directly and skip the
            # conversions.
            if x.dtype == jnp.float64:
                xh = x.astype(jnp.float32)
                xl = (x - xh.astype(jnp.float64)).astype(jnp.float32)
                yh, yl = self.matvec_ds(xh, xl)
                return yh.astype(jnp.float64) + yl.astype(jnp.float64)
            raise ValueError("double-single matrices apply via matvec_ds "
                             "(pair vectors) or a float64 x; build a "
                             "separate fp32 operator for plain f32 matvec")
        return self._apply(x)

    def _apply(self, x: jax.Array) -> jax.Array:
        """Y = A X for x in the block lane layout (D*col_pad/128,
        nrhs*128); nrhs = 1 is matvec's plain lane layout."""
        spec = P(self.axis_name, None)
        (args, op_specs, nt, has_diag, has_dia, has_well,
         n_well, n_wellT, has_remT) = self._mult_operands()

        def per_shard(x_s, lci, lv, rci, rv, *rest):
            rest = list(rest)
            tabs = tuple(rest.pop(0)[0] for _ in range(nt))
            diag = rest.pop(0)[0] if has_diag else None
            dia_data = rest.pop(0)[0] if has_dia else None
            well = (
                tuple(rest.pop(0)[0] for _ in range(n_well))
                if has_well else None
            )
            wellT = (
                tuple(rest.pop(0)[0] for _ in range(n_wellT))
                if n_wellT else None
            )
            remoteT = (
                (rest.pop(0)[0], rest.pop(0)[0]) if has_remT else None
            )
            return _shard_mult(
                x_s, lci[0], lv[0], rci[0], rv[0], diag,
                tabs, self.plan, self.row_pad,
                self.symmetric, self.comm_axes, self.local_format, dia_data,
                self.dia_offsets, well, self.well_meta,
                wellT=wellT, wellT_meta=self.wellT_meta, remoteT=remoteT,
            )

        y = jax.shard_map(
            per_shard, mesh=self.mesh, in_specs=(spec, *op_specs),
            out_specs=spec, check_vma=False,
        )(x, *args)
        if self.hub_nnz > 0:
            y = y + self._hub_apply(x, nrhs=x.shape[1] // 128)
        return y

    def _hub_apply(self, x: jax.Array, nrhs: int = 1) -> jax.Array:
        """Hub-row term (degree-skew split, see the hub_* field comment):
        y_hub = H @ x where H holds the few rows too long for the
        row-uniform formats. Per shard: all-gather x (hub rows read the
        whole vector by nature), gather exactly hub_nnz elements, multiply,
        and scatter-add onto the few hub rows. Compact per-entry arrays:
        no padding is gathered. Composes with every local_format as a
        separate additive term."""
        spec = P(self.axis_name, None)
        rp = self.row_pad
        axes = self.comm_axes

        def per_shard(x_s, hr, hc, hv):
            hr_, hc_, hv_ = hr[0], hc[0], hv[0]
            if nrhs == 1:
                xg = x_s.reshape(-1)
                for ax in reversed(axes):  # inner (fast) axis first ->
                    # dcn-major concat = shard order
                    xg = jax.lax.all_gather(xg, axis_name=ax, tiled=True)
                g = hv_.astype(xg.dtype) * jnp.take(xg, hc_, axis=0)
                y = jnp.zeros((rp,), x_s.dtype).at[hr_].add(
                    g, mode="promise_in_bounds")
                return y.reshape(rp // 128, 128)
            xblk = jnp.stack(
                [x_s[:, r * 128:(r + 1) * 128].reshape(-1)
                 for r in range(nrhs)], axis=1)  # (cp, nrhs)
            for ax in reversed(axes):
                xblk = jax.lax.all_gather(xblk, axis_name=ax, tiled=True)
            g = hv_.astype(xblk.dtype)[:, None] * jnp.take(
                xblk, hc_, axis=0)  # (F, nrhs)
            y = jnp.zeros((rp, nrhs), x_s.dtype).at[hr_].add(
                g, mode="promise_in_bounds")
            return jnp.concatenate(
                [y[:, r].reshape(-1, 128) for r in range(nrhs)], axis=1)

        return jax.shard_map(
            per_shard, mesh=self.mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=spec, check_vma=False,
        )(x, self.hub_rownum, self.hub_colind, self.hub_values)

    def _hub_apply_transpose(self, x: jax.Array) -> jax.Array:
        """Transpose hub term: y += H^T x — per shard, contributions
        hv * x[hub_row] land on padded-global columns; summed across
        shards with psum_scatter so each shard keeps its owned slice."""
        spec = P(self.axis_name, None)
        cp = self.col_pad
        nd = self.n_devices
        axes = self.comm_axes

        def per_shard(x_s, hr, hc, hv):
            hr_, hc_, hv_ = hr[0], hc[0], hv[0]
            xf = x_s.reshape(-1)
            contrib = hv_ * jnp.take(xf, hr_, axis=0)
            yg = jnp.zeros((nd * cp,), x_s.dtype).at[hc_].add(
                contrib, mode="promise_in_bounds")
            for ax in axes:  # outer (slow) axis first: keep the d-major
                # chunk, then the ici chunk within it
                yg = jax.lax.psum_scatter(yg, ax, scatter_dimension=0,
                                          tiled=True)
            return yg.reshape(cp // 128, 128)

        return jax.shard_map(
            per_shard, mesh=self.mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=spec, check_vma=False,
        )(x, self.hub_rownum, self.hub_colind, self.hub_values)

    def as_linear_operator(self):
        """Closure for solvers: matvec on the padded sharded layout."""
        return lambda p: self.matvec(p)

    def _mult_operands(self):
        """The shard_map operand list + specs shared by matvec and matmat
        (order: local/remote ELL, plan tables, then diag / dia / well / far
        extras — per_shard pops in the same order)."""
        mspec = P(self.axis_name, None, None)
        tables = _plan_tables(self.plan)
        has_diag = self.diagonal is not None
        has_dia = self.local_format == "dia"
        has_well = self.local_format == "well"
        has_far = has_well and self.well_far_nnz > 0
        args = [self.local_colind, self.local_values,
                self.remote_colind, self.remote_values, *tables]
        in_specs = [mspec, mspec, mspec, mspec] + [mspec] * len(tables)
        if has_diag:
            args.append(self.diagonal)
            in_specs.append(P(self.axis_name, None))
        if has_dia:
            args.append(self.local_dia_data)
            in_specs.append(mspec)
        if has_well:
            args += [self.local_well_values, self.local_well_pos,
                     self.local_well_w0]
            in_specs += [P(self.axis_name, None, None, None),
                         P(self.axis_name, None, None, None),
                         P(self.axis_name, None)]
            if has_far:
                args += [self.far_rows, self.far_cols, self.far_vals]
                in_specs += [P(self.axis_name, None)] * 3
        n_well = (6 if has_far else 3) if has_well else 0
        # symmetric dual-WELL: L^T stack (+ its far COO) rides along
        n_wellT = 0
        if has_well and self.symmetric:
            args += [self.local_wellT_values, self.local_wellT_pos,
                     self.local_wellT_w0]
            in_specs += [P(self.axis_name, None, None, None),
                         P(self.axis_name, None, None, None),
                         P(self.axis_name, None)]
            n_wellT = 3
            if self.well_farT_nnz > 0:
                args += [self.farT_rows, self.farT_cols, self.farT_vals]
                in_specs += [P(self.axis_name, None)] * 3
                n_wellT = 6
        has_remT = self.symmetric and self.remoteT_colind is not None
        if has_remT:
            args += [self.remoteT_colind, self.remoteT_vals]
            in_specs += [mspec, mspec]
        return (args, in_specs, len(tables), has_diag, has_dia, has_well,
                n_well, n_wellT, has_remT)

    # ----- distributed multi-RHS (block) apply -----
    def to_dist_block(self, x_global: np.ndarray, side: str = "col") -> jax.Array:
        """Scatter a host (n, nrhs) column block into the sharded SpMM lane
        layout (D*pad/128, nrhs*128) — element (i, r*128+j) is flat element
        i*128+j of RHS r on the owning shard."""
        n_glob, pad = self._side(side)
        n, nrhs = x_global.shape
        ranges = owner_ranges(n_glob, self.n_devices)
        out = np.zeros((self.n_devices, pad, nrhs), dtype=x_global.dtype)
        for s in range(self.n_devices):
            r0, r1 = int(ranges[s]), int(ranges[s + 1])
            out[s, : r1 - r0] = x_global[r0:r1]
        arr = (out.reshape(self.n_devices * (pad // 128), 128, nrhs)
               .transpose(0, 2, 1)
               .reshape(self.n_devices * (pad // 128), nrhs * 128))
        sharding = NamedSharding(self.mesh, P(self.axis_name, None))
        return jax.device_put(jnp.asarray(arr), sharding)

    def from_dist_block(self, x: jax.Array, side: str = "row") -> np.ndarray:
        """Gather the sharded block lane layout back to host (n, nrhs)."""
        n_glob, pad = self._side(side)
        rows, lanes = x.shape
        nrhs = lanes // 128
        ranges = owner_ranges(n_glob, self.n_devices)
        mat = (np.asarray(x).reshape(rows, nrhs, 128)
               .transpose(0, 2, 1)
               .reshape(self.n_devices, pad, nrhs))
        return np.concatenate(
            [mat[s, : int(ranges[s + 1] - ranges[s])]
             for s in range(self.n_devices)]
        )

    def matmat(self, x: jax.Array) -> jax.Array:
        """Y = A X for a block of nrhs vectors: x in the col-side block lane
        layout (D*col_pad/128, nrhs*128) -> y likewise row-side. DIA and
        WELL local blocks read the matrix once for the whole block; the
        halo moves as one block (one ppermute set per round, independent
        of nrhs). Feeding this to ``solvers.block_cg`` gives distributed
        block solves (the gram einsums psum under jit)."""
        return self._apply(x)

    def jacobi_preconditioner(self):
        """z = r / diag(A) closure for cg(preconditioner=...) — optional
        diagonal scaling the reference never offered. Zero diagonal entries
        (and padding slots) pass through unscaled."""
        d2 = self.jacobi_diag.reshape(self.n_devices * self.row_lane_rows, 128)

        def apply(r):
            return jnp.where(d2 != 0, r / jnp.where(d2 != 0, d2, 1), r)

        return apply

    def matvec_ds(self, xh: jax.Array, xl: jax.Array):
        """Double-single distributed SpMV (local_format 'dia_ds'/'well_ds'):
        (xh, xl) f32 pairs in the col-side lane layout -> (yh, yl) pairs.
        Both legs ride the same halo plan (two ppermute sets); the local
        block runs the DS DIA or WELL apply, the remote/far terms
        error-free f32 arithmetic (spmv_tpu.ds). Gives distributed
        float64-class SpMV from float32 storage and arithmetic."""
        if self.local_format not in ("dia_ds", "well_ds"):
            raise ValueError("matvec_ds requires local_format 'dia_ds' or "
                             "'well_ds'")
        from spmv_tpu.ds import ds_add, ds_mul_f32

        is_well = self.local_format == "well_ds"
        spec = P(self.axis_name, None)
        mspec = P(self.axis_name, None, None)
        m4spec = P(self.axis_name, None, None, None)
        tables = _plan_tables(self.plan)
        nt = len(tables)
        plan = self.plan
        rp = self.row_pad

        def ell_ds_term(ci, vh, vl, gh_src, gl_src, acc_h, acc_l):
            """Accumulate an ELL block (remote or far) in ds arithmetic."""
            ghg = jnp.take(gh_src, ci, axis=0)  # (R, K)
            glg = jnp.take(gl_src, ci, axis=0)
            for kk in range(ci.shape[1]):
                ph, plo = ds_mul_f32(vh[:, kk], vl[:, kk],
                                     ghg[:, kk], glg[:, kk])
                acc_h, acc_l = ds_add(acc_h, acc_l, ph, plo)
            return acc_h, acc_l

        sym_well = is_well and self.symmetric
        has_farT = sym_well and self.well_farT_nnz > 0
        has_remT = sym_well and self.remoteT_colind is not None

        def per_shard(xh2, xl2, rci, rvh, rvl, *rest):
            rest = list(rest)
            if is_well:
                wvh = rest.pop(0)[0]
                wvl = rest.pop(0)[0]
                wp = rest.pop(0)[0]
                ww0 = rest.pop(0)[0]
                lci_ = rest.pop(0)[0]
                lvh_ = rest.pop(0)[0]
                lvl_ = rest.pop(0)[0]
            else:
                dh = rest.pop(0)[0]
                dl = rest.pop(0)[0]
            if sym_well:
                wtv = rest.pop(0)[0]
                wtl = rest.pop(0)[0]
                wtp = rest.pop(0)[0]
                wtw0 = rest.pop(0)[0]
                dgh = rest.pop(0)[0]
                dgl = rest.pop(0)[0]
                if has_farT:
                    ftci = rest.pop(0)[0]
                    ftvh = rest.pop(0)[0]
                    ftvl = rest.pop(0)[0]
                if has_remT:
                    rtci = rest.pop(0)[0]
                    rtvh = rest.pop(0)[0]
                    rtvl = rest.pop(0)[0]
            tabs = tuple(r[0] for r in rest)
            rci_, rvh_, rvl_ = rci[0], rvh[0], rvl[0]
            have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
            if have_ghosts:
                gh = _plan_gather(plan, xh2.reshape(-1), tabs, self.comm_axes)
                gl = _plan_gather(plan, xl2.reshape(-1), tabs, self.comm_axes)
            if is_well:
                yh, yl = well_ds_apply(wvh, wvl, wp, ww0,
                                       self.well_meta[2], xh2, xl2)
                if self.well_far_nnz > 0:
                    # far remainder of the window split, in ds arithmetic
                    # (statically absent when the split left nothing out)
                    fh = jnp.zeros((rp,), jnp.float32)
                    fl = jnp.zeros((rp,), jnp.float32)
                    fh, fl = ell_ds_term(lci_, lvh_, lvl_,
                                         xh2.reshape(-1), xl2.reshape(-1),
                                         fh, fl)
                    yh, yl = ds_add(yh, yl, fh.reshape(yh.shape),
                                    fl.reshape(yh.shape))
                if sym_well:
                    # symmetric dual-WELL in DS: the local L^T term is a
                    # SECOND DS gather (no scatters), plus the DS diagonal
                    # product and the (ELL, error-free) farT chain
                    th, tl = well_ds_apply(wtv, wtl, wtp, wtw0,
                                           self.wellT_meta[2], xh2, xl2)
                    yh, yl = ds_add(yh, yl, th, tl)
                    ph, plo = ds_mul_f32(dgh.reshape(yh.shape),
                                         dgl.reshape(yh.shape), xh2, xl2)
                    yh, yl = ds_add(yh, yl, ph, plo)
                    if has_farT:
                        fh = jnp.zeros((rp,), jnp.float32)
                        fl = jnp.zeros((rp,), jnp.float32)
                        fh, fl = ell_ds_term(
                            ftci, ftvh, ftvl,
                            xh2.reshape(-1), xl2.reshape(-1), fh, fl)
                        yh, yl = ds_add(yh, yl, fh.reshape(yh.shape),
                                        fl.reshape(yh.shape))
            else:
                yh3, yl3 = dia_ds_apply(dh, dl, self.dia_offsets,
                                        xh2[:, None, :], xl2[:, None, :])
                yh, yl = yh3[:, 0, :], yl3[:, 0, :]
            if have_ghosts:
                acc_h = jnp.zeros((rp,), jnp.float32)
                acc_l = jnp.zeros((rp,), jnp.float32)
                acc_h, acc_l = ell_ds_term(rci_, rvh_, rvl_, gh, gl,
                                           acc_h, acc_l)
                yh, yl = ds_add(yh, yl, acc_h.reshape(yh.shape),
                                acc_l.reshape(yh.shape))
            if sym_well and has_remT and have_ghosts:
                # transpose contributions to GHOST columns, exactly: the
                # per-ghost DS chain over the transposed-remote ELL (no
                # scatter), then the error-free DS reverse exchange
                # (halo_scatter_add_ds: per-round indices are unique, so
                # boundary rows keep f64-class accuracy)
                gzh = jnp.zeros((plan.nghost_pad,), jnp.float32)
                gzl = jnp.zeros((plan.nghost_pad,), jnp.float32)
                gzh, gzl = ell_ds_term(rtci, rtvh, rtvl,
                                       xh2.reshape(-1), xl2.reshape(-1),
                                       gzh, gzl)
                rh, rl = _plan_scatter_add_ds(
                    plan, gzh, gzl,
                    jnp.zeros((rp,), jnp.float32),
                    jnp.zeros((rp,), jnp.float32),
                    tabs, self.comm_axes,
                )
                yh, yl = ds_add(yh, yl, rh.reshape(yh.shape),
                                rl.reshape(yh.shape))
            return yh, yl

        if is_well:
            extra = [self.local_well_values, self.local_well_values_lo,
                     self.local_well_pos, self.local_well_w0,
                     self.local_colind, self.local_values,
                     self.local_values_lo]
            extra_specs = [m4spec, m4spec, m4spec, P(self.axis_name, None),
                           mspec, mspec, mspec]
            if sym_well:
                extra += [self.local_wellT_values,
                          self.local_wellT_values_lo,
                          self.local_wellT_pos, self.local_wellT_w0,
                          self.diagonal, self.diagonal_lo]
                extra_specs += [m4spec, m4spec, m4spec,
                                P(self.axis_name, None),
                                P(self.axis_name, None),
                                P(self.axis_name, None)]
                if has_farT:
                    extra += [self.farT_cols, self.farT_vals,
                              self.farT_vals_lo]
                    extra_specs += [mspec, mspec, mspec]
                if has_remT:
                    extra += [self.remoteT_colind, self.remoteT_vals,
                              self.remoteT_vals_lo]
                    extra_specs += [mspec, mspec, mspec]
        else:
            extra = [self.local_dia_data, self.local_dia_data_lo]
            extra_specs = [mspec, mspec]
        return jax.shard_map(
            per_shard, mesh=self.mesh,
            in_specs=(spec, spec, mspec, mspec, mspec)
            + tuple(extra_specs) + (mspec,) * nt,
            out_specs=(spec, spec), check_vma=False,
        )(xh, xl, self.remote_colind, self.remote_values,
          self.remote_values_lo, *extra, *tables)

    def matmat_ds(self, xh: jax.Array, xl: jax.Array):
        """Double-single distributed SpMM: (xh, xl) f32 pairs in the sharded
        SpMM lane layout (D*col_pad/128, nrhs*128) -> (yh, yl) pairs.

        The f64-class block apply: the local DS DIA product reads BOTH
        matrix planes once for the whole block (ops/spmv_dia_ds); the halo
        moves hi and lo as two block gathers (one ppermute set per round per
        plane, independent of nrhs); remote terms run error-free f32
        arithmetic per column. ``local_format='well_ds'`` routes the block
        through the DS WELL gather (ops/spmv_well) — the f64-class block
        apply for GENERAL sparsity — with the far window-split remainder as
        per-column DS ELL chains."""
        if self.local_format not in ("dia_ds", "well_ds"):
            raise ValueError(
                "matmat_ds requires local_format 'dia_ds' or 'well_ds'")
        if self.local_format == "well_ds" and self.symmetric:
            raise ValueError(
                "matmat_ds: symmetric well_ds blocks apply per column via "
                "matvec_ds; build the operator non-symmetric for block "
                "refinement")
        from spmv_tpu.ds import ds_add, ds_mul_f32

        nrhs = xh.shape[1] // 128
        spec = P(self.axis_name, None)
        mspec = P(self.axis_name, None, None)
        tables = _plan_tables(self.plan)
        nt = len(tables)
        plan = self.plan
        rp = self.row_pad

        def ell_ds_term(ci, vh_, vl_, gh_src, gl_src, acc_h, acc_l):
            """Accumulate an ELL block (remote or far) in ds arithmetic."""
            ghg = jnp.take(gh_src, ci, axis=0)
            glg = jnp.take(gl_src, ci, axis=0)
            for kk in range(ci.shape[1]):
                ph, plo = ds_mul_f32(vh_[:, kk], vl_[:, kk],
                                     ghg[:, kk], glg[:, kk])
                acc_h, acc_l = ds_add(acc_h, acc_l, ph, plo)
            return acc_h, acc_l

        if self.local_format == "well_ds":
            tg_w = self.well_meta[2]
            m4spec = P(self.axis_name, None, None, None)
            has_far = self.well_far_nnz > 0

            def per_shard_w(xh2, xl2, rci, rvh, rvl, wvh, wvl, wp, ww0,
                            lci, lvh, lvl, *tabs_in):
                tabs = tuple(t[0] for t in tabs_in)
                rci_, rvh_, rvl_ = rci[0], rvh[0], rvl[0]
                yh, yl = well_ds_apply(wvh[0], wvl[0], wp[0], ww0[0], tg_w,
                                       xh2, xl2)

                def col(v2, r):
                    return v2[:, r * 128:(r + 1) * 128].reshape(-1)

                if has_far:
                    # window-split far remainder: per-column DS ELL chain
                    # (error-free per output row; tiny after RCM)
                    for r in range(nrhs):
                        fh = jnp.zeros((rp,), jnp.float32)
                        fl = jnp.zeros((rp,), jnp.float32)
                        fh, fl = ell_ds_term(lci[0], lvh[0], lvl[0],
                                             col(xh2, r), col(xl2, r),
                                             fh, fl)
                        sl = slice(r * 128, (r + 1) * 128)
                        nh, nl = ds_add(yh[:, sl], yl[:, sl],
                                        fh.reshape(-1, 128),
                                        fl.reshape(-1, 128))
                        yh = yh.at[:, sl].set(nh)
                        yl = yl.at[:, sl].set(nl)
                if plan.nghost_pad > 0 and len(plan.rounds) > 0:
                    # block halo per plane (one ppermute set per round)
                    def as_cols(v2):
                        return jnp.stack(
                            [col(v2, r) for r in range(nrhs)], axis=1)

                    gh = _plan_gather(plan, as_cols(xh2), tabs,
                                      self.comm_axes)
                    gl = _plan_gather(plan, as_cols(xl2), tabs,
                                      self.comm_axes)
                    for r in range(nrhs):
                        acc_h = jnp.zeros((rp,), jnp.float32)
                        acc_l = jnp.zeros((rp,), jnp.float32)
                        acc_h, acc_l = ell_ds_term(rci_, rvh_, rvl_,
                                                   gh[:, r], gl[:, r],
                                                   acc_h, acc_l)
                        sl = slice(r * 128, (r + 1) * 128)
                        nh, nl = ds_add(yh[:, sl], yl[:, sl],
                                        acc_h.reshape(-1, 128),
                                        acc_l.reshape(-1, 128))
                        yh = yh.at[:, sl].set(nh)
                        yl = yl.at[:, sl].set(nl)
                return yh, yl

            return jax.shard_map(
                per_shard_w, mesh=self.mesh,
                in_specs=(spec, spec, mspec, mspec, mspec,
                          m4spec, m4spec, m4spec, P(self.axis_name, None),
                          mspec, mspec, mspec)
                + (mspec,) * nt,
                out_specs=(spec, spec), check_vma=False,
            )(xh, xl, self.remote_colind, self.remote_values,
              self.remote_values_lo, self.local_well_values,
              self.local_well_values_lo, self.local_well_pos,
              self.local_well_w0, self.local_colind, self.local_values,
              self.local_values_lo, *tables)

        def per_shard(xh2, xl2, rci, rvh, rvl, dh, dl, *tabs_in):
            tabs = tuple(t[0] for t in tabs_in)
            rci_, rvh_, rvl_ = rci[0], rvh[0], rvl[0]
            rows = xh2.shape[0]
            yh3, yl3 = dia_ds_apply(dh[0], dl[0], self.dia_offsets,
                                    xh2.reshape(rows, nrhs, 128),
                                    xl2.reshape(rows, nrhs, 128))
            yh, yl = yh3.reshape(rows, -1), yl3.reshape(rows, -1)
            have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
            if have_ghosts:
                # block halo per plane: (nlocal_pad, nrhs) moved in one
                # ppermute set per round
                def as_cols(v2):
                    return jnp.stack(
                        [v2[:, r * 128:(r + 1) * 128].reshape(-1)
                         for r in range(nrhs)], axis=1)

                gh = _plan_gather(plan, as_cols(xh2), tabs, self.comm_axes)
                gl = _plan_gather(plan, as_cols(xl2), tabs, self.comm_axes)
                for r in range(nrhs):
                    acc_h = jnp.zeros((rp,), jnp.float32)
                    acc_l = jnp.zeros((rp,), jnp.float32)
                    ghg = jnp.take(gh[:, r], rci_, axis=0)
                    glg = jnp.take(gl[:, r], rci_, axis=0)
                    for kk in range(rci_.shape[1]):
                        ph, plo = ds_mul_f32(rvh_[:, kk], rvl_[:, kk],
                                             ghg[:, kk], glg[:, kk])
                        acc_h, acc_l = ds_add(acc_h, acc_l, ph, plo)
                    sl = slice(r * 128, (r + 1) * 128)
                    nh, nl = ds_add(yh[:, sl], yl[:, sl],
                                    acc_h.reshape(-1, 128),
                                    acc_l.reshape(-1, 128))
                    yh = yh.at[:, sl].set(nh)
                    yl = yl.at[:, sl].set(nl)
            return yh, yl

        return jax.shard_map(
            per_shard, mesh=self.mesh,
            in_specs=(spec, spec, mspec, mspec, mspec, mspec, mspec)
            + (mspec,) * nt,
            out_specs=(spec, spec), check_vma=False,
        )(xh, xl, self.remote_colind, self.remote_values,
          self.remote_values_lo, self.local_dia_data,
          self.local_dia_data_lo, *tables)

    def transposed(self) -> "DistMatrix":
        """A PRE-BUILT transposed operator, cached on first call.

        ``matvec_transpose`` re-derives the transpose layout on EVERY apply
        (the DIA path de/re-interleaves the whole matrix; WELL/ELL scatter
        through XLA) — fine for a one-off, wasteful in a loop.
        ``A.transposed()`` pays one host rebuild (partition + plan compile +
        upload of A^T) and returns a first-class DistMatrix whose
        ``matvec`` IS the transpose product at full kernel speed; repeated
        calls (and ``At.transposed()``) return the cached object.

        The reference declares ``transpmult`` and throws
        (reference spmv/Matrix.cpp:144-148); its restriction demo needed
        exactly this pre-built form (reference demos/restrictmain.cpp:60-91).

        Only available on operators returned by ``build_dist_matrix`` (the
        host matrix rides along as a plain attribute and does not survive
        jit/pytree round-trips — call this OUTSIDE jit, before the loop).
        """
        if self.symmetric:
            return self  # A^T = A
        cached = getattr(self, "_transposed_cache", None)
        if cached is not None:
            return cached
        host = getattr(self, "_host_csr", None)
        if host is None:
            raise ValueError(
                "transposed() needs the assembly-time host matrix, which is "
                "only attached by build_dist_matrix and does not survive "
                "jit/pytree transforms; rebuild the operator or use "
                "matvec_transpose for one-off applies"
            )
        kw = dict(getattr(self, "_rebuild_kwargs", {}))
        at = host.transpose()
        fmt = kw.get("local_format", self.local_format)
        if fmt in ("dia", "dia_ds") and at.nrows != at.ncols:
            kw["local_format"] = "ell"
        At = build_dist_matrix(at, **kw)
        At._transposed_cache = self  # (A^T)^T = A, same cache discipline
        self._transposed_cache = At
        return At

    def matvec_transpose(self, x: jax.Array) -> jax.Array:
        """y = A^T @ x: x in the row-side lane layout, y in the col-side
        layout.

        The working transpose product the reference declares but never
        implemented (reference spmv/Matrix.cpp:144-148 ``transpmult`` throws;
        its restriction/prolongation demo needs it,
        reference demos/restrictmain.cpp:60-91). A^T's rows owned by shard s
        are A's owned columns of shard s: local-block transpose scatters stay
        owned; remote-block transpose contributions land on ghost columns and
        are pushed back to their owners with the reverse plan.
        """
        if self.symmetric:
            return self.matvec(x)  # symmetric: A^T = A
        rp = self.row_pad
        cp = self.col_pad
        spec = P(self.axis_name, None)
        mspec = P(self.axis_name, None, None)

        has_dia = self.local_format == "dia"
        dia_data_t = None
        dia_offsets_t: tuple[int, ...] = ()
        if has_dia:
            # local-block transpose as a DIA transform (negated offsets +
            # row-shifted data, see formats.dia.dia_transpose); the shift is
            # uniform across shards so it runs stacked, one pass over the
            # matrix data per call (incl. the de/re-interleave). For
            # repeated transpose applies inside a loop, pre-build the
            # transposed operator instead.
            nd, lr, klanes = self.local_dia_data.shape
            k = klanes // 128
            flat = (self.local_dia_data.reshape(nd, lr, k, 128)
                    .transpose(0, 2, 1, 3).reshape(nd, k, lr * 128))
            dia_offsets_t = tuple(-o for o in reversed(self.dia_offsets))
            rows = []
            for o_new in dia_offsets_t:
                row = flat[:, self.dia_offsets.index(-o_new), :]
                if o_new > 0:
                    row = jnp.concatenate(
                        [row[:, o_new:], jnp.zeros((nd, o_new), row.dtype)], axis=1
                    )
                elif o_new < 0:
                    row = jnp.concatenate(
                        [jnp.zeros((nd, -o_new), row.dtype), row[:, :o_new]], axis=1
                    )
                rows.append(row)
            dia_data_t = (jnp.stack(rows, axis=1)
                          .reshape(nd, k, lr, 128)
                          .transpose(0, 2, 1, 3)
                          .reshape(nd, lr, k * 128))

        tables = _plan_tables(self.plan)
        nt = len(tables)
        has_well = self.local_format == "well"

        def per_shard(x_s2, lci, lv, rci, rv, *rest):
            rest = list(rest)
            tabs = tuple(rest.pop(0)[0] for _ in range(nt))
            x_s = x_s2.reshape(rp)
            lci_, lv_, rci_, rv_ = lci[0], lv[0], rci[0], rv[0]
            plan = self.plan
            if has_well:
                # WELL local block: each stored nonzero of row (g*128+lane)
                # sits at shard column w0[tile]*128 + pos (the window is
                # in-bounds by assembly: the shared pad covers w0+wseg).
                # Transpose = deterministic scatter-add of value*x[row] at
                # those columns; the far remainder scatters via its ELL
                # arrays. XLA-path (like the ELL transpose below) — for
                # repeated applies in a hot loop, pre-build the transposed
                # operator (build_dist_matrix(a.transpose())) instead.
                n_w = 6 if self.well_far_nnz > 0 else 3
                wellt = tuple(rest.pop(0)[0] for _ in range(n_w))
                wv, wp, ww0 = wellt[:3]
                tg_w = self.well_meta[2]
                cols = wp.astype(jnp.int32) + (
                    jnp.repeat(ww0.astype(jnp.int32), tg_w) * 128
                )[None, :, None]
                contrib = wv * x_s2[None, :, :]
                y = jnp.zeros((cp,), dtype=x_s.dtype)
                y = y.at[cols.reshape(-1)].add(
                    contrib.reshape(-1), mode="promise_in_bounds"
                )
                if n_w > 3:
                    # compact-COO far remainder transposed: y[col] += v*x[row]
                    fr_, fc_, fv_ = wellt[3:6]
                    y = y.at[fc_].add(
                        fv_ * x_s[fr_], mode="promise_in_bounds"
                    )
            elif has_dia:
                y = dia_apply(rest.pop(0)[0], dia_offsets_t,
                              x_s2[:, None, :]).reshape(rp)
            else:
                # owned columns: scatter-add v * x[row] at local colind
                y = jnp.zeros((cp,), dtype=x_s.dtype)
                y = y.at[lci_.reshape(-1)].add(
                    (lv_ * x_s[:, None]).reshape(-1), mode="promise_in_bounds"
                )
            if plan.nghost_pad > 0 and len(plan.rounds) > 0:
                gz = jnp.zeros((plan.nghost_pad,), dtype=x_s.dtype)
                gz = gz.at[rci_.reshape(-1)].add(
                    (rv_ * x_s[:, None]).reshape(-1), mode="promise_in_bounds"
                )
                y = _plan_scatter_add(plan, gz, y, tabs, self.comm_axes)
            return y.reshape(cp // 128, 128)

        args = [x, self.local_colind, self.local_values, self.remote_colind,
                self.remote_values, *tables]
        in_specs = [spec, mspec, mspec, mspec, mspec] + [mspec] * nt
        if has_well:
            args += [self.local_well_values, self.local_well_pos,
                     self.local_well_w0]
            in_specs += [P(self.axis_name, None, None, None),
                         P(self.axis_name, None, None, None),
                         P(self.axis_name, None)]
            if self.well_far_nnz > 0:
                args += [self.far_rows, self.far_cols, self.far_vals]
                in_specs += [P(self.axis_name, None)] * 3
        if has_dia:
            args.append(dia_data_t)
            in_specs.append(P(self.axis_name, None, None))
        y = jax.shard_map(
            per_shard, mesh=self.mesh,
            in_specs=tuple(in_specs),
            out_specs=spec, check_vma=False,
        )(*args)
        if self.hub_nnz > 0:
            y = y + self._hub_apply_transpose(x)
        return y


# Pytree registration: pass DistMatrix THROUGH jit as an argument
# (jax.jit(lambda A, x: A.matvec(x))(A, x)). Closing over the matrix inside a
# jitted function instead would embed its arrays as literal constants in the
# lowered program — observed shipping a 2 GB matrix through the remote
# compile service. Mesh and all shape/format descriptors are static.
# single source of truth for the array/meta field split — the pytree
# registration AND the checkpoint writer iterate these
DIST_DATA_FIELDS = (
    "local_colind", "local_values", "remote_colind", "remote_values",
    "diagonal", "jacobi_diag", "plan", "local_dia_data",
    "local_dia_data_lo", "remote_values_lo",
    "local_well_values", "local_well_pos", "local_well_w0",
    "local_well_values_lo", "local_values_lo",
    "far_rows", "far_cols", "far_vals",
    "local_wellT_values", "local_wellT_pos", "local_wellT_w0",
    "farT_rows", "farT_cols", "farT_vals",
    "local_wellT_values_lo", "farT_vals_lo", "diagonal_lo",
    "remoteT_colind", "remoteT_vals", "remoteT_vals_lo",
    "hub_rownum", "hub_colind", "hub_values",
)
DIST_META_FIELDS = (
    "nrows_global", "ncols_global", "row_pad", "symmetric", "nnz_global",
    "mesh", "axis_name", "local_format", "dia_offsets", "well_meta",
    "well_far_nnz", "wellT_meta", "well_farT_nnz", "hub_nnz",
)
jax.tree_util.register_dataclass(
    DistMatrix,
    data_fields=list(DIST_DATA_FIELDS),
    meta_fields=list(DIST_META_FIELDS),
)


def _coo_apply(coo, xc: jax.Array, nrows: int) -> jax.Array:
    """Compact-COO term (rows, cols, vals) on the (n, nrhs) column view:
    touches exactly the stored entries."""
    rows, cols, vals = coo
    return jnp.zeros((nrows, xc.shape[1]), xc.dtype).at[rows].add(
        vals[:, None] * jnp.take(xc, cols, axis=0), mode="promise_in_bounds")


def _shard_mult(
    x2, lci, lv, rci, rv, diag, tables,
    plan, row_pad: int, symmetric: bool, comm_axes: tuple[str, ...],
    local_format: str = "ell", dia_data=None, dia_offsets: tuple = (),
    well=None, well_meta: tuple = (), wellT=None, wellT_meta: tuple = (),
    remoteT=None,
):
    """One shard's Y = A_s @ X. Runs inside shard_map.

    ``x2`` is the (col_pad/128, nrhs*128) block lane layout (nrhs = 1 is
    the plain lane layout); the result is (row_pad/128, nrhs*128). DIA and
    WELL local blocks apply the whole block in one pass over the matrix;
    ELL and the remote/ghost terms work on the (col_pad, nrhs) column
    view. The halo moves as one block: one ppermute set forward (and,
    symmetric, one reverse set) whatever nrhs is. The local product never
    reads the ghost buffer, so XLA can run the halo collectives
    concurrently with it.
    """
    xc = block_to_columns(x2)  # (col_pad, nrhs)
    nrhs = xc.shape[1]
    have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
    if have_ghosts:
        ghosts = _plan_gather(plan, xc, tables, comm_axes)
    y2 = yc = None
    # interior product — independent of the halo
    if local_format == "dia":
        # symmetric: the DIA block stores offsets <= 0 (incl. diagonal) and
        # applies L + D + L^T of the LOCAL block itself — only the
        # remote/ghost transpose contributions remain for the reverse plan
        y2 = dia_apply(dia_data, dia_offsets,
                       x2.reshape(x2.shape[0], nrhs, 128),
                       symmetric).reshape(row_pad // 128, -1)
    elif local_format == "well":
        y2 = well_apply_block(*well[:3], well_meta[2], x2)
        if len(well) > 3:
            # compact-COO far remainder (statically absent when the
            # window split left nothing out)
            y2 = y2 + columns_to_block(_coo_apply(well[3:6], xc, row_pad))
        if symmetric:
            # dual-WELL: the local transpose term L^T x is a second gather
            # over the pre-built transpose stack — no O(nnz) scatter
            y2 = y2 + well_apply_block(*wellT[:3], wellT_meta[2], x2)
            y2 = y2 + columns_to_block(diag[:, None] * xc)
            if len(wellT) > 3:
                y2 = y2 + columns_to_block(
                    _coo_apply(wellT[3:6], xc, row_pad))
    else:
        yc = jnp.einsum("rk,rkn->rn", lv, jnp.take(xc, lci, axis=0),
                        precision=_HI)
        if symmetric:
            yc = yc + diag[:, None] * xc
            # transpose contributions to owned cols (deterministic scatter-add)
            yc = yc.at[lci.reshape(-1)].add(
                (lv[..., None] * xc[:, None, :]).reshape(-1, nrhs),
                mode="promise_in_bounds",
            )
    if not have_ghosts:
        return y2 if yc is None else columns_to_block(yc)
    if yc is None:
        yc = block_to_columns(y2)
    yc = yc + jnp.einsum("rk,rkn->rn", rv, jnp.take(ghosts, rci, axis=0),
                         precision=_HI)
    if symmetric:
        # contributions to ghost columns, one gather per ghost slot over
        # the transposed remote block -> reverse reduce-scatter to owners
        rtci, rtv = remoteT
        gz = jnp.einsum("gk,gkn->gn", rtv, jnp.take(xc, rtci, axis=0),
                        precision=_HI)
        yc = _plan_scatter_add(plan, gz, yc, tables, comm_axes)
    return columns_to_block(yc)


def _assemble(
    shards: list[ShardCSR],
    col_ranges: np.ndarray,
    nrows_global: int,
    ncols_global: int,
    nnz_global: int,
    mesh: Mesh,
    axis_name: str,
    symmetric: bool,
    dtype,
    row_align: int,
    local_format: str,
    well_wseg_cap: int = 512,
    well_max_k: int = 64,
    well_tile_groups: int | None = None,
    dia_max_diags: int = 64,
    ell_bytes_cap: float = 4e9,
) -> DistMatrix:
    """Shared assembly tail: compile the (column-side) CommPlan, stack the
    ELL/DIA blocks, and upload everything sharded in one device_put each."""
    nd = len(shards)

    well_stack = None
    well_lo = None
    far_lo = None
    far_rows = far_cols = far_vals = None
    far_max = 0
    well_meta: tuple[int, ...] = ()
    wellT_stack = None
    farT_rows = farT_cols = farT_vals = None
    farT_max = 0
    wellT_meta: tuple[int, ...] = ()
    wellT_lo = None
    farT_vals_lo = None
    diag_lo = None
    if local_format in ("well", "well_ds"):
        from spmv_tpu.formats.well import _build_arrays, split_window

        eff_dtype = np.dtype(dtype) if dtype is not None \
            else np.dtype(shards[0].local.dtype)
        if np.issubdtype(eff_dtype, np.complexfloating):
            raise ValueError(
                "WELL has no complex device kernel; complex operators run "
                "on the ELL/DIA XLA path (local_format='ell' or 'dia'), or "
                "split re/im into two real operators (README 'Complex "
                "dtypes')"
            )

        max_groups = max(-(-(s.row_range[1] - s.row_range[0]) // 128)
                         for s in shards)
        tg = (well_tile_groups if well_tile_groups is not None else
              next(t for t in (64, 32, 16, 8, 4, 2, 1) if t <= max_groups))
        tg = next(t for t in (tg, 32, 16, 8, 4, 2, 1) if t <= max_groups)
        # near/far split: entries beyond each tile's best well_wseg_cap-segment window
        # leave the WELL block and run through the XLA ELL path instead
        # (multi-pass general sparsity; far is small after RCM reordering).
        # Arrays stay NUMPY until upload — a jnp round-trip silently
        # downcasts f64 values when x64 is off (the DS lo-plane bug class).
        # Symmetric: the shard's local block is the strict lower triangle L;
        # ALSO pre-build L^T as a second WELL stack so the symmetric apply
        # is two gather kernels + diag axpy with no O(nnz) scatter (the
        # dual-WELL formulation; reference symmetric kernels use conflict
        # maps/atomics instead, spmv/openmp/csr_kernels.openmp.cpp:89-168).
        wells, far_blocks = [], []
        wellsT, farT_blocks = [], []
        for s in shards:
            near, far = split_window(s.local, tile_groups=tg,
                                     wseg_cap=well_wseg_cap)
            wells.append(_build_arrays(
                near, tg, well_max_k,
                np.float64 if local_format == "well_ds" else dtype,
            ))
            far_blocks.append(far)
            if symmetric:
                lt = s.local.transpose()
                nearT, farT = split_window(lt, tile_groups=tg,
                                           wseg_cap=well_wseg_cap)
                wellsT.append(_build_arrays(
                    nearT, tg, well_max_k,
                    np.float64 if local_format == "well_ds" else dtype,
                ))
                farT_blocks.append(farT)
        k_w = max(v.shape[0] for v, *_ in wells)
        wseg_w = max(wseg for _, _, _, wseg, _, _ in wells)
        # one padded geometry for every shard: groups cover rows AND every
        # window (w0 + wseg) AND the owned column span (x and y share the
        # per-shard padded length on square operators) — and, symmetric,
        # the transpose stack's rows/windows too
        need = max(
            max(v.shape[1] for v, *_ in wells),
            max((int(w0.max()) if len(w0) else 0) for _, _, w0, *_ in wells)
            + wseg_w,
            max(-(-(s.col_range[1] - s.col_range[0]) // 128) for s in shards),
        )
        if symmetric:
            k_wT = max(v.shape[0] for v, *_ in wellsT)
            wseg_wT = max(wseg for _, _, _, wseg, _, _ in wellsT)
            need = max(
                need,
                max(v.shape[1] for v, *_ in wellsT),
                max((int(w0.max()) if len(w0) else 0)
                    for _, _, w0, *_ in wellsT) + wseg_wT,
            )
        gt = _round_up(need, tg)

        def stack_wells(ws, kk):
            sv = np.zeros((nd, kk, gt, 128),
                          dtype=np.float64 if local_format == "well_ds"
                          else ws[0][0].dtype)
            sp = np.zeros((nd, kk, gt, 128), dtype=np.int32)
            s0 = np.zeros((nd, gt // tg), dtype=np.int32)
            for s, (v, p, w0, _, _, _) in enumerate(ws):
                sv[s, : v.shape[0], : v.shape[1]] = v
                sp[s, : p.shape[0], : p.shape[1]] = p
                s0[s, : len(w0)] = w0
            # any paired shard makes the STACK paired (unpaired shards'
            # slots have sa == sb, so the leg select never differs there)
            return sv, sp, s0, any(w[5] for w in ws)

        wv, wp, ww0, wpaired = stack_wells(wells, k_w)
        if local_format == "well_ds":
            from spmv_tpu.ds import ds_from_f64

            wv, well_lo = ds_from_f64(wv)
        well_stack = (wv, wp, ww0)
        well_meta = (k_w, wseg_w, tg, wpaired)
        if symmetric:
            wtv, wtp, wtw0, wtpaired = stack_wells(wellsT, k_wT)
            if local_format == "well_ds":
                from spmv_tpu.ds import ds_from_f64

                wtv, wellT_lo = ds_from_f64(wtv)
            wellT_stack = (wtv, wtp, wtw0)
            wellT_meta = (k_wT, wseg_wT, tg, wtpaired)
            farT_max = max((b.nnz for b in farT_blocks), default=0)
            if farT_max > 0 and local_format == "well_ds":
                # DS far remainder as an ELL rectangle: the ds accumulation
                # chain must stay error-free per OUTPUT row (slot-wise
                # gathers do; scatter-adds would round). farT_cols/vals(_lo)
                # are (D, R, Kf) here, NOT the plain-well COO shape.
                from spmv_tpu.ds import ds_from_f64

                kfT = max(max((int(b.row_nnz().max()) if b.nnz else 0)
                              for b in farT_blocks), 1)
                farT_cols, fT64 = _stack_ell(farT_blocks, gt * 128, kfT,
                                             dtype=np.float64)
                farT_vals, farT_vals_lo = ds_from_f64(fT64)
            elif farT_max > 0:
                farT_rows = np.zeros((nd, farT_max), dtype=np.int32)
                farT_cols = np.zeros((nd, farT_max), dtype=np.int32)
                farT_vals = np.zeros((nd, farT_max),
                                     dtype=dtype or shards[0].local.dtype)
                for s, bf in enumerate(farT_blocks):
                    if bf.nnz == 0:
                        continue
                    farT_rows[s, : bf.nnz] = np.repeat(
                        np.arange(bf.nrows, dtype=np.int32), bf.row_nnz()
                    )
                    farT_cols[s, : bf.nnz] = bf.colind
                    farT_vals[s, : bf.nnz] = bf.values
        # force the shared per-shard pad to exactly gt*128 on both sides
        row_align = gt * 128

    axis_names = (tuple(mesh.axis_names) if len(mesh.axis_names) > 1
                  else axis_name)
    if isinstance(axis_names, tuple):
        # 2-D (dcn, ici) mesh: two-tier plan — first axis is the slow/DCN
        # tier, second the fast/ICI tier (reference shmem on/off-node split,
        # spmv/L2GMap.cpp:723-865)
        n_dcn = mesh.shape[axis_names[0]]
        n_ici = mesh.shape[axis_names[1]]
        plan = compile_plan_two_tier(
            col_ranges, [s.ghosts for s in shards], n_dcn, n_ici,
            row_align=row_align,
        )
    else:
        plan = compile_plan(col_ranges, [s.ghosts for s in shards],
                            row_align=row_align)
    row_pad = max(
        _round_up(max(s.row_range[1] - s.row_range[0] for s in shards), row_align),
        row_align,
    )
    r = row_pad

    dia_data = None
    dia_data_lo = None
    remote_lo = None
    dia_offsets: tuple[int, ...] = ()
    if local_format in ("dia", "dia_ds"):
        # union of diagonal offsets across shards; per-shard data stacked to
        # (D, Kd, R) with absent diagonals all-zero
        per_shard = []
        all_offs = []
        for sh in shards:
            loc = sh.local
            lens = loc.row_nnz()
            rows = np.repeat(np.arange(loc.nrows, dtype=np.int64), lens)
            offs = loc.colind.astype(np.int64) - rows
            vals = loc.values
            if symmetric:
                # symmetric shards keep the diagonal separately
                # (classify_shard); fold it in as offset 0 so the symmetric
                # DIA block holds all offsets <= 0
                drows = np.arange(sh.nlocal, dtype=np.int64)
                rows = np.concatenate([rows, drows])
                offs = np.concatenate([offs, np.zeros_like(drows)])
                vals = np.concatenate([vals, sh.diagonal])
            per_shard.append((rows, offs, vals))
            all_offs.append(np.unique(offs))
        union = np.unique(np.concatenate(all_offs)) if all_offs else np.array([0])
        if len(union) > dia_max_diags:
            raise ValueError(
                f"local blocks have {len(union)} distinct diagonals "
                f"(> dia_max_diags={dia_max_diags}); local_format='dia' is "
                "for banded/stencil operators — raise dia_max_diags only "
                "when the band is dense (storage is ndiags * nrows)"
            )
        kd = max(len(union), 1)
        dd_dtype = np.float64 if local_format == "dia_ds" else (
            dtype or shards[0].local.dtype)
        dd = np.zeros((nd, kd, r), dtype=dd_dtype)
        for s, (rows, offs, vals) in enumerate(per_shard):
            if len(rows) == 0:
                continue
            dsel = np.searchsorted(union, offs)
            flat = dsel * np.int64(r) + rows
            # bincount weights must be real; complex splits into two passes
            # (same as formats/dia._csr_to_dia_host)
            if np.iscomplexobj(vals):
                acc = np.bincount(
                    flat, weights=vals.real, minlength=kd * r
                ) + 1j * np.bincount(
                    flat, weights=vals.imag, minlength=kd * r
                )
            else:
                acc = np.bincount(flat, weights=vals, minlength=kd * r)
            dd[s] += acc.reshape(kd, r).astype(dd.dtype)
        # row-interleaved device layout (see DiaMatrix.data)
        def interleave(arr):
            return (arr.reshape(nd, kd, r // 128, 128)
                    .transpose(0, 2, 1, 3)
                    .reshape(nd, r // 128, kd * 128))

        if local_format == "dia_ds":
            from spmv_tpu.ds import ds_from_f64

            hi, lo = ds_from_f64(dd)
            dia_data, dia_data_lo = interleave(hi), interleave(lo)
        else:
            dia_data = interleave(dd)
        dia_offsets = tuple(int(o) for o in union)

    kl = max(max((int(s.local.row_nnz().max()) if s.local.nnz else 0) for s in shards), 1)
    kr = max(max((int(s.remote.row_nnz().max()) if s.remote.nnz else 0) for s in shards), 1)
    # hard ELL memory ceiling (VERDICT r4 item 2): a degree-skewed matrix
    # inflates every row of a stacked (D, R, K) ELL block to the max row
    # nnz — fail loudly with the remedy instead of attempting the
    # allocation (observed: K=16479 at 500k rows -> a 33 GB colind)
    _it = np.dtype(dtype or shards[0].local.dtype).itemsize
    for _tag, _k, _used in (
        # dia/well local blocks don't stack the full local ELL; well_ds
        # recomputes kl from the (small) far remainder below
        ("local", kl, local_format == "ell"),
        ("remote", kr, True),
    ):
        _bytes = float(nd) * r * _k * (_it + 4)
        if _used and _bytes > ell_bytes_cap:
            raise ValueError(
                f"stacked {_tag} ELL block would allocate "
                f"{_bytes/1e9:.1f} GB (K={_k} slots x {nd}x{r} rows) "
                f"> ell_bytes_cap={ell_bytes_cap/1e9:.1f} GB — the matrix "
                "is degree-skewed for row-uniform storage. Remedies: "
                "hub_cap='auto' (build_dist_matrix splits hub rows out; "
                "vanilla real-dtype operators only), RCM reordering "
                "(spmv_tpu.reorder), or raise ell_bytes_cap if the "
                "allocation is intended"
            )
    if local_format in ("dia", "dia_ds"):
        kl = 1  # local ELL arrays unused; keep placeholders tiny
        lci = np.zeros((nd, r, 1), dtype=np.int32)
        lv = np.zeros((nd, r, 1), dtype=np.float32 if local_format == "dia_ds"
                      else (dtype or shards[0].local.dtype))
    elif local_format in ("well", "well_ds"):
        # far remainder of the window split. well_ds keeps it in the local
        # ELL arrays (the DS accumulation chain works column-wise); plain
        # well stores it as compact COO so the device term touches only
        # far_nnz elements (an (R, K) ELL rectangle would gather R*K
        # elements even when the far block is EMPTY).
        far_max = max((b.nnz for b in far_blocks), default=0)
        if local_format == "well_ds":
            from spmv_tpu.ds import ds_from_f64

            kl = max(max((int(b.row_nnz().max()) if b.nnz else 0)
                         for b in far_blocks), 1)
            lci, lv64 = _stack_ell(far_blocks, r, kl, dtype=np.float64)
            lv, far_lo = ds_from_f64(lv64)
        else:
            kl = 1
            lci = np.zeros((nd, r, 1), dtype=np.int32)
            lv = np.zeros((nd, r, 1), dtype=dtype or shards[0].local.dtype)
            if far_max > 0:
                far_rows = np.zeros((nd, far_max), dtype=np.int32)
                far_cols = np.zeros((nd, far_max), dtype=np.int32)
                far_vals = np.zeros((nd, far_max),
                                    dtype=dtype or shards[0].local.dtype)
                for s, bf in enumerate(far_blocks):
                    if bf.nnz == 0:
                        continue
                    far_rows[s, : bf.nnz] = np.repeat(
                        np.arange(bf.nrows, dtype=np.int32), bf.row_nnz()
                    )
                    far_cols[s, : bf.nnz] = bf.colind
                    far_vals[s, : bf.nnz] = bf.values
                    # padding slots stay (row 0, col 0, val 0): adds 0.0
    else:
        lci, lv = _stack_ell([s.local for s in shards], r, kl, dtype=dtype)
    if local_format in ("dia_ds", "well_ds"):
        from spmv_tpu.ds import ds_from_f64

        rci, rv64 = _stack_ell([s.remote for s in shards], r, kr,
                               dtype=np.float64)
        rv, remote_lo = ds_from_f64(rv64)
    else:
        rci, rv = _stack_ell([s.remote for s in shards], r, kr, dtype=dtype)
    remoteT_ci = remoteT_v = remoteT_vl = None
    if symmetric and plan.nghost_pad > 0:
        # transposed-remote ELL over ghost slots: the symmetric apply's
        # contributions to ghost columns are one gather per ghost slot. A
        # scatter-add over every (row, slot) of the remote block instead
        # piles the padding slots' adds onto ghost 0, which serialises on
        # a GPU. DS keeps error-free slot-wise chains (no rounding scatter,
        # see matvec_ds / _plan_scatter_add_ds).
        remT_blocks = [s.remote.transpose() for s in shards]
        kgT = max(max((int(b.row_nnz().max()) if b.nnz else 0)
                      for b in remT_blocks), 1)
        if local_format == "well_ds":
            remoteT_ci, rT64 = _stack_ell(remT_blocks, plan.nghost_pad, kgT,
                                          dtype=np.float64)
            remoteT_v, remoteT_vl = ds_from_f64(rT64)
        else:
            remoteT_ci, remoteT_v = _stack_ell(remT_blocks, plan.nghost_pad,
                                               kgT, dtype=rv.dtype)

    diag = None
    if symmetric:
        if local_format == "well_ds":
            from spmv_tpu.ds import ds_from_f64

            d64 = np.zeros((nd, r), dtype=np.float64)
            for s, sh in enumerate(shards):
                d64[s, : sh.nlocal] = sh.diagonal
            diag, diag_lo = ds_from_f64(d64)
        else:
            diag = np.zeros((nd, r), dtype=lv.dtype)
            for s, sh in enumerate(shards):
                diag[s, : sh.nlocal] = sh.diagonal

    # dense diagonal for Jacobi preconditioning (vanilla storage keeps the
    # diagonal inside the local block; extract it here once, host-side).
    # Only meaningful for square matrices with coinciding partitions.
    jd = np.zeros((nd, r), dtype=lv.dtype)
    if symmetric:
        jd[:] = diag
    elif nrows_global == ncols_global:
        for s, sh in enumerate(shards):
            if sh.row_range != sh.col_range:
                continue
            loc = sh.local
            lens = loc.row_nnz()
            rows = np.repeat(np.arange(loc.nrows), lens)
            on_diag = loc.colind == rows
            jd[s, rows[on_diag]] = loc.values[on_diag]

    def put(arr, spec):
        return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec))

    mspec = P(axis_names, None, None)
    if isinstance(plan, CommPlan2):
        plan = dataclasses.replace(
            plan,
            ici_send_idx=put(plan.ici_send_idx, mspec),
            ici_recv_pos=put(plan.ici_recv_pos, mspec),
            dcn_send_idx=put(plan.dcn_send_idx, mspec),
            dcn_recv_pos=put(plan.dcn_recv_pos, mspec),
            nlocal=put(plan.nlocal, P(axis_names)),
            nghosts=put(plan.nghosts, P(axis_names)),
        )
    else:
        plan = dataclasses.replace(
            plan,
            send_idx=put(plan.send_idx, mspec),
            recv_pos=put(plan.recv_pos, mspec),
            nlocal=put(plan.nlocal, P(axis_names)),
            nghosts=put(plan.nghosts, P(axis_names)),
        )
    A = DistMatrix(
        local_colind=put(lci, mspec),
        local_values=put(lv, mspec),
        remote_colind=put(rci, mspec),
        remote_values=put(rv, mspec),
        diagonal=None if diag is None else put(diag, P(axis_names, None)),
        jacobi_diag=put(jd, P(axis_names, None)),
        plan=plan,
        nrows_global=nrows_global,
        ncols_global=ncols_global,
        row_pad=row_pad,
        symmetric=symmetric,
        nnz_global=nnz_global,
        mesh=mesh,
        axis_name=axis_names,
        local_format=local_format,
        local_dia_data=None if dia_data is None else put(dia_data, mspec),
        local_dia_data_lo=(None if dia_data_lo is None
                           else put(dia_data_lo, mspec)),
        remote_values_lo=None if remote_lo is None else put(remote_lo, mspec),
        dia_offsets=dia_offsets,
        local_well_values=(None if well_stack is None
                           else put(well_stack[0], P(axis_names, None, None, None))),
        local_well_pos=(None if well_stack is None
                        else put(well_stack[1], P(axis_names, None, None, None))),
        local_well_w0=(None if well_stack is None
                       else put(well_stack[2], P(axis_names, None))),
        local_well_values_lo=(None if well_lo is None
                              else put(well_lo, P(axis_names, None, None, None))),
        local_values_lo=(None if far_lo is None
                         else put(far_lo, P(axis_names, None, None))),
        well_meta=well_meta,
        far_rows=(None if far_rows is None
                  else put(far_rows, P(axis_names, None))),
        far_cols=(None if far_cols is None
                  else put(far_cols, P(axis_names, None))),
        far_vals=(None if far_vals is None
                  else put(far_vals, P(axis_names, None))),
        well_far_nnz=int(far_max),
        local_wellT_values=(None if wellT_stack is None
                            else put(wellT_stack[0],
                                     P(axis_names, None, None, None))),
        local_wellT_pos=(None if wellT_stack is None
                         else put(wellT_stack[1],
                                  P(axis_names, None, None, None))),
        local_wellT_w0=(None if wellT_stack is None
                        else put(wellT_stack[2], P(axis_names, None))),
        wellT_meta=wellT_meta,
        farT_rows=(None if farT_rows is None
                   else put(farT_rows, P(axis_names, None))),
        farT_cols=(None if farT_cols is None
                   else put(farT_cols,
                            P(axis_names, *([None] * (farT_cols.ndim - 1))))),
        farT_vals=(None if farT_vals is None
                   else put(farT_vals,
                            P(axis_names, *([None] * (farT_vals.ndim - 1))))),
        well_farT_nnz=int(farT_max),
        local_wellT_values_lo=(None if wellT_lo is None
                               else put(wellT_lo,
                                        P(axis_names, None, None, None))),
        farT_vals_lo=(None if farT_vals_lo is None
                      else put(farT_vals_lo, P(axis_names, None, None))),
        diagonal_lo=(None if diag_lo is None
                     else put(diag_lo, P(axis_names, None))),
        remoteT_colind=(None if remoteT_ci is None
                        else put(remoteT_ci, mspec)),
        remoteT_vals=(None if remoteT_v is None
                      else put(remoteT_v, mspec)),
        remoteT_vals_lo=(None if remoteT_vl is None
                         else put(remoteT_vl, mspec)),
    )
    # plan-rederivation side data for checkpointing (io/checkpoint): the
    # per-shard ghost lists + column ranges let a checkpoint recompile the
    # halo plan for ANY mesh factorization of the same device count. Plain
    # attributes — not pytree fields (host-side save path only).
    A._ghost_lists = [np.asarray(s.ghosts, dtype=np.int64) for s in shards]
    A._col_ranges = np.asarray(col_ranges, dtype=np.int64)
    return A


def _hub_split(a: CSRHost, hub_cap):
    """Whole-row degree-skew split (VERDICT r4 item 2): rows whose nnz
    exceeds the cap leave ``a`` entirely; their entries return as global
    COO. Returns (body, hubs) with hubs = (rows_g, cols_g, vals) or None.

    ``hub_cap="auto"`` picks the power-of-two cap minimizing the RUNTIME
    touched-element count — nrows*cap padded body-ELL gathers plus
    2*hub_nnz compact hub gather+scatter elements — and skips the split
    entirely for near-uniform degree distributions (kmax <= max(64,
    4*p99)). The reference's CSR row loop is skew-indifferent (reference
    spmv/csr_kernels.cpp:42-50); here the body keeps its row-uniform
    format and the hubs get a compact gather-side term."""
    if a.nnz == 0:
        return a, None
    d = a.row_nnz()
    kmax = int(d.max())
    if hub_cap == "auto":
        p99 = float(np.percentile(d, 99)) if a.nrows else 0.0
        if kmax <= max(64, 4 * p99):
            return a, None
        # hub_nnz(c) for every candidate in one histogram pass
        hist = np.bincount(np.minimum(d, 1 << 20))
        nnz_le = np.cumsum(hist * np.arange(len(hist), dtype=np.int64))
        best_cost, cap = None, None
        for c in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
            if c >= kmax:
                break
            hub_nnz = a.nnz - int(nnz_le[min(c, len(nnz_le) - 1)])
            cost = a.nrows * c + 2 * hub_nnz
            if best_cost is None or cost < best_cost:
                best_cost, cap = cost, c
        if cap is None:
            return a, None
    else:
        cap = int(hub_cap)
        if kmax <= cap:
            return a, None
    hub_row = d > cap
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), d)
    m = hub_row[rows_g]
    body = CSRHost.from_coo(rows_g[~m], a.colind[~m].astype(np.int64),
                            a.values[~m], a.nrows, a.ncols,
                            sum_duplicates=False)
    return body, (rows_g[m], a.colind[m].astype(np.int64), a.values[m])


def _attach_hubs(A: DistMatrix, hubs, dtype) -> DistMatrix:
    """Pack the hub COO into per-shard COMPACT (F,) entry arrays over
    PADDED-GLOBAL columns (shard*col_pad + local col) and attach them to
    an assembled DistMatrix. Per-entry compactness is the point: the
    apply touches exactly hub_nnz elements each way (_hub_apply) — a
    padded (H, Kmax) layout holds 60x more elements on the power-law
    corpus matrix."""
    rows_g, cols_g, vals = hubs
    nd = A.n_devices
    cp = A.col_pad
    row_ranges = owner_ranges(A.nrows_global, nd)
    col_ranges = (owner_ranges(A.ncols_global, nd)
                  if A.ncols_global != A.nrows_global
                  else row_ranges)
    cshard = np.searchsorted(col_ranges, cols_g, side="right") - 1
    pg_cols = cshard * np.int64(cp) + (cols_g - col_ranges[cshard])
    rshard = np.searchsorted(row_ranges, rows_g, side="right") - 1
    f_max = max(int(np.bincount(rshard, minlength=nd).max())
                if len(rshard) else 0, 1)
    rownum = np.zeros((nd, f_max), dtype=np.int32)
    colind = np.zeros((nd, f_max), dtype=np.int32)
    values = np.zeros((nd, f_max), dtype=dtype or vals.dtype)
    for s in range(nd):
        sel = rshard == s
        ns = int(sel.sum())
        if ns:
            rownum[s, :ns] = (rows_g[sel] - row_ranges[s]).astype(np.int32)
            colind[s, :ns] = pg_cols[sel].astype(np.int32)
            values[s, :ns] = vals[sel]
        # padding entries stay (row 0, col 0, val 0): they add 0.0
    spec2 = P(A.axis_name, None)

    def put(arr, spec):
        return jax.device_put(jnp.asarray(arr), NamedSharding(A.mesh, spec))

    A.hub_rownum = put(rownum, spec2)
    A.hub_colind = put(colind, spec2)
    A.hub_values = put(values, spec2)
    A.hub_nnz = int(len(rows_g))
    A.nnz_global += int(len(rows_g))
    # hub rows' diagonal entries live in the hub block, not the local
    # ELL — fold them into jacobi_diag so Jacobi preconditioning stays
    # correct on hub rows (square operators only)
    if A.nrows_global == A.ncols_global:
        on_diag = rows_g == cols_g
        if on_diag.any():
            jd = np.asarray(A.jacobi_diag).copy()
            rs_, vs_ = rows_g[on_diag], vals[on_diag]
            sh_ = np.searchsorted(row_ranges, rs_, side="right") - 1
            np.add.at(jd, (sh_, rs_ - row_ranges[sh_]),
                      vs_.astype(jd.dtype))
            A.jacobi_diag = put(jd, spec2)
    return A


def select_local_format(
    a: CSRHost, symmetric: bool = False, dtype=None
) -> str:
    """Automatic local-format choice (the role of the reference's
    compile-time format heuristic, reference spmv/Matrix.cpp:61-71 — which
    always picked CSR; here the choice is real):

      dia  — banded/stencil operators (few distinct diagonals): shifted
             multiply-adds with no index traffic;
      well — general sparsity with window-local columns: the windowed
             gather-ELL layout; symmetric matrices use the dual-WELL form
             (L and a pre-built L^T as two gather stacks — no scatters);
      ell  — fallback (plain gather; also the symmetric-f64 path).

    float64 inputs auto-route to the double-single variants (``dia_ds`` /
    ``well_ds``), which give the kappa * 2^-48 accuracy envelope from
    float32 storage and arithmetic. Symmetric f64 GENERAL matrices route
    to the dual-WELL DS form (error-free everywhere incl. the reverse
    exchange); symmetric f64 BANDED stays on the native-f64 DIA path (no
    symmetric dia_ds variant yet).

    The WELL gate is format-size-aware: low-occupancy packings whose
    stored bytes exceed ~8x the ELL footprint fall back to ELL with a
    warning (a 10M-row 2%-occupancy rectangle can exceed device memory).
    """
    want_ds = dtype is not None and np.dtype(dtype) == np.float64
    if dtype is None and a.values.dtype == np.float64:
        want_ds = True
    if a.nnz == 0:
        return "ell"
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    offs = a.colind.astype(np.int64) - rows
    ndiags = len(np.unique(offs))
    if a.nrows == a.ncols and ndiags <= 64:
        if want_ds and not symmetric:
            return "dia_ds"
        return "dia"
    from spmv_tpu.formats.well import (
        _pack,
        _round_up,
        _well_scan_k_native,
        split_window,
        well_occupancy,
        LANES as _WL,
    )

    try:
        near, far = split_window(a, tile_groups=8, wseg_cap=512)
        if (far.nnz <= 0.25 * a.nnz
                and well_occupancy(near, tile_groups=8) >= 0.02):
            # size gate: predicted WELL bytes vs the ELL fallback's bytes
            # (native scan when available — the numpy dry-run lexsorts
            # nnz-sized keys, ~37 s at 4M rows)
            k_ = _well_scan_k_native(near, 8)
            if k_ is not None:
                g_ = _round_up(max(-(-near.nrows // _WL), 1), 8)
            else:
                g_, k_, _, _, _, _ = _pack(near, 8, dry_run=True)
            itemsize = 8 if want_ds else np.dtype(dtype or np.float32).itemsize
            well_bytes = g_ * k_ * 128 * (itemsize + 2)  # values + int16 pos
            kmax = int(a.row_nnz().max())
            ell_bytes = a.nrows * kmax * (itemsize + 4)  # values + int32 ind
            # trade memory for window locality, but never past 8x ELL or
            # a device-memory-scale absolute. K must also fit the conversion's default slot cap (a single
            # scattered row group past max_k would make csr_to_well raise)
            if k_ <= 64 and well_bytes <= 8 * ell_bytes and well_bytes <= 4e9:
                return "well_ds" if want_ds else "well"
            import warnings

            warnings.warn(
                f"WELL packing would store {well_bytes/1e6:.0f} MB vs "
                f"{ell_bytes/1e6:.0f} MB for ELL (occupancy "
                f"{well_occupancy(near, tile_groups=8):.3f}); falling back "
                "to ELL — consider RCM reordering (spmv_tpu.reorder) to "
                "raise occupancy", stacklevel=2,
            )
    except ValueError:
        pass
    return "ell"


def _resolve_mesh(mesh, n_devices, axis_name):
    if mesh is None:
        devs = jax.devices()[: (n_devices or len(jax.devices()))]
        mesh = Mesh(np.array(devs), (axis_name,))
    return mesh


def _warn_silent_downcast(values_dtype, dtype, local_format: str) -> None:
    """Warn when 64-bit values are about to be SILENTLY downcast at device
    upload because jax x64 is disabled (the JAX default in a plain user
    process; the test/CI harness forces it on). Without this, an f64
    matrix through the default ELL/DIA path becomes an f32 operator and a
    CG at rtol 1e-10 "converges" while the true residual floors at f32
    (measured 2e-3 relative on a 4096-row pentadiagonal — the recursive
    residual drifts from the true one). The reference is double-throughout
    (reference spmv/Matrix.cpp:565-566), so a silently-f32 operator is a
    parity trap, not a convenience. The DS formats (``local_format='auto'``
    on f64 input) deliver the f64-class envelope regardless of x64."""
    if dtype is not None:  # an explicit request is an acknowledgement
        return
    vd = np.dtype(values_dtype)
    if vd not in (np.float64, np.complex128):
        return
    if local_format in ("dia_ds", "well_ds"):  # DS pairs: x64-independent
        return
    if jax.config.jax_enable_x64:
        return
    import warnings

    warnings.warn(
        f"{vd} matrix values will be silently downcast to 32-bit at device "
        f"upload (jax_enable_x64 is False) and the {local_format!r} "
        "operator will compute at f32 accuracy while solvers still report "
        "their recursive residuals. For f64-class accuracy enable "
        "jax.config.update('jax_enable_x64', True), or (without x64) "
        "solve via spmv_tpu.cg_refined_dist / apply via matvec_ds on a "
        "local_format='auto' double-single operator; pass dtype=np.float32 "
        "to acknowledge the cast and silence this.",
        stacklevel=3,
    )


def build_dist_matrix(
    a: CSRHost,
    mesh: Mesh | None = None,
    axis_name: str = "shards",
    n_devices: int | None = None,
    symmetric: bool = False,
    dtype=None,
    row_align: int = 8,
    local_format: str = "ell",
    well_wseg_cap: int = 512,
    well_max_k: int = 64,
    well_tile_groups: int | None = None,
    dia_max_diags: int = 64,
    hub_cap="auto",
    ell_bytes_cap: float = 4e9,
) -> DistMatrix:
    """Assemble a DistMatrix from a global host CSR.

    ``well_wseg_cap`` bounds the WELL window (in 128-wide segments);
    entries outside a tile's best window become the "far" remainder,
    applied as compact COO.

    ``hub_cap`` (degree-skew safety): rows with more than this many
    nonzeros leave the row-uniform local formats into a dedicated hub
    block applied gather-side against an all-gathered x (see the hub_*
    fields). ``"auto"`` (default) picks a footprint-minimizing cap and
    skips the split for near-uniform degrees; ``None`` disables.
    Vanilla (non-symmetric) real-dtype formats only — symmetric and
    double-single operators keep the whole matrix in their formats and
    rely on ``ell_bytes_cap`` to fail loudly instead of over-allocating.

    ``ell_bytes_cap``: hard ceiling on any stacked ELL block's bytes; a
    degree-skewed matrix that would OOM raises an actionable ValueError
    instead (observed: a 16k-nnz hub row drove a 33 GB colind
    allocation before this existed).

    The JAX counterpart of Matrix::create_matrix's distributed
    assembly (reference spmv/Matrix.cpp:164-480): partition rows (and, for
    rectangular operators, columns), classify local/remote(/diagonal)
    entries, discover ghosts, compile the comm plan, and upload stacked ELL
    blocks — all vectorized host-side, one device_put. For inputs that are
    already distributed (per-shard triplets, possibly with rows owned by
    other shards), use ``build_dist_matrix_from_shards``.
    """
    if local_format not in ("ell", "dia", "dia_ds", "well", "well_ds", "auto"):
        raise ValueError(f"unknown local_format {local_format!r}")
    want_ds = ((dtype is not None and np.dtype(dtype) == np.float64)
               or (dtype is None and a.values.dtype == np.float64))
    hubs = None
    if (hub_cap is not None and not symmetric
            and not np.iscomplexobj(a.values)
            and (local_format in ("ell", "well", "dia")
                 or (local_format == "auto" and not want_ds))):
        a, hubs = _hub_split(a, hub_cap)
    if local_format == "auto":
        local_format = select_local_format(a, symmetric=symmetric,
                                           dtype=dtype)
    _warn_silent_downcast(a.values.dtype, dtype, local_format)
    if local_format in ("dia", "dia_ds") and a.nrows != a.ncols:
        raise ValueError(f"local_format={local_format!r} requires a square matrix")
    if local_format == "dia_ds" and symmetric:
        raise ValueError("local_format='dia_ds' stores the full matrix "
                         "(no symmetric lower-triangle variant yet)")
    mesh = _resolve_mesh(mesh, n_devices, axis_name)
    nd = int(np.prod(list(mesh.shape.values())))
    row_align = max(row_align, 128)  # the (rows, 128) lane layout

    shards = partition_csr(a, nd, symmetric=symmetric)
    col_ranges = owner_ranges(a.ncols, nd) if a.nrows != a.ncols else owner_ranges(a.nrows, nd)
    A = _assemble(
        shards, col_ranges, a.nrows, a.ncols, a.nnz, mesh, axis_name,
        symmetric, dtype, row_align, local_format, well_wseg_cap,
        well_max_k, well_tile_groups, dia_max_diags, ell_bytes_cap,
    )
    if hubs is not None:
        A = _attach_hubs(A, hubs, dtype)
    # side data for transposed(): the assembly-time host matrix + rebuild
    # args. Plain attributes, NOT pytree fields — they vanish across
    # jit/tree transforms (transposed() is a host-side pre-loop helper).
    A._host_csr = a if hubs is None else None  # body only; rebuilt below
    A._rebuild_kwargs = dict(
        mesh=mesh, axis_name=axis_name, dtype=dtype,
        local_format=local_format, well_wseg_cap=well_wseg_cap,
        well_max_k=well_max_k, hub_cap=hub_cap,
        ell_bytes_cap=ell_bytes_cap,
    )
    if hubs is not None:
        # transposed() needs the FULL matrix: stitch hubs back in host-side
        hr, hc, hv = hubs
        lens = a.row_nnz()
        rows_b = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
        A._host_csr = CSRHost.from_coo(
            np.concatenate([rows_b, hr]),
            np.concatenate([a.colind.astype(np.int64), hc]),
            np.concatenate([a.values, hv]), a.nrows, a.ncols,
            sum_duplicates=False)
        A._rebuild_kwargs["local_format"] = "auto"  # body of A^T may differ
    return A


def build_dist_matrix_from_shards(
    triplets: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    nrows_global: int,
    ncols_global: int | None = None,
    mesh: Mesh | None = None,
    axis_name: str = "shards",
    symmetric: bool = False,
    dtype=None,
    row_align: int = 8,
    local_format: str = "ell",
    well_wseg_cap: int = 512,
) -> DistMatrix:
    """Assemble from PRE-DISTRIBUTED per-shard COO triplets with row ghosts.

    ``triplets[s] = (rows, cols, vals)`` uses GLOBAL indices; rows outside
    shard s's owned range are ROW GHOSTS and are redistributed to their
    owners host-side (the counterpart of the reference's
    ghost-row shipment over a dist-graph communicator,
    reference spmv/Matrix.cpp:164-292; ``row_ghosts`` in spmv/Matrix.h:97).
    Contributions to the same entry from different shards SUM — overlapping
    partitions (FEM-style additive assembly) are supported, which the
    reference enables via its ``overlap`` flag (spmv/L2GMap.h:76).

    Unlike ``build_dist_matrix`` this never materializes a global CSR: each
    owner assembles only its own row slice, so host memory stays bounded by
    the largest slice.
    """
    if local_format not in ("ell", "dia", "dia_ds", "well", "well_ds"):
        raise ValueError(f"unknown local_format {local_format!r}")
    ncols_global = nrows_global if ncols_global is None else ncols_global
    if local_format == "dia" and nrows_global != ncols_global:
        raise ValueError("local_format='dia' requires a square matrix")
    if triplets and len(triplets[0]) == 3:
        _warn_silent_downcast(np.asarray(triplets[0][2]).dtype, dtype,
                              local_format)
    mesh = _resolve_mesh(mesh, len(triplets), axis_name)
    nd = int(np.prod(list(mesh.shape.values())))
    if nd != len(triplets):
        raise ValueError(f"{len(triplets)} triplet shards for a {nd}-device mesh")
    row_align = max(row_align, 128)  # the (rows, 128) lane layout

    row_ranges = owner_ranges(nrows_global, nd)
    col_ranges = (row_ranges if nrows_global == ncols_global
                  else owner_ranges(ncols_global, nd))

    # redistribute: bucket every shard's triplets by owning shard of the row
    # (vectorized owner lookup, reference spmv/Matrix.cpp:190-218 semantics)
    from spmv_tpu.parallel.partition import classify_shard, owner_of

    buckets: list[list[tuple[np.ndarray, np.ndarray, np.ndarray]]] = [
        [] for _ in range(nd)
    ]
    nnz_global = 0
    for s, (rows, cols, vals) in enumerate(triplets):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        if len(rows) and (rows.min() < 0 or rows.max() >= nrows_global):
            raise ValueError(f"shard {s}: row index outside global range")
        if len(cols) and (cols.min() < 0 or cols.max() >= ncols_global):
            raise ValueError(f"shard {s}: col index outside global range")
        owners = owner_of(row_ranges, rows)
        for o in np.unique(owners):
            sel = owners == o
            buckets[int(o)].append((rows[sel], cols[sel], vals[sel]))

    shards = []
    val_dtype = (np.asarray(triplets[0][2]).dtype if triplets and
                 len(triplets[0]) == 3 else np.float64)
    for o in range(nd):
        r0, r1 = int(row_ranges[o]), int(row_ranges[o + 1])
        if buckets[o]:
            rows = np.concatenate([b[0] for b in buckets[o]]) - r0
            cols = np.concatenate([b[1] for b in buckets[o]])
            vals = np.concatenate([b[2] for b in buckets[o]])
        else:
            rows = np.empty(0, np.int64)
            cols = np.empty(0, np.int64)
            vals = np.empty(0, val_dtype)
        # duplicate entries (overlapping partitions) sum here, once, on the
        # owner — before classification so symmetric/diagonal splits see the
        # assembled values
        merged = CSRHost.from_coo(
            rows, cols, vals, r1 - r0, max(ncols_global, 1), sum_duplicates=True
        )
        nnz_global += merged.nnz
        shards.append(
            # merged is canonical (from_coo sum_duplicates=True): the
            # no-sort classify path
            classify_shard(
                None, merged.colind, merged.values,
                (r0, r1), (int(col_ranges[o]), int(col_ranges[o + 1])),
                symmetric=symmetric, rowptr=merged.rowptr,
            )
        )
    return _assemble(
        shards, col_ranges, nrows_global, ncols_global, nnz_global, mesh,
        axis_name, symmetric, dtype, row_align, local_format,
    )
