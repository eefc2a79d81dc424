"""Checkpoint / resume for distributed solves.

The reference has NO checkpointing (SURVEY.md section 5: "Checkpoint /
resume: none") — its only persistence is the input-only PETSc reader. For a
production solver on preemptible accelerator pools that is a real gap: a 100M-row CG
run losing 500 iterations to a preemption restarts from zero. This module
adds simple, dependency-light persistence:

  - ``save_dist_matrix`` / ``load_dist_matrix``: the assembled operator
    (stacked ELL blocks + comm plan), so re-assembly (the expensive
    host-side partition/plan compile) is skipped on resume;
  - ``save_solver_state`` / ``load_solver_state``: x (and any extra
    vectors) mid-solve; CG restarted from x0=x_saved re-derives r and p
    (a standard restarted-CG resume — the Krylov space restarts, the
    solution does not).

Format: a single .npz (numpy, portable, no orbax dependency for plain
arrays) + a JSON sidecar for static metadata.
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from spmv_tpu.parallel.comm_plan import CommPlan, CommPlan2
from spmv_tpu.parallel.dist_matrix import DIST_DATA_FIELDS, DistMatrix


def _npz_path(path: str) -> str:
    """Normalize once in save AND load: np.savez appends '.npz' when absent,
    while np.load takes the path verbatim — without this, a suffix-less path
    saves fine but fails to load, and the .meta.json sidecar name diverges
    from the actual array file."""
    return path if path.endswith(".npz") else path + ".npz"


def save_dist_matrix(path: str, a: DistMatrix) -> None:
    """Persist the assembled operator (without the mesh — meshes are
    machine-specific and are re-supplied at load). Every array field of the
    DistMatrix pytree is saved by name, so ALL local formats round-trip
    (ell/dia/well and their double-single variants).

    Both plan tiers checkpoint: one-tier (CommPlan) and two-tier
    (CommPlan2, the pod-scale DCN/ICI plans — exactly where preemption
    recovery matters most). When the operator carries its assembly-time
    ghost lists (operators from build_dist_matrix do), they are saved too,
    and ``load_dist_matrix`` can RE-DERIVE the plan for a differently
    factored mesh of the same device count (e.g. a (2,4) two-tier save
    loading onto an 8-device 1-D mesh, or onto (4,2))."""
    path = _npz_path(path)
    two_tier = isinstance(a.plan, CommPlan2)
    if two_tier:
        arrays = {
            "plan_ici_send_idx": np.asarray(a.plan.ici_send_idx),
            "plan_ici_recv_pos": np.asarray(a.plan.ici_recv_pos),
            "plan_dcn_send_idx": np.asarray(a.plan.dcn_send_idx),
            "plan_dcn_recv_pos": np.asarray(a.plan.dcn_recv_pos),
            "plan_nlocal": np.asarray(a.plan.nlocal),
            "plan_nghosts": np.asarray(a.plan.nghosts),
        }
    else:
        arrays = {
            "plan_send_idx": np.asarray(a.plan.send_idx),
            "plan_recv_pos": np.asarray(a.plan.recv_pos),
            "plan_nlocal": np.asarray(a.plan.nlocal),
            "plan_nghosts": np.asarray(a.plan.nghosts),
        }
    ghost_lists = getattr(a, "_ghost_lists", None)
    col_ranges = getattr(a, "_col_ranges", None)
    if ghost_lists is not None and col_ranges is not None:
        gmax = max((len(g) for g in ghost_lists), default=0)
        gpad = np.full((len(ghost_lists), max(gmax, 1)), -1, dtype=np.int64)
        for s, g in enumerate(ghost_lists):
            gpad[s, : len(g)] = g
        arrays["plan_ghost_lists"] = gpad
        arrays["plan_col_ranges"] = np.asarray(col_ranges, dtype=np.int64)
    for name in DIST_DATA_FIELDS:
        if name == "plan":
            continue
        v = getattr(a, name)
        if v is not None:
            arrays[name] = np.asarray(v)
    np.savez_compressed(path, **arrays)
    axis_name = (list(a.axis_name) if isinstance(a.axis_name, tuple)
                 else a.axis_name)
    if two_tier:
        plan_meta = {
            "type": "two_tier",
            "rounds_ici": list(a.plan.rounds_ici),
            "rounds_dcn": [list(r) for r in a.plan.rounds_dcn],
            "n_dcn": a.plan.n_dcn,
            "n_ici": a.plan.n_ici,
            "n_devices": a.plan.n_devices,
            "nlocal_pad": a.plan.nlocal_pad,
            "nghost_pad": a.plan.nghost_pad,
        }
    else:
        plan_meta = {
            "type": "one_tier",
            "rounds": list(a.plan.rounds),
            "n_devices": a.plan.n_devices,
            "nlocal_pad": a.plan.nlocal_pad,
            "nghost_pad": a.plan.nghost_pad,
        }
    meta = {
        "version": 2,
        "nrows_global": a.nrows_global,
        "ncols_global": a.ncols_global,
        "row_pad": a.row_pad,
        "symmetric": a.symmetric,
        "nnz_global": a.nnz_global,
        "axis_name": axis_name,
        "local_format": a.local_format,
        "dia_offsets": list(a.dia_offsets),
        "well_meta": list(a.well_meta),
        "well_far_nnz": a.well_far_nnz,
        "wellT_meta": list(a.wellT_meta),
        "well_farT_nnz": a.well_farT_nnz,
        "hub_nnz": a.hub_nnz,
        "dia_layout": "interleaved",
        "plan": plan_meta,
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_dist_matrix(path: str, mesh=None) -> DistMatrix:
    """Load an operator saved by save_dist_matrix onto ``mesh``.

    Default mesh: the checkpoint's own shape — 1-D over n_devices for
    one-tier saves, (n_dcn, n_ici) 2-D for two-tier saves. Passing a mesh
    with a DIFFERENT factorization of the SAME device count (e.g. 1-D 8 for
    a (2,4) save, or (4,2)) re-derives the halo plan from the saved ghost
    lists — the matvec is bitwise-equal either way (two-tier plans are
    bitwise-equal to one-tier by construction, tests/test_two_tier.py)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    path = _npz_path(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    z = np.load(path)
    pm = meta["plan"]
    saved_two_tier = pm.get("type", "one_tier") == "two_tier"
    axis = meta["axis_name"]
    axis = tuple(axis) if isinstance(axis, list) else axis
    if mesh is None:
        devs = jax.devices()
        if len(devs) < pm["n_devices"]:
            raise ValueError(
                f"checkpoint needs {pm['n_devices']} devices, have {len(devs)}"
            )
        if saved_two_tier:
            mesh = Mesh(
                np.array(devs[: pm["n_devices"]]).reshape(
                    pm["n_dcn"], pm["n_ici"]
                ),
                axis if isinstance(axis, tuple) else ("dcn", "ici"),
            )
        else:
            mesh = Mesh(np.array(devs[: pm["n_devices"]]), (axis,))

    mesh_nd = int(np.prod([mesh.shape[n] for n in mesh.axis_names]))
    if mesh_nd != pm["n_devices"]:
        raise ValueError(
            f"checkpoint has {pm['n_devices']} shards; mesh has {mesh_nd} "
            "devices (re-sharding to a different device count requires "
            "re-assembly from the source matrix)"
        )
    mesh_two_tier = len(mesh.axis_names) > 1
    axis_names = (tuple(mesh.axis_names) if mesh_two_tier
                  else mesh.axis_names[0])

    def put(arr, spec):
        return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec))

    mspec = P(axis_names, None, None)
    same_shape = (
        saved_two_tier == mesh_two_tier
        and (not saved_two_tier
             or (mesh.shape[mesh.axis_names[0]] == pm["n_dcn"]
                 and mesh.shape[mesh.axis_names[1]] == pm["n_ici"]))
    )
    if same_shape and saved_two_tier:
        plan = CommPlan2(
            ici_send_idx=put(z["plan_ici_send_idx"], mspec),
            ici_recv_pos=put(z["plan_ici_recv_pos"], mspec),
            dcn_send_idx=put(z["plan_dcn_send_idx"], mspec),
            dcn_recv_pos=put(z["plan_dcn_recv_pos"], mspec),
            nlocal=put(z["plan_nlocal"], P(axis_names)),
            nghosts=put(z["plan_nghosts"], P(axis_names)),
            rounds_ici=tuple(pm["rounds_ici"]),
            rounds_dcn=tuple(tuple(r) for r in pm["rounds_dcn"]),
            n_dcn=pm["n_dcn"],
            n_ici=pm["n_ici"],
            nlocal_pad=pm["nlocal_pad"],
            nghost_pad=pm["nghost_pad"],
        )
    elif same_shape:
        plan = CommPlan(
            send_idx=put(z["plan_send_idx"], mspec),
            recv_pos=put(z["plan_recv_pos"], mspec),
            nlocal=put(z["plan_nlocal"], P(axis_names)),
            nghosts=put(z["plan_nghosts"], P(axis_names)),
            rounds=tuple(pm["rounds"]),
            n_devices=pm["n_devices"],
            nlocal_pad=pm["nlocal_pad"],
            nghost_pad=pm["nghost_pad"],
        )
    else:
        # differently-factored mesh: re-derive the plan from the saved
        # ghost lists (same shard count -> same local data, same ghost
        # numbering, only the permute schedule changes)
        if "plan_ghost_lists" not in z:
            raise ValueError(
                "checkpoint lacks ghost lists (pre-v2 save); load onto a "
                f"mesh matching the saved shape or re-assemble "
                f"(saved: {'two_tier' if saved_two_tier else 'one_tier'})"
            )
        from spmv_tpu.parallel.comm_plan import (
            compile_plan,
            compile_plan_two_tier,
        )

        gl = z["plan_ghost_lists"]
        ghosts = [g[g >= 0] for g in gl]
        col_ranges = z["plan_col_ranges"]
        if mesh_two_tier:
            plan = compile_plan_two_tier(
                col_ranges, ghosts,
                mesh.shape[mesh.axis_names[0]],
                mesh.shape[mesh.axis_names[1]],
                row_align=pm["nlocal_pad"],
            )
        else:
            plan = compile_plan(col_ranges, ghosts,
                                row_align=pm["nlocal_pad"])
        if plan.nlocal_pad != pm["nlocal_pad"]:
            raise ValueError(
                f"re-derived plan pad {plan.nlocal_pad} != saved "
                f"{pm['nlocal_pad']}"
            )
        replace = {}
        for f in dataclasses.fields(plan):
            v = getattr(plan, f.name)
            if hasattr(v, "ndim") and v.ndim >= 1:
                spec = mspec if v.ndim == 3 else P(axis_names)
                replace[f.name] = put(v, spec)
        plan = dataclasses.replace(plan, **replace)
    kwargs = {}
    for name in DIST_DATA_FIELDS:
        if name == "plan":
            continue
        if name in z:
            arr = z[name]
            if name == "local_dia_data":
                arr = _dia_to_interleaved(arr, meta.get("dia_layout"))
            kwargs[name] = put(arr, P(axis_names, *([None] * (arr.ndim - 1))))
        else:
            kwargs[name] = None
    return DistMatrix(
        plan=plan,
        nrows_global=meta["nrows_global"],
        ncols_global=meta.get("ncols_global", meta["nrows_global"]),
        row_pad=meta.get("row_pad", pm["nlocal_pad"]),
        symmetric=meta["symmetric"],
        nnz_global=meta["nnz_global"],
        mesh=mesh,
        axis_name=axis_names,
        local_format=meta.get("local_format", "ell"),
        dia_offsets=tuple(meta.get("dia_offsets", [])),
        well_meta=tuple(meta.get("well_meta", [])),
        well_far_nnz=meta.get("well_far_nnz", 0),
        wellT_meta=tuple(meta.get("wellT_meta", [])),
        well_farT_nnz=meta.get("well_farT_nnz", 0),
        hub_nnz=meta.get("hub_nnz", 0),
        **kwargs,
    )


def _dia_to_interleaved(arr, layout):
    """Round-1 checkpoints stored (D, K, R/128, 128) per-diagonal planes;
    the device layout is now row-interleaved (D, R/128, K*128)."""
    if layout == "interleaved":
        return arr
    d, k, lr, _ = arr.shape
    return arr.transpose(0, 2, 1, 3).reshape(d, lr, k * 128)


def save_solver_state(path: str, a: DistMatrix, x, iteration: int = 0,
                      **extra_vectors) -> None:
    """Persist a mid-solve state (global host layout, mesh-independent)."""
    path = _npz_path(path)
    arrays = {"x": a.from_dist(x)}
    for name, v in extra_vectors.items():
        arrays[name] = a.from_dist(v)
    np.savez_compressed(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump({"version": 1, "iteration": int(iteration)}, f)


def load_solver_state(path: str, a: DistMatrix):
    """Returns (vectors: dict of sharded arrays, iteration)."""
    path = _npz_path(path)
    z = np.load(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    vectors = {name: a.to_dist(z[name]) for name in z.files}
    return vectors, meta["iteration"]
