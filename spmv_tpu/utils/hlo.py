"""Dataflow and schedule queries on compiled HLO text.

``jax.jit(f).lower(...).compile().as_text()`` prints the optimized module;
for a scheduled module the ENTRY computation lists its instructions in
execution order. These helpers answer the two questions the halo/interior
overlap rests on:

- ``interior_products_independent`` — do the interior products (the
  multiplies that read the local matrix) depend on any collective-permute?
  If not, nothing in the dataflow stops the halo exchange from running
  while they do.
- ``halo_bracket`` — in the scheduled ENTRY order, does some
  collective-permute-start come before the instruction that reads the
  local matrix, and its done after it? Only async collectives (GPU) can
  bracket; the CPU backend runs collectives synchronously.
"""
from __future__ import annotations

import re

_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s+->\s+.*\{\s*$")
_NAME = re.compile(r"%([\w.\-]+)")


def _split_instruction(line: str):
    """'%n = TYPE op(args), attrs' -> (n, op, [operand names], line)."""
    body = line.strip()
    if body.startswith("ROOT "):
        body = body[5:]
    if "=" not in body or not body.startswith("%"):
        return None
    name, rest = body.split("=", 1)
    rest = rest.strip()
    if rest.startswith("("):  # tuple-typed result: skip the type
        depth = 0
        for i, ch in enumerate(rest):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                rest = rest[i + 1:].strip()
                break
    else:
        rest = rest.split(" ", 1)[1] if " " in rest else ""
    if "(" not in rest:
        return None
    op, args = rest.split("(", 1)
    depth, end = 1, len(args)
    for i, ch in enumerate(args):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0:
            end = i
            break
    return (name.strip().lstrip("%"), op.strip(), _NAME.findall(args[:end]),
            line)


def parse_hlo(text: str) -> tuple[str, dict]:
    """Returns (entry computation name, {computation: [instructions]})
    with each instruction as (name, opcode, operands, line)."""
    comps: dict = {}
    entry, cur = None, None
    for line in text.splitlines():
        m = _HEADER.match(line.strip())
        if m:
            cur = m.group(2)
            comps[cur] = []
            if m.group(1):
                entry = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is not None:
            inst = _split_instruction(line)
            if inst is not None:
                comps[cur].append(inst)
    return entry, comps


def _param_index(line: str) -> int | None:
    m = re.search(r"\bparameter\((\d+)\)", line)
    return int(m.group(1)) if m else None


def _ancestors(insts, roots: set[str]) -> set[str]:
    by_name = {i[0]: i for i in insts}
    seen, stack = set(), list(roots)
    while stack:
        n = stack.pop()
        if n in seen or n not in by_name:
            continue
        seen.add(n)
        stack.extend(by_name[n][2])
    return seen


def _find_param(entry_insts, tag: str) -> str:
    for name, op, _, line in entry_insts:
        if op == "parameter" and tag in line:
            return name
    raise ValueError(f"no ENTRY parameter tagged {tag!r}")


def _collective_dependents(entry_insts) -> set[str]:
    """ENTRY instructions that are, or transitively read, a collective."""
    dep: set[str] = set()
    for name, op, operands, _ in entry_insts:  # defs precede uses
        if op.startswith("collective-permute") or any(o in dep for o in operands):
            dep.add(name)
    return dep


def interior_products_independent(text: str, tag: str) -> list[tuple[str, bool]]:
    """For every multiply that reads the ENTRY parameter whose metadata
    holds ``tag`` (e.g. "local_dia_data"), whether it depends on a
    collective-permute. Looks through fusions: inside a fused computation
    only the operands a multiply actually reaches count."""
    entry, comps = parse_hlo(text)
    insts = comps[entry]
    param = _find_param(insts, tag)
    coll = _collective_dependents(insts)
    out = []
    for name, op, operands, line in insts:
        if param not in operands:
            continue
        m = re.search(r"calls=%([\w.\-]+)", line)
        if op != "fusion" or not m:
            out.append((name, name in coll))
            continue
        body = comps[m.group(1)]
        params = {_param_index(l): n for n, o, _, l in body if o == "parameter"}
        src = params[operands.index(param)]
        below = {src}
        for n, o, ops_, _ in body:
            if any(p in below for p in ops_):
                below.add(n)
        for n, o, _, _ in body:
            if o == "multiply" and n in below:
                idx = {_param_index(l) for a, oo, _, l in body
                       if oo == "parameter" and a in _ancestors(body, {n})}
                out.append((n, any(operands[i] in coll for i in idx)))
    return out


def halo_bracket(text: str, tag: str) -> dict:
    """Scheduled-order positions in ENTRY of the async halo collectives and
    of the first instruction reading the ``tag`` parameter; ``bracketed``
    says whether some start precedes it and its matching done follows."""
    entry, comps = parse_hlo(text)
    insts = comps[entry]
    param = _find_param(insts, tag)
    pos = {n: i for i, (n, *_) in enumerate(insts)}
    interior = next(i for i, (n, o, ops_, _) in enumerate(insts)
                    if param in ops_)
    pairs = []
    for name, op, operands, _ in insts:
        if op == "collective-permute-done" and operands:
            pairs.append((pos.get(operands[0], -1), pos[name]))
    return {
        "interior": insts[interior][0],
        "interior_op": insts[interior][1],
        "n_async_permutes": len(pairs),
        "n_sync_permutes": sum(1 for _, o, _, _ in insts
                               if o == "collective-permute"),
        "bracketed": any(s < interior < d for s, d in pairs),
    }
