"""Mesh routing: the plane counterpart of the copTask pushdown decision.

The port of the JAX package's plan/mesh_route.py. This post-pass walks a
finished physical plan and, when a process plane of more than one shard
is installed (tidb_tpu_torch.devplane), replaces qualifying subtrees with
plane operators:

* PhysMeshAgg — a pushed-down group-by aggregation over one table scan
  (TPC-H Q1 shape) runs as ops/meshagg.MeshAggKernel: rows sharded over
  the ("batch",) plane, a gather merge across the shards.
* PhysMeshLookupAgg — an inner-join star over one fact table plus
  unique-keyed dimension tables feeding a group-by (Q3/Q5 shape) runs as
  ops/meshjoin.MeshLookupAggKernel: fused filter -> lookup chain ->
  aggregate, dimensions replicated per device.

Every plane node keeps the original subtree as `fallback`; the executor
delegates to it when no plane is active at run time or the kernel
rejects the data (capacity overflow, hash collision, duplicate build
keys).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from tidb_tpu_torch.expression import ColumnRef, Expression
from tidb_tpu_torch.expression.core import Op, func
from tidb_tpu_torch.plan import physical as ph
from tidb_tpu_torch.plan.resolver import PlanSchema, SchemaCol
from tidb_tpu_torch.sqltypes import new_int_field

__all__ = ["PhysMeshAgg", "PhysMeshLookupAgg", "MeshLookupDesc",
           "route_mesh"]


@dataclass
class PhysMeshAgg(ph.PhysPlan):
    """Group-by aggregation executed on the device mesh. children[0] is
    the raw scan (the agg-pushdown cop stripped of its agg); group/agg
    expressions index the scan schema."""

    group_exprs: list = field(default_factory=list)
    aggs: list = field(default_factory=list)
    num_group_cols: int = 0
    filter_expr: Expression = None   # device-safe filter lifted from the cop
    fallback: ph.PhysPlan = None

    def _explain_info(self):
        return f" group:{self.group_exprs!r} aggs:{self.aggs!r}"


@dataclass
class MeshLookupDesc:
    """One dimension lookup of a PhysMeshLookupAgg. key_exprs index the
    virtual schema (probe columns, then payloads of earlier lookups);
    build offsets index the build plan's schema."""

    key_exprs: list
    build_plan: ph.PhysPlan
    build_key_offsets: list
    payload_offsets: list


@dataclass
class PhysMeshLookupAgg(ph.PhysPlan):
    """Star join + aggregation on the mesh. children[0] is the probe
    (fact) scan; filter/group/agg expressions index the virtual schema."""

    lookups: list = field(default_factory=list)
    filter_expr: Expression = None
    group_exprs: list = field(default_factory=list)
    aggs: list = field(default_factory=list)
    num_group_cols: int = 0
    fallback: ph.PhysPlan = None

    def _explain_info(self):
        dims = ",".join(lk.build_plan.cop.table.name for lk in self.lookups)
        return (f" dims:[{dims}] group:{self.group_exprs!r} "
                f"aggs:{self.aggs!r}")


def route_mesh(plan: ph.PhysPlan) -> ph.PhysPlan:
    """Rewrite qualifying agg subtrees to plane operators. No-op when no
    process plane is configured, or when it has a single shard:
    sharding over one device only adds gather overhead, and it routes
    scans around the storage-side columnar caches (the copTask path
    serves repeated scans from the HBM device cache and fuses
    scan->filter->partial-agg into one dispatch). The decision depends
    only on the plane itself, so plans stay coherent with the
    mesh_generation() plan-cache key."""
    from tidb_tpu_torch import devplane as config

    mesh = config.active_mesh()
    if mesh is None or mesh.devices.size <= 1:
        return plan
    return _route(plan)


def _route(plan: ph.PhysPlan) -> ph.PhysPlan:
    routed = None
    if isinstance(plan, ph.PhysFinalAgg):
        routed = _try_mesh_agg(plan)
    elif isinstance(plan, ph.PhysHashAgg):
        routed = _try_mesh_lookup_agg(plan)
    if routed is not None:
        return routed
    for i, c in enumerate(plan.children):
        plan.children[i] = _route(c)
    if isinstance(plan, ph.PhysApply) and plan.inner is not None:
        plan.inner = _route(plan.inner)
    return plan


# -- pattern A: pushed-down group agg over one scan (Q1) --------------------

def _try_mesh_agg(final: ph.PhysFinalAgg):
    reader = final.children[0]
    if not isinstance(reader, ph.PhysTableReader):
        return None
    cop = reader.cop
    if not cop.is_agg or not cop.group_exprs:
        return None
    if any(a.distinct for a in cop.aggs):
        return None
    if not _exprs_mesh_safe(cop.group_exprs, cop.aggs, None):
        return None
    raw_cop = replace(cop, group_exprs=None, aggs=None)
    # lift a device-safe scan filter into the mesh kernel: the raw scan
    # then serves identical (cacheable) chunks to every query and the
    # filter runs fused on device instead of per-query host numpy
    dev_filter = None
    if raw_cop.filter is not None and raw_cop.filter.is_device_safe():
        dev_filter = raw_cop.filter
        raw_cop = replace(raw_cop, filter=None)
    # the stripped reader yields the raw scan columns, not the agg output:
    # give it a schema to match (children[0].schema must not lie)
    raw_cols = [SchemaCol(c.name.lower(), cop.table.name.lower(), c.ft, c.id)
                for c in raw_cop.cols]
    if raw_cop.handle_col is not None:
        raw_cols.insert(raw_cop.handle_col,
                        SchemaCol("_handle", cop.table.name.lower(),
                                  new_int_field()))
    raw_reader = ph.PhysTableReader(schema=PlanSchema(raw_cols), cop=raw_cop)
    return PhysMeshAgg(schema=final.schema, children=[raw_reader],
                       group_exprs=list(cop.group_exprs),
                       aggs=list(cop.aggs),
                       num_group_cols=final.num_group_cols,
                       filter_expr=dev_filter,
                       fallback=final)


def _exprs_mesh_safe(group_exprs, aggs, filter_expr) -> bool:
    """Plan-time device-safety screen (the kernels re-validate): group
    keys must be device-safe or bare (dict-encodable) column refs; agg
    args and filters must be fully device-safe."""
    for g in group_exprs:
        if not g.is_device_safe() and not isinstance(g, ColumnRef):
            return False
    for a in aggs:
        if a.arg is not None and not a.arg.is_device_safe():
            return False
    if filter_expr is not None and not filter_expr.is_device_safe():
        return False
    return True


# -- pattern B: star join + group agg (Q3/Q5) -------------------------------

def _try_mesh_lookup_agg(agg: ph.PhysHashAgg):
    if not agg.group_exprs or any(a.distinct for a in agg.aggs):
        return None
    # Peel selections between the agg and the join root; their conditions
    # join the filter set (they are in the join-output = global frame).
    node = agg.children[0]
    extra_conds = []
    while isinstance(node, ph.PhysSelection):
        extra_conds.append(node.cond)
        node = node.children[0]
    if not isinstance(node, ph.PhysHashJoin):
        return None
    flat = _flatten_joins(node, 0)
    if flat is None:
        return None
    leaves, eq_conds, other_conds = flat
    if len(leaves) < 2:
        return None
    other_conds = other_conds + extra_conds

    order = _probe_preference(leaves, eq_conds)
    for probe_i in order:
        chain = _build_chain(leaves, eq_conds, probe_i)
        if chain is None:
            continue
        routed = _assemble(agg, leaves, probe_i, chain, other_conds)
        if routed is not None:
            return routed
    return None


def _flatten_joins(p: ph.PhysPlan, base: int):
    """-> (leaves [(reader, base, width)], eq_conds [(lexpr, rexpr)] in the
    global frame, other_conds [expr]) or None if the tree has a shape the
    lookup pipeline cannot express."""
    if isinstance(p, ph.PhysHashJoin):
        if p.join_type != "inner" or not p.left_keys:
            return None
        nl = len(p.children[0].schema)
        left = _flatten_joins(p.children[0], base)
        right = _flatten_joins(p.children[1], base + nl)
        if left is None or right is None:
            return None
        leaves = left[0] + right[0]
        eq = left[1] + right[1]
        other = left[2] + right[2]
        for lk, rk in zip(p.left_keys, p.right_keys):
            eq.append((_shift(lk, base), _shift(rk, base + nl)))
        if p.other_cond is not None:
            other.append(_shift(p.other_cond, base))
        return leaves, eq, other
    if isinstance(p, ph.PhysTableReader) and not p.cop.is_agg and \
            p.cop.limit is None and p.cop.index is None:
        return [(p, base, len(p.schema))], [], []
    return None


def _shift(e: Expression, base: int) -> Expression:
    if base == 0:
        return e
    return e.map_columns({i: i + base for i in e.columns_used()})


def _probe_preference(leaves, eq_conds) -> list:
    """Try leaves as the probe side: leaves that cannot serve as a
    dimension (their join columns are not unique-keyed) first — the fact
    table — then by estimated size descending."""
    def dimmable(i):
        reader, base, width = leaves[i]
        offs = set()
        for a, b in eq_conds:
            for e in (a, b):
                if isinstance(e, ColumnRef) and \
                        base <= e.idx < base + width:
                    offs.add(e.idx - base)
        return bool(offs) and _is_unique_key(reader, offs)

    def key(i):
        reader, _b, _w = leaves[i]
        est = reader.est_rows if reader.est_rows is not None else 0
        return (dimmable(i), -est)
    return sorted(range(len(leaves)), key=key)


def _leaf_of(cols: set, leaves) -> int | None:
    """Index of the single leaf containing every global column in cols."""
    for i, (_r, base, width) in enumerate(leaves):
        if all(base <= c < base + width for c in cols):
            return i
    return None


def _is_unique_key(reader: ph.PhysTableReader, local_offsets) -> bool:
    """Do the leaf-local key columns contain a primary/unique key?"""
    info = reader.cop.table
    names = {reader.cop.cols[o].name.lower() for o in local_offsets}
    if info.pk_is_handle and info.pk_col_name.lower() in names:
        return True
    for idx in info.indexes:
        if idx.unique and \
                all(c.lower() in names for c in idx.columns):
            return True
    return False


def _build_chain(leaves, eq_conds, probe_i):
    """Greedy lookup-chain construction. -> ([(leaf_i, key_pairs)],
    leftover) where key_pairs is [(covered_side_expr_global,
    dim_local_offset)] and leftover holds equality conds with both sides
    covered (they become payload-equality filters), or None when no
    complete chain exists from this probe."""
    covered = {probe_i}
    pending = list(range(len(eq_conds)))
    chain = []
    leftover = []
    while True:
        # conds with both sides covered become filters
        still = []
        for ci in pending:
            a, b = eq_conds[ci]
            if _covered(a, leaves, covered) and \
                    _covered(b, leaves, covered):
                leftover.append((a, b))
            else:
                still.append(ci)
        pending = still
        if not pending:
            break
        # usable: per uncovered leaf, the conds that could key it NOW
        usable: dict[int, list] = {}
        for ci in pending:
            a, b = eq_conds[ci]
            la = _leaf_of(a.columns_used(), leaves)
            lb = _leaf_of(b.columns_used(), leaves)
            if _covered(a, leaves, covered) and lb is not None and \
                    lb not in covered and isinstance(b, ColumnRef):
                usable.setdefault(lb, []).append(
                    (ci, a, b.idx - leaves[lb][1]))
            elif _covered(b, leaves, covered) and la is not None and \
                    la not in covered and isinstance(a, ColumnRef):
                usable.setdefault(la, []).append(
                    (ci, b, a.idx - leaves[la][1]))
        picked = None
        for li, triples in usable.items():
            if _is_unique_key(leaves[li][0], [o for _ci, _e, o in triples]):
                picked = (li, triples)
                break
        if picked is None:
            return None        # stuck: remaining conds can't key any dim
        li, triples = picked
        chain.append((li, [(e, o) for _ci, e, o in triples]))
        covered.add(li)
        consumed = {ci for ci, _e, _o in triples}
        pending = [ci for ci in pending if ci not in consumed]
    if len(covered) != len(leaves):
        return None            # disconnected table (cross join residue)
    return chain, leftover


def _covered(e: Expression, leaves, covered) -> bool:
    cols = e.columns_used()
    if not cols:
        return False
    ranges = [(leaves[i][1], leaves[i][1] + leaves[i][2]) for i in covered]
    return all(any(lo <= c < hi for lo, hi in ranges) for c in cols)


def _assemble(agg, leaves, probe_i, chain_leftover, other_conds):
    chain, leftover = chain_leftover
    probe_reader, probe_base, probe_w = leaves[probe_i]

    # needed global columns beyond the probe: later keys, groups, aggs,
    # filters (leftover equalities + other/selection conds)
    needed = set()
    for _li, pairs in chain:
        for e, _o in pairs:
            needed |= e.columns_used()
    for g in agg.group_exprs:
        needed |= g.columns_used()
    for a in agg.aggs:
        if a.arg is not None:
            needed |= a.arg.columns_used()
    for a, b in leftover:
        needed |= a.columns_used() | b.columns_used()
    for c in other_conds:
        needed |= c.columns_used()

    # virtual schema: probe columns first, then payloads in chain order
    vmap = {probe_base + i: i for i in range(probe_w)}
    nxt = probe_w
    lookups = []
    for li, pairs in chain:
        reader, base, width = leaves[li]
        pay = sorted({c - base for c in needed
                      if base <= c < base + width})
        for o in pay:
            vmap[base + o] = nxt
            nxt += 1
        lookups.append((li, pairs, pay))

    def remap(e):
        used = e.columns_used()
        if not all(c in vmap for c in used):
            raise KeyError
        return e.map_columns({c: vmap[c] for c in used})

    try:
        descs = []
        for li, pairs, pay in lookups:
            descs.append(MeshLookupDesc(
                key_exprs=[remap(e) for e, _o in pairs],
                build_plan=leaves[li][0],
                build_key_offsets=[o for _e, o in pairs],
                payload_offsets=pay))
        filt = None
        for a, b in leftover:
            filt = _and(filt, func(Op.EQ, remap(a), remap(b)))
        for c in other_conds:
            filt = _and(filt, remap(c))
        group_exprs = [remap(g) for g in agg.group_exprs]
        aggs = [replace(a, arg=remap(a.arg)) if a.arg is not None else a
                for a in agg.aggs]
    except KeyError:
        return None
    if not _exprs_mesh_safe(group_exprs, aggs, filt):
        return None
    for d in descs:
        if not all(e.is_device_safe() for e in d.key_exprs):
            return None
    return PhysMeshLookupAgg(schema=agg.schema, children=[probe_reader],
                             lookups=descs, filter_expr=filt,
                             group_exprs=group_exprs, aggs=aggs,
                             num_group_cols=len(agg.group_exprs),
                             fallback=agg)


def _and(a, b):
    if a is None:
        return b
    return func(Op.AND, a, b)
