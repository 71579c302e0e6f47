"""Execution Task Graph construction — the GxM flow of paper Fig. 3.

The port's copy of ``repro/graph/etg.py``.

Parser -> NL  (topology.py builders)
NL Extender   -> adds Split nodes for multi-consumer tensors
Fusion pass   -> conv-epilogue fusion (core.fusion)
Dedupe        -> structurally identical conv shapes share one "kernel
                 generator" entry (the paper's JIT cache)
ETG           -> topologically ordered task list the executor runs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.fusion import (Node, detect_chains, fuse_network,
                                     fusion_stats)


@dataclasses.dataclass
class ETG:
    tasks: list            # topo-ordered Nodes
    kernel_cache: dict     # conv signature -> cache id (dedup'd JIT entries)
    stats: dict
    chains: list = dataclasses.field(default_factory=list)  # fusion.Chain


def extend_nl(nodes: list[Node]) -> list[Node]:
    """NL Extender: insert explicit Split nodes where a tensor feeds >1
    consumer (fwd: fan-out copy; bwd: gradient sum).

    Pure: consumer rewiring happens on copies, never on the caller's nodes,
    and the users index is built once up front."""
    nodes = [dataclasses.replace(n, inputs=list(n.inputs)) for n in nodes]
    users_of: dict[str, list[Node]] = {}
    for m in nodes:
        for i in set(m.inputs):
            users_of.setdefault(i, []).append(m)
    out = []
    for n in nodes:
        out.append(n)
        users = users_of.get(n.name, [])
        if len(users) > 1 and n.op not in ("input",):
            split = Node(f"{n.name}_split", "split", [n.name],
                         dict(fanout=len(users)))
            out.append(split)
            for u in users:
                u.inputs = [f"{n.name}_split" if i == n.name else i
                            for i in u.inputs]
    return out


def toposort(nodes: list[Node]) -> list[Node]:
    by_name = {n.name: n for n in nodes}
    alias = {}
    for n in nodes:
        if "output_name" in n.attrs:
            alias[n.attrs["output_name"]] = n.name
    resolved = lambda i: alias.get(i, i)  # noqa: E731
    done, order, visiting = set(), [], set()

    def visit(n):
        if n.name in done:
            return
        if n.name in visiting:
            raise ValueError(f"cycle at {n.name}")
        visiting.add(n.name)
        for i in n.inputs:
            i = resolved(i)
            if i in by_name:
                visit(by_name[i])
        visiting.discard(n.name)
        done.add(n.name)
        order.append(n)

    for n in nodes:
        visit(n)
    return order


def conv_signature(n: Node) -> tuple:
    a = n.attrs
    fused_kinds = tuple(k for k, _ in n.fused)
    return (a["c"], a["k"], a["r"], a["s"], a["stride"], a["padding"],
            fused_kinds, a.get("kernel_kind", "f32"))


def _assign_kernel_ids(tasks: list[Node]) -> dict[tuple, int]:
    # Dedupe: one JIT "code generator" entry per distinct conv signature —
    # the paper's answer to combinatorial kernel explosion.
    cache: dict[tuple, int] = {}
    for t in tasks:
        if t.op == "conv":
            sig = conv_signature(t)
            cache.setdefault(sig, len(cache))
            t.attrs["kernel_id"] = cache[sig]
    return cache


def quantize_etg(etg: ETG) -> ETG:
    """Mark every conv task for the §II-K int8 kernel path and rebuild the
    dedup cache (q8 signatures are distinct code-generator entries).  The
    executor dispatches a task to ``conv2d_q8_fwd`` when its params carry
    quantized leaves (``core.quantize.quantize_gxm_params``); a q8-marked
    ETG with f32 params still runs the f32 path, which is what calibration
    relies on."""
    for t in etg.tasks:
        if t.op == "conv":
            t.attrs["kernel_kind"] = "q8"
    etg.kernel_cache = _assign_kernel_ids(etg.tasks)
    return etg


def build_etg(nl: list[Node], *, fuse: bool = True,
              quantized: bool = False) -> ETG:
    enl = extend_nl([dataclasses.replace(n, inputs=list(n.inputs),
                                         attrs=dict(n.attrs),
                                         fused=list(n.fused))
                     for n in nl])
    fused = fuse_network(enl) if fuse else enl
    tasks = toposort(fused)
    cache = _assign_kernel_ids(tasks)
    # depth-first conv->conv chains (DESIGN.md §16): metadata only here
    chains = detect_chains(tasks) if fuse else []
    by_name = {t.name: t for t in tasks}
    for ci, ch in enumerate(chains):
        for pos, name in enumerate(ch.names):
            by_name[name].attrs["chain_id"] = ci
            by_name[name].attrs["chain_pos"] = pos
    stats = fusion_stats(enl, fused)
    stats["chains"] = len(chains)
    stats["chained_convs"] = sum(len(c) for c in chains)
    etg = ETG(tasks=tasks, kernel_cache=cache, stats=stats, chains=chains)
    return quantize_etg(etg) if quantized else etg
