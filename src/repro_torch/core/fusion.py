"""Layer-fusion pattern matching (paper §II-G/§II-H locality, GxM graph pass).

The port's copy of ``repro/core/fusion.py``, kept line for line so the two
ETGs agree.  Two levels of fusion live here:

  * ``fuse_network`` — the §II-G rule: collapse bandwidth-bound L()
    operators (BatchNorm-apply, bias, eltwise-add, ReLU) into the producing
    convolution's fused epilogue whenever the intermediate tensor has a
    single consumer — "apply L() while the sub-tensor is hot in cache".
  * ``detect_chains`` — one level up (DESIGN.md §16): group single-consumer
    conv->conv edges of the *fused* graph into depth-first ``Chain``s, so an
    executor can compute layer l+1's output band from layer l's band while
    it is still on chip and the intermediate activation never round-trips
    device memory.  The port's executor does not run chains yet: they are
    metadata.  The per-layer halo algebra ((r-1)·stride growth, the exact
    ``rows_in = (rows_out-1)·stride + r`` recurrence) lives here too.

Both passes build a users index once (``users_index``) instead of rescanning
the whole node list per node.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Node:
    name: str
    op: str                 # conv / bn / relu / add / pool / fc / ...
    inputs: list
    attrs: dict
    fused: list = dataclasses.field(default_factory=list)  # fused L() ops


def users_index(nodes) -> dict[str, list[Node]]:
    """tensor name -> consumer nodes, built in one O(edges) scan.  A node
    listing the same tensor twice (e.g. self-residual) appears twice —
    callers that need fan-*out* semantics de-duplicate, callers that need
    "is this edge exclusive" semantics must not."""
    users: dict[str, list[Node]] = {}
    for n in nodes:
        for i in n.inputs:
            users.setdefault(i, []).append(n)
    return users


def consumers(nodes, name, index: dict | None = None):
    """Consumers of tensor `name` (de-duplicated).  Pass a prebuilt
    ``users_index`` when calling in a loop — the fallback scan is O(n) per
    call and exists only for one-off queries."""
    if index is None:
        return [n for n in nodes if name in n.inputs]
    seen, out = set(), []
    for n in index.get(name, ()):
        if id(n) not in seen:
            seen.add(id(n))
            out.append(n)
    return out


FUSABLE = ("bn", "bias", "relu", "add")


def fuse_network(nodes: list[Node]) -> list[Node]:
    """Greedy single-consumer chain fusion into conv epilogues.

    conv -> bn -> relu                  => conv{bn,relu}
    conv -> bn -> add(skip) -> relu     => conv{bn,residual,relu}
    conv -> bias -> relu                => conv{bias,relu}

    Pure (operates on copies) and idempotent: re-running on an already-fused
    list is a no-op, because every fusable L() node has been folded away and
    the remaining edges are conv->conv / multi-consumer.
    """
    nodes = [dataclasses.replace(n, fused=list(n.fused),
                                 inputs=list(n.inputs), attrs=dict(n.attrs))
             for n in nodes]
    users = users_index(nodes)
    dead: set[str] = set()

    for n in nodes:
        if n.op != "conv":
            continue
        cur = n
        while True:
            outs = [c for c in users.get(cur.name, ())
                    if c.name not in dead]
            if len(outs) != 1:
                break
            nxt = outs[0]
            if nxt.op not in FUSABLE:
                break
            if nxt.op == "add":
                if any(f[0] == "add" for f in n.fused):
                    break  # one residual input per epilogue
                other = [i for i in nxt.inputs if i != cur.name]
                if len(other) != 1:
                    break
                n.fused.append(("add", {"residual": other[0]}))
                n.inputs.append(other[0])   # dependency for topo ordering
                users.setdefault(other[0], []).append(n)
            else:
                n.fused.append((nxt.op, dict(nxt.attrs)))
            dead.add(nxt.name)
            # the fused conv now produces the fused chain's output name
            n.attrs["output_name"] = nxt.name
            cur = nxt

    out = []
    owner_of = {n.attrs["output_name"]: n.name for n in nodes
                if "output_name" in n.attrs and n.name not in dead}
    for n in nodes:
        if n.name in dead:
            continue
        # rewire inputs that pointed at fused-away nodes
        n.inputs = [owner_of.get(i, i) for i in n.inputs]
        out.append(n)
    return out


# -- depth-first conv->conv chains (DESIGN.md §16) ---------------------------


@dataclasses.dataclass(frozen=True)
class Chain:
    """A maximal single-consumer conv->conv chain of the fused graph.

    ``names`` orders producers before consumers; ``rs`` carries each layer's
    (r, stride, padding) for the halo algebra; ``halo_growth`` is the
    per-layer band-halo growth (r-1)·stride the ROADMAP quotes — the extra
    input rows (in that layer's input units) a consumer band drags in beyond
    its stride-scaled footprint.
    """
    names: tuple
    rs: tuple               # per-layer (r, stride, padding)
    halo_growth: tuple      # per-layer (r - 1) * stride

    def __len__(self):
        return len(self.names)


def chain_band_rows(rs, rows_out: int) -> list[int]:
    """The exact halo recurrence: rows of every layer's *input* band needed
    to produce ``rows_out`` rows of the final layer's output.

    Returns ``rows`` of length L+1 with ``rows[l]`` = input rows of layer l
    (l = 0..L-1, un-clipped — plane edges clip in the executor) and
    ``rows[L] = rows_out``; each step applies
    ``rows_in = (rows_out - 1)·stride + r``.
    """
    rows = [rows_out]
    for r, stride, _pad in reversed(tuple(rs)):
        rows.append((rows[-1] - 1) * stride + r)
    return list(reversed(rows))


def detect_chains(nodes: list[Node], *, min_len: int = 2) -> list[Chain]:
    """Group fusable conv->conv edges of a *fused* node list into maximal
    depth-first chains.

    An edge producer->consumer is chain-fusable iff the consumer is a conv
    whose *data* input (``inputs[0]``) is the producer's output and the
    producer's output has exactly one use in the whole graph (a residual
    reference counts as a use: fusing across it would need the intermediate
    in HBM anyway).  Chains never overlap; detection is pure metadata — the
    node list is not rewritten, so the pass is trivially idempotent and
    topology-preserving.
    """
    users = users_index(nodes)
    in_chain: set[str] = set()
    chains: list[Chain] = []

    def next_link(cur: Node) -> Node | None:
        uses = users.get(cur.name, ())
        if len(uses) != 1:
            return None
        nxt = uses[0]
        if nxt.op != "conv" or nxt.name in in_chain:
            return None
        if not nxt.inputs or nxt.inputs[0] != cur.name:
            return None         # feeds the residual slot, not the data slot
        return nxt

    for n in nodes:
        if n.op != "conv" or n.name in in_chain:
            continue
        members = [n]
        cur = n
        while True:
            nxt = next_link(cur)
            if nxt is None:
                break
            members.append(nxt)
            cur = nxt
        if len(members) < min_len:
            continue
        for m in members:
            in_chain.add(m.name)
        rs = tuple((m.attrs["r"], m.attrs["stride"], m.attrs["padding"])
                   for m in members)
        chains.append(Chain(
            names=tuple(m.name for m in members),
            rs=rs,
            halo_growth=tuple((r - 1) * s for r, s, _ in rs)))
    return chains


def fusion_stats(nl_before: list[Node], nl_after: list[Node]) -> dict:
    return {
        "nodes_before": len(nl_before),
        "nodes_after": len(nl_after),
        "ops_fused": len(nl_before) - len(nl_after),
    }
