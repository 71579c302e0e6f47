"""Logical-axis partitioning (MaxText-style rules), the port's copy of the
parameter half of ``repro/nn/partitioning.py``.

Every parameter leaf carries a tuple of logical axis names (each module's
``specs(cfg)``, ``nn/transformer.param_specs``); a *rules* dict maps
logical names to physical mesh axes.  ``to_shardings`` sanitizes the
result per leaf: a mesh axis is dropped when the dim is not divisible by
its size, and duplicate mesh axes keep their first (highest-priority)
occurrence — so one rule table serves every arch and every mesh shape,
with graceful per-tensor fallback to a whole (replicated) leaf.

A mesh here is anything whose ``.shape`` maps axis names to sizes, or a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names`` and
``shape``; ``launch/mesh.make_host_mesh``).  A placement is what the
reference's ``PartitionSpec`` holds: per dim, None, a mesh axis, or a
tuple of mesh axes.  ``train/fsdp.py`` stores and gathers leaves by the
placements over "data".

The reference's activation half (``activation_rules``, ``activation_ctx``,
``constrain``) and ``cache_shardings`` belong to tensor parallelism over
"model", which the port does not run yet.
"""
from __future__ import annotations


def mesh_shape(mesh) -> dict:
    """{axis name: size} of ``mesh``: a DeviceMesh's named dims, or its
    ``.shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def sanitize_spec(axes, shape, mesh):
    """Drop non-dividing / duplicate mesh axes; returns a valid placement
    tuple (``partitioning.py:30-56``)."""
    sizes = mesh_shape(mesh)
    used = set()
    out = []
    for dim, axis in zip(shape, axes):
        if axis is None:
            out.append(None)
            continue
        flat = axis if isinstance(axis, (tuple, list)) else (axis,)
        kept = []
        size = 1
        for a in flat:
            if a in used:
                continue
            s = sizes[a]
            if dim % (size * s) == 0:
                kept.append(a)
                size *= s
        for a in kept:
            used.add(a)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def spec_for(logical_axes, shape, rules: dict, mesh) -> tuple:
    """The placement of one leaf of ``shape`` whose dims carry
    ``logical_axes`` under ``rules`` (``partitioning.py:59-63``)."""
    axes = [rules.get(a) for a in logical_axes]
    # pad in case the logical tuple is shorter than the rank
    axes = list(axes) + [None] * (len(shape) - len(axes))
    return sanitize_spec(axes[:len(shape)], shape, mesh)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def to_shardings(spec_tree, shape_tree, rules: dict, mesh):
    """specs (tuples of logical names) x shapes (tensors, or anything with
    a ``.shape``) -> the placement tree (``partitioning.py:66-72``)."""
    if _is_spec(spec_tree):
        return spec_for(spec_tree, tuple(shape_tree.shape), rules, mesh)
    return {key: to_shardings(v, shape_tree[key], rules, mesh)
            for key, v in spec_tree.items()}


def param_rules(*, fsdp: bool, mesh, profile: str = "tp") -> dict:
    """Weight placement: tensor-parallel over "model"; optionally
    ZeRO-3/FSDP over "data" (+"pod" when present) on the embed dim
    (``partitioning.py:140-164``).  Profiles: "tp" (default), "ddp" (ZeRO-3
    storage over every axis, no tensor parallelism), "ep" (experts on
    "model")."""
    data_axes = ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
    if profile == "ddp":
        return {"embed": data_axes + ("model",), "heads": None,
                "kv_heads": None, "mlp": None, "inner": None,
                "expert": None, "vocab": None, "layers": None, None: None}
    if profile == "ep":
        return {"embed": data_axes if fsdp else None, "heads": None,
                "kv_heads": None, "mlp": None, "inner": None,
                "expert": "model", "vocab": None, "layers": None,
                None: None}
    fs = data_axes if fsdp else None
    return {
        "embed": fs,
        "heads": "model", "kv_heads": "model",
        "mlp": "model", "inner": "model",
        "expert": "model",
        "vocab": "model",
        "layers": None,
        None: None,
    }


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def batch_spec(global_batch: int, mesh, trailing=(None,)) -> tuple:
    """Place the batch dim over (pod, data); fall back to a whole batch
    when it is too small (``partitioning.py:171-185``)."""
    sizes = mesh_shape(mesh)
    size = 1
    kept = []
    for a in batch_axes(mesh):
        s = sizes[a]
        if global_batch % (size * s) == 0:
            kept.append(a)
            size *= s
    lead = tuple(kept) if kept else None
    if isinstance(lead, tuple) and len(lead) == 1:
        lead = lead[0]
    return (lead, *trailing)
