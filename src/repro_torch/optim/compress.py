"""Error-feedback int8 gradient compression for the data-parallel
reduction, the port's copy of ``repro/optim/compress.py``.

Per-tensor symmetric quantization with a residual ("error feedback")
accumulator: the quantization error of step t is added back to the
gradient of step t+1, which keeps convergence (the 1-bit Adam / EF-SGD
lineage); the counterpart, on the wire, of the paper's §II-K reduced
precision.

``compressed_psum(g, group, residual)`` takes the reference's steps
(``repro/optim/compress.py:69-83``) over a ``torch.distributed`` group in
place of a mesh axis: an all-reduce MAX of the local scales, so every rank
quantizes against one common scale; the codes; an all-reduce SUM of the
codes as int32; dequantize and divide by the group's size.  The codes
cross the wire as int32, as in the reference, so the wire carries as many
bytes as an f32 reduction, not the quarter the reference's docstring
claims: a sum of int8 codes over the group would overflow int8.
``wire_bytes`` counts the bytes one reduction moves.

``compressed_psum_tree`` reduces a whole gradient tree in two collectives
(one MAX over the stacked scales, one SUM over the concatenated codes).
MAX and integer SUM do not depend on order, so each leaf's result equals
``compressed_psum``'s on that leaf bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_axis_size, require_group
from repro_torch.optim.adamw import tree_leaves, tree_map

# bytes the last compressed_psum / compressed_psum_tree sent into its
# collectives on this rank (the scales and the int32 codes)
last_wire_bytes = 0


def _scale(g32):
    return g32.abs().max() / 127.0 + 1e-12


def _quantize(g32, scale):
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def compress_int8(g, residual=None):
    """-> (q int8, scale f32 0-d, new_residual f32): ``g`` (+ the
    residual) quantized against its own max / 127 + 1e-12."""
    g32 = g.to(torch.float32)
    if residual is not None:
        g32 = g32 + residual
    scale = _scale(g32)
    q = _quantize(g32, scale)
    return q, scale, g32 - q.to(torch.float32) * scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.to(torch.float32) * scale).to(dtype)


def wire_bytes(grads) -> int:
    """Bytes one compressed reduction of ``grads`` sends into its
    collectives: a 4-byte scale and 4 bytes of int32 code an element, per
    leaf."""
    return sum(4 + 4 * g.numel() for g in tree_leaves(grads))


def compressed_psum(g, group=None, residual=None):
    """Quantize -> all-reduce SUM (int32) -> dequantize, with error
    feedback: returns (the group's mean gradient in ``g``'s dtype, this
    rank's new residual).  Every rank quantizes against the group's MAX of
    the local scales, or the int32 sum would mix units."""
    global last_wire_bytes
    group = require_group(group)
    g32 = g.to(torch.float32)
    if residual is not None:
        g32 = g32 + residual
    scale = _scale(g32)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _quantize(g32, scale)
    new_res = g32 - q.to(torch.float32) * scale
    acc = q.to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    last_wire_bytes = 4 + 4 * acc.numel()
    n = float(data_axis_size(group))
    return (acc.to(torch.float32) * scale / n).to(g.dtype), new_res


def compressed_psum_tree(grads, group, residuals):
    """Leaf by leaf ``compressed_psum`` over a gradient tree (nested dicts
    of tensors), in two collectives: returns (the mean gradient tree, the
    new residual tree).  This is the reduction the data-parallel CNN step
    puts between the weight-update pass and the optimizer under
    ``REPRO_GRAD_COMPRESS=int8`` (``train.distributed``)."""
    global last_wire_bytes
    group = require_group(group)
    gs = tree_leaves(grads)
    rs = tree_leaves(residuals)
    g32s = [g.to(torch.float32) + r for g, r in zip(gs, rs)]
    scales = torch.stack([_scale(g32) for g32 in g32s])
    dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    qs = [_quantize(g32, scales[i]) for i, g32 in enumerate(g32s)]
    new_rs = [g32 - q.to(torch.float32) * scales[i]
              for i, (g32, q) in enumerate(zip(g32s, qs))]
    acc = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    last_wire_bytes = scales.numel() * 4 + acc.numel() * 4
    n = float(data_axis_size(group))
    outs, at = [], 0
    for i, g in enumerate(gs):
        part = acc[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
        outs.append((part.to(torch.float32) * scales[i] / n).to(g.dtype))
    it_g, it_r = iter(outs), iter(new_rs)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_r), grads))


def fold_residual(residual, new_shards: int):
    """Re-shard an error-feedback residual tree onto a narrower data
    group.  Each leaf carries a leading ``(n_shards,)`` axis, one
    accumulator a shard.  Elastic re-scale must keep the total gradient
    mass that was not yet applied: groups of old shards are summed into
    each new shard where the old width divides by the new, else everything
    is summed into shard 0 and the rest are zero."""
    def fold(r):
        old = r.shape[0]
        if old == new_shards:
            return r
        if old % new_shards == 0:
            return r.reshape(new_shards, old // new_shards,
                             *r.shape[1:]).sum(dim=1)
        total = r.sum(dim=0, keepdim=True)
        pad = torch.zeros((new_shards - 1, *r.shape[1:]), dtype=r.dtype,
                          device=r.device)
        return torch.cat([total, pad], dim=0)
    return tree_map(fold, residual)
