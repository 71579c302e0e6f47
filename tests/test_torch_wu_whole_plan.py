"""K10b's split of the whole-plane sweep (``kernels/conv2d_wu.plan_whole``)
on the CPU.

The reference's whole-plane update pass walks the (n, p_b) steps of b_p
rows in order on one core (``repro/kernels/conv2d_wu.py:_conv2d_wu_whole``).
The port's kernel cuts that sequence into runs of whole steps, one block
per (tile, run), and sums the runs' partial tiles in a second pass:

* for every ResNet-50 weight-update signature at batch 32, under the
  reference's whole blocking (``core.conv.whole_blocking``, which
  ``test_torch_whole_plane.py`` holds against the reference), the runs
  cover each step once, in order, on step boundaries, with splits x R x S
  within the grid's z limit;
* every such grid has at least 132 blocks (an H100's SMs) wherever
  tiles x N*P_b allows it, where one block per tile left 1 on the 56x56
  1x1 64->64 layer;
* a plain-torch emulation of the kernel's order (each run folds its steps
  into a partial tile, the partials are summed in split order) equals
  ``conv2d_wu_whole_plain`` within 1e-6 of max |plain| on reduced
  ResNet-50's signatures, and the reference's whole-plane Pallas kernel
  in interpret mode within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_wu import conv2d_wu as jax_conv2d_wu
from repro_torch.core import conv
from repro_torch.graph import build_etg, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels.conv2d_direct import pad_input

H100_SMS = 132
BATCH = 32


def _signatures(topology, image, batch):
    """Distinct lane-aligned weight-update signatures of ``topology`` at
    ``image`` x ``image``, each with the reference's whole blocking."""
    out = {}
    for sh in conv_shapes(build_etg(topology), (image, image)):
        if not conv.lane_ok(sh["c"], sh["k"]):
            continue
        key = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"])
        if key in out:
            continue
        h, w, c, k, r, s, st, pad = key
        blk = conv.whole_blocking((batch, h, w, c), (r, s, c, k), stride=st,
                                  padding=pad, kind="wu")
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1
        out[key] = dict(n=batch, p=p, q=q, c=c, k=k, r=r, s=s, b_p=blk.rb_p,
                        k_blk=blk.k_blk)
    return out


RESNET50 = _signatures(resnet50(), 224, BATCH)
REDUCED = _signatures(resnet50(10, stages=(1, 1, 1, 1)), 32, 8)


def _runs(plan, steps):
    return [list(range(i * plan.run, min((i + 1) * plan.run, steps)))
            for i in range(plan.splits)]


def test_resnet50_has_the_22_weight_update_signatures():
    assert len(RESNET50) == 22


@pytest.mark.parametrize("key", list(RESNET50))
def test_plan_whole_cuts_the_steps_into_whole_runs(key):
    g = RESNET50[key]
    plan = k2.plan_whole(**g)
    steps = g["n"] * (g["p"] // g["b_p"])
    runs = _runs(plan, steps)
    assert [t for run in runs for t in run] == list(range(steps))
    assert all(runs), "an empty run"
    assert plan.splits * g["r"] * g["s"] <= k2.MAX_GRID_Z
    assert plan.pixels == plan.run * g["b_p"] * g["q"]
    assert plan.tile == k2.whole_tile(g["c"], g["k_blk"])


@pytest.mark.parametrize("key", list(RESNET50))
def test_plan_whole_fills_the_card(key):
    g = RESNET50[key]
    plan = k2.plan_whole(**g)
    tiles = -(-g["c"] // k2.WHOLE_TILES[plan.tile][0]) \
        * (g["k"] // g["k_blk"]) * g["r"] * g["s"]
    steps = g["n"] * (g["p"] // g["b_p"])
    assert plan.blocks == tiles * plan.splits
    if tiles * steps >= H100_SMS:
        assert plan.blocks >= H100_SMS, plan
    assert plan.blocks <= 2 * k2.TARGET_BLOCKS or plan.splits == 1


def test_plan_whole_on_the_56x56_1x1_64_to_64_layer():
    """One tile and 448 steps of 224 pixels: today's grid of 1 block
    becomes 224 runs of 2 steps."""
    plan = k2.plan_whole(**RESNET50[(56, 56, 64, 64, 1, 1, 1, 0)])
    assert (plan.splits, plan.run, plan.pixels, plan.blocks) == \
        (224, 2, 448, 224)


def test_plan_whole_keeps_the_reference_contract():
    g = dict(RESNET50[(56, 56, 64, 64, 1, 1, 1, 0)])
    with pytest.raises(ValueError, match="does not divide P"):
        k2.plan_whole(**{**g, "b_p": 5})
    with pytest.raises(ValueError, match="does not divide K"):
        k2.plan_whole(**{**g, "k_blk": 48})
    with pytest.raises(ValueError, match="empty"):
        k2.plan_whole(**{**g, "n": 0})


def _split_then_sum(x, do, *, stride, padding, r, s, b_p, k_blk):
    """The kernel's order in plain torch: each run of ``plan_whole`` folds
    its steps' (pixels, C)^T x (pixels, K) products into a partial tile,
    and the partials are summed in split order."""
    n, h, w, c = x.shape
    _, p, q, k = do.shape
    plan = k2.plan_whole(n=n, p=p, q=q, c=c, k=k, r=r, s=s, b_p=b_p,
                         k_blk=k_blk)
    xp = pad_input(x, padding=padding, stride=stride, rb_p=b_p, r=r, p=p)
    p_b = p // b_p
    partials = []
    for run in _runs(plan, n * p_b):
        part = torch.zeros((r, s, c, k), dtype=torch.float32)
        for t in run:
            nn, pb = divmod(t, p_b)
            g = do[nn, pb * b_p:(pb + 1) * b_p].reshape(b_p * q, k)
            row0 = pb * b_p * stride
            for rr in range(r):
                for ss in range(s):
                    xs = xp[nn, row0 + rr:row0 + rr + (b_p - 1) * stride + 1:
                            stride, ss:ss + (q - 1) * stride + 1:stride, :]
                    part[rr, ss] += xs.reshape(b_p * q, c).t() @ g
        partials.append(part)
    dw = partials[0].clone()
    for part in partials[1:]:
        dw += part
    return dw, plan


@pytest.mark.parametrize("key", list(REDUCED))
def test_split_then_sum_equals_the_whole_plane_plain_version(key):
    h, w, c, k, r, s, st, pad = key
    g = REDUCED[key]
    rng = np.random.default_rng(h * 1000 + c + k + r)
    x = rng.standard_normal((g["n"], h, w, c)).astype(np.float32)
    do = rng.standard_normal((g["n"], g["p"], g["q"], k)).astype(np.float32)
    kw = dict(stride=st, padding=pad, b_p=g["b_p"], k_blk=g["k_blk"])
    got, plan = _split_then_sum(torch.from_numpy(x), torch.from_numpy(do),
                                r=r, s=s, **kw)
    plain = k2.conv2d_wu_whole_plain(torch.from_numpy(x),
                                     torch.from_numpy(do), filter_rs=(r, s),
                                     **kw)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-6 * scale, plan
    exp = np.asarray(jax_conv2d_wu(jnp.asarray(x), jnp.asarray(do),
                                   filter_rs=(r, s), whole_plane=True,
                                   interpret=True, **kw))
    assert float(np.abs(got.numpy() - exp).max()) <= \
        1e-5 * float(np.abs(exp).max())


def test_reduced_resnet50_signatures_split():
    """The emulation above meets more than one run on every reduced
    signature at batch 8, and runs of more than one step on some."""
    plans = [k2.plan_whole(**g) for g in REDUCED.values()]
    assert len(REDUCED) >= 10
    assert all(pl.splits > 1 for pl in plans), plans
    assert any(pl.run > 1 for pl in plans), plans
