"""K8's tile route on the CPU: its plan, its route, and its arithmetic
against the JAX package.

The tile kernel itself runs only on the card (``tests/test_torch_cuda.py``,
marker ``gpu``).  Here:

* ``tile_plan`` at the Mamba mixer's shapes and a spread of small ones: the
  blocks cover every (b, l, d) once, each block reads its run and the
  KW - 1 rows before it, and the halo is at most 1/16 of the rows a block
  reads;
* ``route`` by dtype, D, strides and alignment;
* an emulation of the route's arithmetic in plain torch (f32 sums in the
  kernel's order, then SiLU as x * (1 / (1 + exp(-x))), the kernel's
  __expf and rcp.approx taken as exact) against the Pallas K8 in
  interpret mode (``repro/kernels/conv1d_causal.py``, which runs here):
  max |diff| / max |ref| <= 1e-5 in f32 and <= 1e-2 in bf16, the limits
  the card holds the kernel to against its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv1d_causal as jax_k8
from repro_torch.convert import to_tensor
from repro_torch.kernels import conv1d_causal as k8
from repro_torch.launch import roofline

# b, l, d, kw: the cut's Mamba shapes (d_inner 16384; L 1, 333, 1024 at
# batch 1, 512 at batch 8), then tails of L and D and every tap count
PLAN_CASES = [(1, 1, 16384, 4), (1, 333, 16384, 4), (1, 1024, 16384, 4),
              (8, 512, 16384, 4), (2, 77, 1000, 4), (3, 5, 24, 2),
              (1, 64, 8, 8), (2, 17, 256, 1), (4, 130, 136, 5),
              (1, 200, 4096, 3)]


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("vec", [4, 8])
def test_tile_plan_covers_each_output_once_with_its_halo(case, vec):
    b, l, d, kw = case
    assert d % vec == 0
    plan = k8.tile_plan(b, l, d, kw, vec)
    width = plan.threads * vec
    blocks_d, runs = -(-d // width), -(-l // plan.run)
    assert plan.blocks == blocks_d * runs * b
    assert plan.threads in k8.TILE_THREADS
    assert plan.smem == plan.stages * plan.rows * plan.threads * 16
    assert plan.run % plan.rows == 0
    # the grid is (blocks_d, runs, b): a block's outputs are its run's rows
    # by its channels, so each (b, l, d) is written once when the runs
    # partition L and the channel ranges partition D
    rows = np.zeros(l, np.int32)
    for ly in range(runs):
        l0, l1 = ly * plan.run, min((ly + 1) * plan.run, l)
        rows[l0:l1] += 1
        # the rows a block reads: the KW - 1 before its run (zero before
        # token 0), then the run
        read = np.arange(l0 - (kw - 1), l1)
        assert len(read) == l1 - l0 + kw - 1 and read[-1] == l1 - 1
    chans = np.zeros(blocks_d * width, np.int32)
    for dx in range(blocks_d):
        chans[dx * width:(dx + 1) * width] += 1
    assert (rows == 1).all() and (chans[:d] == 1).all()
    assert blocks_d * width - d < width
    # the halo: at most 1/16 of the rows a whole run reads
    assert (kw - 1) / (plan.run + kw - 1) <= k8.TILE_HALO_SHARE
    if plan.threads != k8.TILE_THREADS[-1]:
        assert plan.blocks >= k8.TILE_BLOCKS_PER_SM * roofline.SMS


def test_tile_plan_at_the_served_shapes():
    assert k8.tile_plan(1, 1024, 16384, 4, 8) == k8.TilePlan(
        threads=128, run=48, rows=8, stages=3, smem=49152, blocks=352)
    assert k8.tile_plan(1, 333, 16384, 4, 8).threads == 32
    assert k8.tile_plan(8, 512, 16384, 4, 8).blocks == 1408


def _x(b, l, d, dtype, *, offset=0, row=None):
    row = d if row is None else row
    base = torch.zeros(b * l * row + offset, dtype=dtype)
    return base[offset:].view(b, l, row)[..., :d]


def test_route_by_dtype_width_strides_and_alignment():
    w = torch.zeros((4, 16), dtype=torch.bfloat16)
    assert k8.route(_x(1, 8, 16, torch.bfloat16), w) == "tile"
    assert k8.route(_x(1, 8, 16, torch.float32),
                    w.float(), torch.zeros(16)) == "tile"
    # the mixer's half of its projection: rows 2 D apart
    assert k8.route(_x(2, 8, 16, torch.bfloat16, row=32), w) == "tile"
    assert k8.route(_x(1, 8, 12, torch.bfloat16), w[:, :12]) == "thread"
    assert k8.route(_x(1, 8, 12, torch.float32), w[:, :12].float()) \
        == "tile"
    assert k8.route(_x(1, 8, 16, torch.bfloat16, row=20), w) == "thread"
    assert k8.route(_x(1, 8, 16, torch.bfloat16, offset=1), w) == "thread"
    assert k8.route(_x(1, 8, 16, torch.float16), w.half()) == "thread"
    odd = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)[1:].view(4, 16)
    assert k8.route(_x(1, 8, 16, torch.bfloat16), odd) == "thread"
    assert k8.route(_x(1, 8, 16, torch.bfloat16), w,
                    torch.zeros(17, dtype=torch.bfloat16)[1:]) == "thread"


def _tile_emulation(x, w, bias, act):
    """The tile kernel's arithmetic in plain torch: each output the f32 sum
    of its KW products in tap order, then the bias, then SiLU as x times
    the reciprocal of 1 + exp(-x), rounded to x's dtype once."""
    b, l, d = x.shape
    kw = w.shape[0]
    xf = torch.nn.functional.pad(x.float(), (0, 0, kw - 1, 0))
    wf = w.float()
    acc = torch.zeros((b, l, d), dtype=torch.float32)
    for i in range(kw):
        acc = acc + xf[:, i:i + l] * wf[i]
    acc = acc + bias.float()
    if act == "silu":
        acc = acc * torch.reciprocal(1.0 + torch.exp(-acc))
    return acc.to(x.dtype)


@pytest.mark.parametrize("case", [(1, 17, 24, 4), (2, 64, 128, 4),
                                  (1, 33, 256, 2), (2, 9, 8, 7)])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_arithmetic_matches_the_pallas_kernel(case, act, dtype):
    b, l, d, kw = case
    rng = np.random.default_rng(l * d + kw)
    x = rng.standard_normal((b, l, d)).astype(np.float32) * 3
    w = (rng.standard_normal((kw, d)) * kw ** -0.5).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a, dtype) for a in (x, w, bias))
    exp = np.asarray(jax_k8.conv1d_causal(jx, jw, bias=jb, act=act,
                                          d_blk=min(d, 128), interpret=True),
                     np.float32)
    tx, tw, tb = (to_tensor(np.asarray(a), "cpu") for a in (jx, jw, jb))
    assert k8.route(tx, tw, tb) == "tile"
    out = _tile_emulation(tx, tw, tb, act).float().numpy()
    rel = float(np.abs(out - exp).max() / np.abs(exp).max())
    assert rel <= (1e-5 if dtype == "float32" else 1e-2)
