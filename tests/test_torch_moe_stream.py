"""K9's decode route ("stream", a weight stream) on the CPU.

The route's kernels (``csrc/moe_gmm.cu``, namespace st) run only on the
card.  What decides them and in what order they sum is checked here:

* ``moe_gmm.route`` gives "stream", "mma" and "wgmma" by dtype, tile
  height, D and F and alignment;
* the work list (``stream_work``, the plan the kernel derives on the card
  from ``tile_eid``) covers every column of every used tile once, gives a
  tile of id -1 no work, and cuts D into chunks taken in order; the split
  (``stream_splits``) on the Jamba cut's decode shapes;
* a plain-torch emulation of the route's summation order (per item, the
  k16 steps of its D chunk accumulated in f32; the chunks' f32 partials
  summed in chunk order; one rounding to bf16) on small decode layouts,
  spread over the experts and on one expert, against the reference's
  Pallas K9 in interpret mode (``repro.kernels.moe_gmm.moe_gmm``) within
  the bf16 limit, 1e-2 of max |out|.  The reference's kernel takes no -1
  tile: it runs with those tiles on expert 0, and their rows are then set
  to zero, as the port's contract defines them;
* a CPU call is the plain version and counts no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_gmm as jax_k9
from repro_torch.kernels import moe_gmm as k9

BF16_LIMIT = 1e-2
H100_SMS = 132


def _tw(t, d, f, e=4, dtype=torch.bfloat16, offset=None):
    def make(shape, off):
        n = int(np.prod(shape))
        if off:
            return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
        return torch.zeros(shape, dtype=dtype)
    return (make((t, d), offset == "tokens"),
            make((e, d, f), offset == "weights"))


# (tokens, weights) of each case, bm, and the route a CUDA call takes
ROUTE_CASES = {
    "bf16 bm 16, the cut's decode": (lambda: _tw(144, 8192, 24576 // 64), 16,
                                     "stream"),
    "bf16 bm 16, D and F tails": (lambda: _tw(144, 200, 136), 16, "stream"),
    "bf16 bm 32": (lambda: _tw(100, 64, 72), 32, "stream"),
    "bf16 bm 48": (lambda: _tw(100, 64, 72), 48, "stream"),
    "bf16 bm 64": (lambda: _tw(300, 256, 384), 64, "wgmma"),
    "bf16 bm 128": (lambda: _tw(300, 256, 384), 128, "wgmma"),
    "bf16 bm 80": (lambda: _tw(300, 256, 384), 80, "mma"),
    "f32 bm 16": (lambda: _tw(144, 256, 512, dtype=torch.float32), 16,
                  "mma"),
    "bf16 bm 16, D % 8 != 0": (lambda: _tw(144, 1003, 512), 16, "mma"),
    "bf16 bm 16, F % 8 != 0": (lambda: _tw(144, 1000, 517), 16, "mma"),
    "bf16 bm 16, offset tokens": (lambda: _tw(64, 128, 256, offset="tokens"),
                                  16, "mma"),
    "bf16 bm 16, offset weights": (lambda: _tw(64, 128, 256,
                                               offset="weights"), 16, "mma"),
    "bf16 bm 16, more tiles than a block lists": (
        lambda: _tw(16 * k9.STREAM_MAX_TILES + 1, 8, 8), 16, "mma"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_by_dtype_tile_height_shape_and_alignment(case):
    make, bm, want = ROUTE_CASES[case]
    tokens, weights = make()
    assert k9.route(tokens, weights, bm) == want


# -- the work list ---------------------------------------------------------

def _ids(case):
    """tile_eid of the decode layouts: batch 8, top-2 over 8 held experts
    gives 9 tiles of 16, the last past the rows used."""
    return {"spread": [0, 1, 2, 3, 4, 5, 6, 7, -1],
            "one expert": [3, -1, -1, -1, -1, -1, -1, -1, -1],
            "-1 between": [2, -1, 0, 5, -1, 1, 7, 7, -1],
            "none": [-1] * 9}[case]


@pytest.mark.parametrize("case", ["spread", "one expert", "-1 between",
                                  "none"])
@pytest.mark.parametrize("d,f", [(8192, 24576), (24576, 8192), (200, 136),
                                 (64, 8)])
@pytest.mark.parametrize("grid", [H100_SMS, 7])
def test_work_list_covers_every_used_column_once(case, d, f, grid):
    ids = _ids(case)
    s_max = k9.stream_max_splits(len(ids) * 16, f)
    work = k9.stream_work(ids, e=8, d=d, f=f, bm=16, grid=grid, s_max=s_max)
    assert len(work) == grid
    items = [it for block in work for it in block]
    used = [i for i, eid in enumerate(ids) if eid >= 0]
    assert {it[0] for it in items} == set(used)        # no work for -1 tiles
    splits, chunk = k9.stream_splits(len(used), -(-f // k9.STREAM_BN),
                                     -(-d // k9.STREAM_BK), grid, s_max, 16)
    assert 1 <= splits <= s_max
    for tile in used:
        cols = sorted({(it[1], it[2]) for it in items if it[0] == tile})
        assert [c for lo, hi in cols for c in range(lo, hi)] == list(range(f))
        for lo, hi in cols:
            chunks = sorted((it[3], it[4], it[5]) for it in items
                            if it[:3] == (tile, lo, hi))
            # D chunks j = 0 .. splits-1 in order, each D row once
            assert [j for j, _, _ in chunks] == list(range(splits))
            rows = [r for _, a, b in chunks for r in range(a, min(b, d))]
            assert rows == list(range(d))
    # rounds: blocks differ by at most one item
    sizes = [len(block) for block in work]
    assert max(sizes) - min(sizes) <= 1


def test_splits_on_the_cut_decode_shapes():
    """The Jamba cut at batch 8 (9 tiles of 16; H100, 132 SMs): the spread
    case streams each (tile, column box) whole in 6 (gate/up) or 2 (down)
    rounds; one expert, or 5 experts at the down shape, cut D, so every SM
    streams."""
    t = 144
    gate = dict(n_col=24576 // 256, k_steps=8192 // 64, grid=H100_SMS,
                s_max=k9.stream_max_splits(t, 24576), bm=16)
    down = dict(n_col=8192 // 256, k_steps=24576 // 64, grid=H100_SMS,
                s_max=k9.stream_max_splits(t, 8192), bm=16)
    assert (gate["s_max"], down["s_max"]) == (4, 8)
    assert k9.stream_splits(8, **gate) == (1, 128)
    assert k9.stream_splits(8, **down) == (1, 384)
    assert k9.stream_splits(1, **gate) == (4, 32)
    assert k9.stream_splits(5, **down) == (4, 96)
    assert k9.stream_splits(0, **gate) == (1, 128)
    for n_used in range(1, 9):
        for kw in (gate, down):
            splits, chunk = k9.stream_splits(n_used, **kw)
            items = n_used * kw["n_col"] * splits
            rounds = -(-items // H100_SMS)
            assert items / (rounds * H100_SMS) >= 0.7, (n_used, kw, splits)


# -- the summation order ---------------------------------------------------

def emulate(tokens, weights, ids, *, bm, grid):
    """The stream route's output on bf16 CPU tensors: each item's D chunk
    accumulated in f32 over k16 steps, the chunks of a (tile, column box)
    summed in chunk order in f32, rounded once to bf16; rows of a tile
    outside [0, E) zero."""
    t, d = tokens.shape
    e, _, f = weights.shape
    s_max = k9.stream_max_splits(t, f)
    out = torch.zeros((t, f), dtype=torch.float32)
    items = [it for block in k9.stream_work(ids, e=e, d=d, f=f, bm=bm,
                                             grid=grid, s_max=s_max)
             for it in block]
    partials = {}
    for tile, lo, hi, j, d0, d1 in items:
        rows = slice(tile * bm, min((tile + 1) * bm, t))
        acc = torch.zeros((rows.stop - rows.start, hi - lo))
        for k in range(d0, min(d1, d), 16):
            acc = acc + tokens[rows, k:k + 16].float() \
                @ weights[ids[tile], k:k + 16, lo:hi].float()
        partials[(tile, lo, j)] = (rows, hi, acc)
    for (tile, lo, j), (rows, hi, acc) in sorted(partials.items()):
        if j == 0:
            out[rows, lo:hi] = acc
        else:
            out[rows, lo:hi] = out[rows, lo:hi] + acc
    return out.to(torch.bfloat16)


def _reference(tokens, weights, ids, bm):
    """The reference's Pallas K9 in interpret mode, -1 tiles run on expert
    0 and then zeroed."""
    ref_ids = np.maximum(np.asarray(ids, np.int32), 0)
    out = np.array(jax_k9.moe_gmm(
        jnp.asarray(tokens.float().numpy(), jnp.bfloat16),
        jnp.asarray(weights.float().numpy(), jnp.bfloat16),
        jnp.asarray(ref_ids), bm=bm, bn=64, bk=64, interpret=True)
        .astype(jnp.float32))
    for i, eid in enumerate(ids):
        if eid < 0:
            out[i * bm:(i + 1) * bm] = 0
    return out


@pytest.mark.parametrize("case", ["spread", "one expert", "-1 between"])
def test_emulated_order_matches_the_reference_kernel(case):
    ids = _ids(case)
    bm, d, f, e = 16, 256, 512, 8
    rng = np.random.default_rng(len(case))
    tokens = torch.from_numpy(rng.standard_normal((len(ids) * bm, d),
                                                  np.float32)).bfloat16()
    weights = torch.from_numpy(rng.standard_normal((e, d, f), np.float32)
                               * d ** -0.5).bfloat16()
    # a grid of 4 blocks cuts D on the one-expert layout
    used = sum(i >= 0 for i in ids)
    splits, _ = k9.stream_splits(used, f // k9.STREAM_BN, d // k9.STREAM_BK,
                                 4, k9.stream_max_splits(len(ids) * bm, f),
                                 bm)
    assert (splits > 1) == (case == "one expert")
    out = emulate(tokens, weights, ids, bm=bm, grid=4)
    exp = _reference(tokens, weights, ids, bm)
    rel = float(np.abs(out.float().numpy() - exp).max() / np.abs(exp).max())
    print(f"{case}: {splits} D chunk(s), emulated order against the Pallas "
          f"K9: max_rel {rel:.3e} (limit {BF16_LIMIT})")
    assert rel <= BF16_LIMIT
    plain = k9.moe_gmm_plain(tokens, weights, torch.tensor(ids,
                                                           dtype=torch.int32),
                             bm=bm)
    assert float((out.float() - plain.float()).abs().max()
                 / plain.float().abs().max()) <= BF16_LIMIT
    for i, eid in enumerate(ids):
        if eid < 0:
            assert not out[i * bm:(i + 1) * bm].any()


def test_cpu_call_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.standard_normal((144, 64), np.float32)) \
        .bfloat16()
    weights = torch.from_numpy(rng.standard_normal((8, 64, 40), np.float32)) \
        .bfloat16()
    tile_eid = torch.tensor(_ids("-1 between"), dtype=torch.int32)
    assert k9.route(tokens, weights, 16) == "stream"
    k9.launches = k9.launches_wgmma = k9.launches_stream = 0
    out = k9.moe_gmm(tokens, weights, tile_eid, bm=16)
    assert (k9.launches, k9.launches_wgmma, k9.launches_stream) == (0, 0, 0)
    assert torch.equal(out, k9.moe_gmm_plain(tokens, weights, tile_eid,
                                             bm=16))
