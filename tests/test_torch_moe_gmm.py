"""K9's slice on the CPU against the JAX package, on the same numpy inputs:
``route_dryrun`` bit for bit, K9's plain version (``moe_gmm_plain``)
against the Pallas K9 in interpret mode and ``ref.moe_gmm``, the port's
``ref.moe_gmm`` and ``ops.moe_grouped_matmul`` against the reference's,
and the MoE layer, whose expert replay now runs through K9, against
``repro.nn.moe.apply`` at decode and prefill shapes.

Tolerances: f32 max |diff| <= 1e-5 * max |ref| (the same f32 products,
summed in another order); the layer in bf16 <= 2e-2 * max |ref| (bf16
intermediates rounded at other places, as in ``tests/test_torch_moe.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import moe_gmm as jax_k9
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.nn import moe as jax_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.kernels import moe_gmm as k9
from repro_torch.kernels import ops, ref
from repro_torch.nn import moe

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _rel(out, exp) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    exp = np.asarray(exp, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - exp).max()
                 / np.abs(exp).max())


def _ids(seed, t, e, skew=False):
    rng = np.random.default_rng(seed)
    if skew:   # half the tokens on expert 0: its group overflows
        ids = np.where(rng.random(t) < 0.5, 0, rng.integers(0, e, size=t))
    else:
        ids = rng.integers(0, e, size=t)
    return ids.astype(np.int32)


# t, e, cap, bm, skew: tests/test_kernels_lm.py's roundtrip and capacity
# cases, benchmarks/moe_streams_bench.py's shapes, and overflow
DRYRUN_CASES = [(64, 4, 32, 16, False), (128, 4, 16, 8, False),
                (512, 8, 128, 64, False), (40, 3, 8, 8, True),
                (300, 5, 48, 16, True), (1, 2, 16, 16, False)]


@pytest.mark.parametrize("t,e,cap,bm,skew", DRYRUN_CASES)
def test_route_dryrun_equals_reference_bit_for_bit(t, e, cap, bm, skew):
    ids = _ids(t + e, t, e, skew)
    exp = [np.asarray(a) for a in jax_k9.route_dryrun(jnp.asarray(ids), e,
                                                       cap, bm)]
    out = [a.numpy() for a in k9.route_dryrun(torch.from_numpy(ids), e, cap,
                                              bm)]
    for o, x, dtype in zip(out, exp, (np.int32, np.int32, np.bool_)):
        assert o.dtype == dtype and x.dtype == dtype
        np.testing.assert_array_equal(o, x)
    if skew:
        assert np.bincount(ids, minlength=e).max() > cap   # overflow taken


def test_route_dryrun_capacity_property():
    """No expert receives more than `capacity` tokens; kept tokens keep
    their order within their expert group (the §II-H stream order)."""
    e, cap, bm = 4, 16, 8
    eid = _ids(7, 128, e)
    gi, tile_eid, keep = k9.route_dryrun(torch.from_numpy(eid), e, cap, bm)
    gi, keep = gi.numpy(), keep.numpy()
    assert gi.shape == (e * cap,) and tuple(tile_eid.shape) == (e * cap // bm,)
    for g in range(e):
        rows = gi[g * cap:(g + 1) * cap][keep[g * cap:(g + 1) * cap]]
        assert len(rows) == min(cap, int((eid == g).sum()))
        assert all(eid[r] == g for r in rows)
        assert list(rows) == sorted(rows)
    with pytest.raises(ValueError, match="multiple of bm"):
        k9.route_dryrun(torch.from_numpy(eid), e, 12, 8)


def _grouped(seed, t, d, f, e, cap, bm):
    """The reference's roundtrip inputs: tokens grouped by route_dryrun,
    dropped rows zeroed, and the expert weights."""
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((t, d)).astype(np.float32)
    wts = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
    gi, tile_eid, keep = jax_k9.route_dryrun(jnp.asarray(_ids(seed, t, e)),
                                             e, cap, bm)
    grouped = np.array(jnp.asarray(tok)[gi] * keep[:, None])
    return grouped, wts, np.array(tile_eid)


# t, d, f, e, cap, bm: the roundtrip case, the bench's shapes, a wide one
GMM_CASES = [(64, 32, 48, 4, 32, 16), (512, 128, 256, 8, 128, 64),
             (96, 48, 32, 3, 64, 32)]


@pytest.mark.parametrize("t,d,f,e,cap,bm", GMM_CASES)
def test_plain_matches_reference_kernel_and_oracle(t, d, f, e, cap, bm):
    grouped, wts, tile_eid = _grouped(t + d, t, d, f, e, cap, bm)
    out = k9.moe_gmm_plain(torch.from_numpy(grouped), torch.from_numpy(wts),
                           torch.from_numpy(tile_eid), bm=bm)
    assert out.dtype == torch.float32 and out.shape == (e * cap, f)
    interp = jax_k9.moe_gmm(jnp.asarray(grouped), jnp.asarray(wts),
                            jnp.asarray(tile_eid), bm=bm, bn=min(f, 16),
                            bk=min(d, 16), interpret=True)
    oracle = jax_ref.moe_gmm(jnp.asarray(grouped), jnp.asarray(wts),
                             jnp.bincount(jnp.asarray(tile_eid), length=e)
                             * bm)
    assert _rel(out, interp) <= F32_TOL
    assert _rel(out, oracle) <= F32_TOL


def test_plain_empty_tiles_ragged_tail_and_bad_ids():
    """A tile of -1 gives zero rows; a last tile may be ragged; an id >= E
    raises in the plain version; the wrapper on a CPU tensor is the plain
    version and launches nothing."""
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.standard_normal((37, 12)).astype(np.float32))
    wts = torch.from_numpy(rng.standard_normal((3, 12, 7)).astype(np.float32))
    tile_eid = torch.tensor([2, -1, 0, 0, 1], dtype=torch.int32)
    before = k9.launches
    out = k9.moe_gmm(tok, wts, tile_eid, bm=8)
    assert k9.launches == before
    assert torch.equal(out, k9.moe_gmm_plain(tok, wts, tile_eid, bm=8))
    assert not out[8:16].any()
    for i, eid in enumerate(tile_eid.tolist()):
        if eid >= 0:
            rows = slice(8 * i, min(8 * i + 8, 37))
            torch.testing.assert_close(out[rows], tok[rows] @ wts[eid],
                                       rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="id >= E"):
        k9.moe_gmm_plain(tok, wts, torch.tensor([0, 3, 0, 0, 0],
                                                dtype=torch.int32), bm=8)
    with pytest.raises(ValueError, match="tile_eid must be"):
        k9.moe_gmm(tok, wts, tile_eid[:4], bm=8)
    with pytest.raises(ValueError, match="int32"):
        k9.moe_gmm(tok, wts, tile_eid.long(), bm=8)
    with pytest.raises(ValueError, match=r"\(E, D, F\)"):
        k9.moe_gmm(tok, wts[:, :5], tile_eid, bm=8)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_ops_grouped_matmul_matches_reference(impl):
    t, d, f, e, cap, bm = 256, 64, 128, 4, 64, 32
    grouped, wts, tile_eid = _grouped(11, t, d, f, e, cap, bm)
    exp = jax_ops.moe_grouped_matmul(jnp.asarray(grouped), jnp.asarray(wts),
                                     jnp.asarray(tile_eid), impl=impl, bm=bm)
    out = ops.moe_grouped_matmul(torch.from_numpy(grouped),
                                 torch.from_numpy(wts),
                                 torch.from_numpy(tile_eid), bm=bm)
    assert _rel(out, exp) <= F32_TOL


@pytest.mark.parametrize("sizes", [(16, 16, 16, 16), (5, 0, 46, 13),
                                   (0, 0, 64, 0), (1, 2, 3, 58)])
def test_ref_moe_gmm_matches_reference(sizes):
    rng = np.random.default_rng(sum(sizes) + sizes[0])
    tok = rng.standard_normal((64, 24)).astype(np.float32)
    wts = rng.standard_normal((4, 24, 40)).astype(np.float32)
    exp = jax_ref.moe_gmm(jnp.asarray(tok), jnp.asarray(wts),
                          jnp.asarray(sizes))
    out = ref.moe_gmm(torch.from_numpy(tok), torch.from_numpy(wts),
                      torch.tensor(sizes))
    assert _rel(out, exp) <= F32_TOL
    with pytest.raises(ValueError, match="summing to 64"):
        ref.moe_gmm(torch.from_numpy(tok), torch.from_numpy(wts),
                    torch.tensor((1, 2, 3, 4)))


def test_pick_bm():
    assert k9.pick_bm(16, 8) == 16            # decode, batch 8, top-2
    assert k9.pick_bm(160, 8) == 64           # a short prefill
    assert k9.pick_bm(5120, 8) == 128         # batch 8 x 512
    assert k9.pick_bm(0, 8) == 16


def _tw(t, d, f, e=4, dtype=torch.bfloat16, offset=None):
    """tokens (t, d) and weights (e, d, f); ``offset`` names the one made a
    contiguous view 2 (bf16) or 4 (f32) bytes off 16-byte alignment."""
    def make(shape, off):
        n = int(np.prod(shape))
        if off:
            return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
        return torch.zeros(shape, dtype=dtype)
    return (make((t, d), offset == "tokens"),
            make((e, d, f), offset == "weights"))


# (tokens, weights) of each case, bm, and the route a CUDA call takes
K9_ROUTE_CASES = {
    "bf16 bm 128": (lambda: _tw(300, 256, 384), 128, "wgmma"),
    "bf16 bm 64": (lambda: _tw(300, 256, 384), 64, "wgmma"),
    "bf16 bm 16 (decode)": (lambda: _tw(144, 256, 512), 16, "stream"),
    "bf16 bm 32": (lambda: _tw(100, 64, 72), 32, "stream"),
    "f32 bm 128": (lambda: _tw(300, 256, 384, dtype=torch.float32), 128,
                   "mma"),
    "D % 8 != 0": (lambda: _tw(77, 1003, 520), 64, "mma"),
    "F % 8 != 0": (lambda: _tw(77, 1000, 517), 64, "mma"),
    "offset tokens": (lambda: _tw(64, 128, 256, offset="tokens"), 64, "mma"),
    "offset weights": (lambda: _tw(64, 128, 256, offset="weights"), 128,
                       "mma"),
}


@pytest.mark.parametrize("case", list(K9_ROUTE_CASES))
def test_route_by_dtype_tile_height_shape_and_alignment(case):
    """``moe_gmm.route``: bf16 with bm a multiple of 64, D and F multiples
    of 8 and both operands 16-byte aligned take the wgmma kernel; under the
    same rule decode's bm 16 (or 32, 48) takes the stream kernel; f32, a
    ragged D or F, or an unaligned view take the mma one."""
    make, bm, want = K9_ROUTE_CASES[case]
    tokens, weights = make()
    assert k9.route(tokens, weights, bm) == want


def test_moe_gmm_on_cpu_takes_the_plain_version_on_either_route():
    """On CPU tensors ``moe_gmm`` is the plain version whatever the route
    would be on the card, and counts no launch of either kernel."""
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.standard_normal((200, 64), np.float32))
    weights = torch.from_numpy(rng.standard_normal((3, 64, 40), np.float32))
    tokens, weights = tokens.bfloat16(), weights.bfloat16()
    tile_eid = torch.tensor([2, -1, 0, 1], dtype=torch.int32)
    assert k9.route(tokens, weights, 64) == "wgmma"
    k9.launches = k9.launches_wgmma = 0
    out = k9.moe_gmm(tokens, weights, tile_eid, bm=64)
    assert (k9.launches, k9.launches_wgmma) == (0, 0)
    assert torch.equal(out, k9.moe_gmm_plain(tokens, weights, tile_eid,
                                             bm=64))
    assert not out[64:128].any()


def _cfgs(dtype):
    arch = "jamba-1.5-large-398b"
    return (dataclasses.replace(smoke_config(get_config(arch)), dtype=dtype),
            dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                                dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l", [(3, 1), (2, 1024), (2, 600)])
def test_layer_replay_through_k9_matches_reference(dtype, b, l):
    """(3, 1): decode, groups of one token with capacity 1; (2, 1024): two
    groups of 512 per sequence, with drops; (2, 600): 512 does not divide
    L, so one group of 600 per sequence."""
    cfg_t, cfg_j = _cfgs(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, _ = jax_moe.init(jax.random.PRNGKey(b * l), cfg_j, jdt)
    x = jnp.asarray(np.random.default_rng(l).standard_normal(
        (b, l, cfg_j.d_model)).astype(np.float32), jdt)
    exp, aux_e = jax_moe.apply(jp, cfg_j, x)
    tp = params_from_jax(jp, "cpu")
    out, aux = moe.apply(tp, cfg_t, to_tensor(np.asarray(x), "cpu"))
    assert out.shape == (b, l, cfg_t.d_model)
    assert out.dtype == tp["router"].dtype
    assert _rel(out, exp) <= (F32_TOL if dtype == "float32" else BF16_TOL)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(aux_e[name]),
                                   rtol=1e-5 if dtype == "float32" else 1e-2)


def test_replay_layout_groups_the_held_entries():
    """Each held expert's entries fill its rows from a tile start on, in
    entry order; tiles past the last used one are -1, and entries that are
    dropped or held elsewhere get the row past the buffer."""
    held, bm, tiles = 3, 4, 6
    expert = torch.tensor([0, 2, 0, 5, 2, 0, 0, 0, 1, -1])
    mine = (expert >= 0) & (expert < held)
    mine[6] = False                                # dropped by capacity
    row, tile_eid = moe.replay_layout(expert, mine, held, bm, tiles)
    assert row.tolist() == [0, 8, 1, 24, 9, 2, 24, 3, 4, 24]
    assert tile_eid.dtype == torch.int32
    assert tile_eid.tolist() == [0, 1, 2, -1, -1, -1]


def test_scheduler_counts_the_calls_that_run_k9():
    """``serve_continuous`` counts its forward and decode_step calls, the
    calls whose MoE layers run K9 (12 launches each on the Jamba cut's
    card); one forward per request."""
    from repro_torch.launch import serve
    from repro_torch.nn import transformer as T
    cfg = smoke_config(get_config("jamba-1.5-large-398b-1chip"))
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.arange(5), np.arange(2, 9), np.arange(3)]
    calls = {}
    out = serve.serve_continuous(params, cfg, prompts, lanes=2, max_len=32,
                                 max_new=4, eos=-1, calls=calls)
    assert calls["forward"] == len(prompts)
    assert calls["decode_step"] >= 3 and all(len(r) == 4
                                             for r in out.values())
    assert out == serve.serve_continuous(params, cfg, prompts, lanes=2,
                                         max_len=32, max_new=4, eos=-1)
