"""Hybrid and MoE training's kernels on the CPU against the JAX package.

K8' (``conv1d_causal_bwd_plain``, the backward kernel's function written
out in plain f32 PyTorch) against ``jax.vjp`` of the reference's
``repro.kernels.ref.conv1d_causal`` (the function K8 computes, whose
gradient the reference's training takes from XLA) and against torch
autograd of ``conv1d_causal_plain``: SiLU and "none", with and without a
bias, at a ragged L, x with the strided rows the Mamba mixer passes.  K9'
(``moe_gmm_bwd_plain``) against ``jax.vjp`` of ``repro.kernels.ref.moe_gmm``
with the group sizes of the ``tile_eid`` runs, with -1 tail tiles (whose
rows get a zero gradient) and an expert with no rows, and against autograd
of ``moe_gmm_plain``.  Both wrappers' CPU dispatch, ``route_bwd`` of both
and ``bwd_run_length`` as pure functions; the training cut
``jamba-1.5-large-398b-train-1chip`` (the reference Jamba's widths, its
reductions, 4.65 B parameters held); and a smoke-width train step of it
through ``launch.train.main``.

Tolerance: max |diff| <= 1e-5 * max |ref| per gradient (f32; the sums run
in other orders).
"""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d_causal as k8
from repro_torch.kernels import moe_gmm as k9
from repro_torch.launch import train

TOL = 1e-5
TRAIN_ARCH = "jamba-1.5-large-398b-train-1chip"


def _rel(out, exp) -> float:
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    exp = np.asarray(exp, np.float32)
    return float(np.abs(out - exp).max() / max(np.abs(exp).max(), 1e-30))


def _rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@jax.jit
def _conv_vjp_silu(x, w, b, dy):
    return jax.vjp(lambda x_, w_, b_: jax_ref.conv1d_causal(
        x_, w_, bias=b_, act="silu"), x, w, b)[1](dy)


@jax.jit
def _conv_vjp_none(x, w, b, dy):
    return jax.vjp(lambda x_, w_, b_: jax_ref.conv1d_causal(
        x_, w_, bias=b_, act="none"), x, w, b)[1](dy)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", ["silu", "none"])
def test_conv1d_bwd_plain_matches_reference(act, with_bias):
    """B 2, L 13 (ragged), D 24, 4 taps; x is the first half of a (B, L,
    2D) projection, as the mixer passes it."""
    rng = np.random.default_rng(0)
    proj, w, b, dy = (_rnd(rng, 2, 13, 48), _rnd(rng, 4, 24) * 0.5,
                      _rnd(rng, 24), _rnd(rng, 2, 13, 24))
    x = np.ascontiguousarray(proj[..., :24])
    fn = _conv_vjp_silu if act == "silu" else _conv_vjp_none
    # without a bias the reference's bias is zero (its gradient unread)
    exp = fn(x, w, b if with_bias else np.zeros_like(b), dy)
    xt = torch.from_numpy(proj)[..., :24]
    assert xt.stride(1) == 48
    bias = torch.from_numpy(b) if with_bias else None
    dx, dw, db = k8.conv1d_causal_bwd_plain(xt, torch.from_numpy(w),
                                            torch.from_numpy(dy), bias=bias,
                                            act=act)
    assert (db is None) == (not with_bias)
    got = (dx, dw) + ((db,) if with_bias else ())
    for g, e in zip(got, exp):
        assert _rel(g, e) <= TOL
    leaves = [xt.clone().requires_grad_(),
              torch.from_numpy(w).requires_grad_()] \
        + ([bias.clone().requires_grad_()] if with_bias else [])
    y = k8.conv1d_causal_plain(leaves[0], leaves[1],
                               bias=leaves[2] if with_bias else None, act=act)
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for g, a in zip(got, auto):
        assert _rel(g, a) <= TOL
    # the wrapper's CPU dispatch is the plain version, and the CPU forward
    # carries autograd's graph of it
    again = k8.conv1d_causal_bwd(xt, torch.from_numpy(w),
                                 torch.from_numpy(dy), bias=bias, act=act)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert y.grad_fn is not None


@jax.jit
def _gmm_vjp(tokens, weights, sizes, dout):
    return jax.vjp(lambda t, w: jax_ref.moe_gmm(t, w, sizes), tokens,
                   weights)[1](dout)


# bm, tile_eid, T: experts 0, 2, 3 with rows, expert 1 none, -1 tail tiles
# (the last ragged); then expert 0 empty and a single -1 tile
GMM_CASES = [(4, [0, 0, 2, 2, 2, 3, -1, -1], 30),
             (8, [1, 2, 2, 3, -1], 37)]


@pytest.mark.parametrize("bm,ids,t", GMM_CASES)
def test_moe_gmm_bwd_plain_matches_reference(bm, ids, t):
    e, d, f = 4, 12, 20
    rng = np.random.default_rng(1)
    tokens, weights, dout = (_rnd(rng, t, d), _rnd(rng, e, d, f),
                             _rnd(rng, t, f))
    tile_eid = torch.tensor(ids, dtype=torch.int32)
    used = sum(i >= 0 for i in ids) * bm     # the -1 tiles are the tail
    sizes = np.bincount([i for i in ids if i >= 0], minlength=e) * bm
    assert 0 in sizes                        # an expert with no rows
    dtok_j, dw_j = _gmm_vjp(tokens[:used], weights, sizes, dout[:used])
    dtok, dw = k9.moe_gmm_bwd_plain(torch.from_numpy(tokens),
                                    torch.from_numpy(weights), tile_eid,
                                    torch.from_numpy(dout), bm=bm)
    assert dtok.shape == (t, d) and dw.shape == (e, d, f)
    assert _rel(dtok[:used], dtok_j) <= TOL
    assert _rel(dw, dw_j) <= TOL
    assert not dtok[used:].any()              # rows of -1 tiles
    assert not dw[int(np.argmin(sizes))].any()
    leaves = [torch.from_numpy(tokens).requires_grad_(),
              torch.from_numpy(weights).requires_grad_()]
    out = k9.moe_gmm_plain(*leaves, tile_eid, bm=bm)
    assert out.grad_fn is not None
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    assert _rel(dtok, auto[0]) <= TOL and _rel(dw, auto[1]) <= TOL
    again = k9.moe_gmm_bwd(torch.from_numpy(tokens),
                           torch.from_numpy(weights), tile_eid,
                           torch.from_numpy(dout), bm=bm)
    assert torch.equal(again[0], dtok) and torch.equal(again[1], dw)


def test_conv1d_route_bwd_and_run_length():
    """"tile" where every row of x and dy starts on a 16-byte boundary (the
    mixer's strided half included), "vec" where D and x's strides are
    multiples of 4 and every operand aligned to 4 elements but a row is off
    the 16-byte rule (bf16 at D 20), "thread" otherwise; the vec and thread
    routes' run halves until the grid is full, down to 16."""
    w = torch.zeros(4, 24)
    proj = torch.zeros(2, 13, 48)
    assert k8.route_bwd(proj[..., :24], w) == "tile"
    assert k8.route_bwd(proj[..., :24].bfloat16(), w.bfloat16()) == "tile"
    assert k8.route_bwd(proj[..., :20].bfloat16(),
                        torch.zeros(4, 20).bfloat16()) == "vec"
    assert k8.route_bwd(torch.zeros(2, 13, 6), torch.zeros(4, 6)) == "thread"
    assert k8.route_bwd(proj[..., 1:25], w) == "thread"      # unaligned
    assert k8.route_bwd(torch.zeros(2, 13, 24, dtype=torch.float64),
                        w) == "thread"
    dy = torch.zeros(2, 13, 25)[..., 1:]                      # unaligned dy
    assert k8.route_bwd(proj[..., :24], w, None, dy) == "thread"
    dy = torch.zeros(2, 13, 28).bfloat16()[..., 4:]           # 8-byte dy
    assert k8.route_bwd(proj[..., :24].bfloat16(), w.bfloat16(), None,
                        dy) == "vec"
    assert k8.bwd_run_length(2, 512, 16384, 4) == 32          # the cut
    assert k8.bwd_run_length(64, 4096, 16384, 4) == k8.BWD_MAX_RUN
    assert k8.bwd_run_length(1, 64, 64, 1) == k8.BWD_MIN_RUN
    with pytest.raises(ValueError):
        k8.conv1d_causal_bwd_plain(proj[..., :24], w, torch.zeros(2, 12, 24))


def test_moe_route_bwd():
    """"wgmma" for bf16 at bm 64 and 128 with D and F multiples of 8 and
    16-byte aligned operands (the cut's gate/up and down shapes included),
    "mma" for bf16 off that rule (bm 16, ragged F, an unaligned view, too
    many tiles or experts), "simt" for f32 at any bm."""
    tid = torch.zeros(1, dtype=torch.int32)
    tok, wts = torch.zeros(4, 8).bfloat16(), torch.zeros(1, 8, 8).bfloat16()
    assert k9.route_bwd(tok, wts, 64) == "wgmma"
    assert k9.route_bwd(tok, wts, 128, torch.zeros(4, 8).bfloat16()) \
        == "wgmma"
    one = torch.zeros((1, 1, 1), dtype=torch.bfloat16)   # shapes, no storage
    for d, f in ((8192, 24576), (24576, 8192)):               # the cut's
        assert k9.route_bwd(one[0].expand(1152, d),
                            one.expand(4, d, f), 128) == "wgmma"
    assert k9.route_bwd(tok, wts, 16) == "mma"
    assert k9.route_bwd(tok, torch.zeros(1, 8, 12).bfloat16(), 64) == "mma"
    assert k9.route_bwd(torch.zeros(5, 9).bfloat16()[:4, 1:], wts,
                        64) == "mma"                         # unaligned
    dout = torch.zeros(4, 9).bfloat16()[:, 1:]                # unaligned
    assert k9.route_bwd(tok, wts, 64, dout) == "mma"
    many = torch.zeros(64 * (k9.BWD_MAX_TILES + 1), 8).bfloat16()
    assert k9.route_bwd(many, wts, 64) == "mma"
    assert k9.route_bwd(tok, torch.zeros(k9.BWD_MAX_EXPERTS + 1, 8,
                                         8).bfloat16(), 64) == "mma"
    for bm in (16, 64, 128):
        assert k9.route_bwd(torch.zeros(4, 8), torch.zeros(1, 8, 8),
                            bm) == "simt"
    with pytest.raises(ValueError):
        k9.route_bwd(torch.zeros(4, 8).half(), torch.zeros(1, 8, 8).half(),
                     64)
    with pytest.raises(ValueError):                 # dout of another shape
        k9.moe_gmm_bwd_plain(torch.zeros(4, 8), torch.zeros(1, 8, 6), tid,
                             torch.zeros(4, 5), bm=4)


@pytest.mark.parametrize("name,module,route", [
    pytest.param("conv1d_causal_bwd", k8, "",
                 id="conv1d_causal_bwd-repro_torch.kernels.conv1d_causal"),
    pytest.param("moe_gmm_bwd", k9, "",
                 id="moe_gmm_bwd-repro_torch.kernels.moe_gmm"),
    pytest.param("conv1d_causal_bwd", k8, "tile", id="conv1d_causal_bwd-tile"),
    pytest.param("moe_gmm_bwd", k9, "wgmma", id="moe_gmm_bwd-wgmma")])
def test_bwd_kernel_symbols_and_argtypes(monkeypatch, name, module, route):
    """K8's and K9's backward ctypes bindings, the first kernels' and the
    tile and wgmma routes': one argtype per parameter of the C function,
    pointers as c_void_p, 64-bit ints as c_longlong, ints as c_int; both
    sources are among the kernels ``build_all`` builds."""
    symbol = f"repro_{name}" + (f"_{route}" if route else "")
    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', src,
                    re.S)
    params = [p.strip() for p in sig.group(1).split(",")]

    class Fn:
        argtypes = restype = None

    monkeypatch.setattr(_build, "load", lambda n: {
        name: type("Lib", (), {symbol: Fn()})()}[n])
    suffix = f"_{route}" if route else ""
    monkeypatch.setattr(module, f"_fn_bwd{suffix}", None)
    fn = getattr(module, f"_kernel_fn_bwd{suffix}")()
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params)
    for ty, param in zip(fn.argtypes, params):
        want = (ctypes.c_void_p if "*" in param else
                ctypes.c_longlong if param.startswith("long long") else
                ctypes.c_int)
        assert ty is want, param
    assert name in _build.KERNELS


def test_train_config_is_jamba_cut_to_two_layers():
    """The reference Jamba's widths; depth 72 -> 2 with one period of each
    layer kind, experts held 16 -> 4 (the router still over 16): 2.233 B
    parameters outside the experts and 4 experts of 0.604 B, 4.65 B."""
    cut, ref = get_config(TRAIN_ARCH), jax_get_config("jamba-1.5-large-398b")
    for field in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab", "d_inner", "d_state", "d_conv", "scan_chunk",
                  "dtype", "remat", "factored_opt", "tie_embeddings",
                  "rope_theta"):
        assert getattr(cut, field) == getattr(ref, field), field
    assert (cut.moe.n_experts, cut.moe.top_k, cut.moe.capacity_factor) == (
        ref.moe.n_experts, ref.moe.top_k, ref.moe.capacity_factor)
    assert cut.n_layers == 2 and cut.block_pattern == (
        ("mamba", "moe"), ("attn", "dense"))
    assert cut.moe.expert_share == (0, 4)
    e0, e1 = cut.moe.held_experts()
    experts = cut.expert_param_count()
    outside = cut.param_count() - experts
    held = outside + experts * (e1 - e0) // cut.moe.n_experts
    assert abs(outside - 2.233e9) < 1e6
    assert abs(experts // cut.moe.n_experts - 0.604e9) < 1e6
    assert abs(held - 4.65e9) < 0.01e9
    assert dataclasses.replace(cut, name="x") != get_config(
        "jamba-1.5-large-398b-1chip")


def test_train_main_trains_the_cut_on_cpu(capsys):
    """The slice's entry point at smoke widths on the CPU (K8 and K9 are
    their plain versions there, differentiated by autograd)."""
    summary = train.main(["--arch", TRAIN_ARCH, "--smoke", "--steps", "2",
                          "--seq-len", "16", "--global-batch", "2",
                          "--device", "cpu"])
    assert summary["arch"] == TRAIN_ARCH + "-smoke"
    assert summary["steps"] == 2 and summary["tokens_per_s"] > 0
    assert np.isfinite(summary["first"]["loss"])
    assert np.isfinite(summary["last"]["loss"])
    assert "tokens/s=" in capsys.readouterr().out


@pytest.mark.parametrize("ids,e,d,f,grid", [
    ([0, 1, 2, 2, -1, -1, -1, -1, -1], 4, 8192, 24576, 132),   # the cut
    ([0, 1, 2, 2, -1, -1, -1, -1, -1], 4, 24576, 8192, 132),
    ([1, -1, 0, 2, 2, 0], 4, 520, 392, 7),                     # tails
    ([-1, -1], 3, 256, 512, 5)])                              # no rows
def test_moe_bwd_work_covers_every_box_once(ids, e, d, f, grid):
    """K9''s dweights work list (``bwd_work``): every (expert, D box, F box)
    exactly once across the blocks, block b taking items b, b + grid, ...
    of the expert-major list (F fastest); each item lists its expert's
    tiles in id-stream order, an expert with no tile its items with none,
    and no -1 tile is in any item."""
    work = k9.bwd_work(ids, e=e, d=d, f=f, grid=grid)
    assert len(work) == grid
    n_d, n_f = -(-d // k9.BWD_BM), -(-f // k9.BWD_BN)
    flat = sorted((w, item) for b, items in enumerate(work)
                  for i, item in enumerate(items)
                  for w in [b + i * grid])
    assert [w for w, _ in flat] == list(range(e * n_d * n_f))
    boxes = [item[:5] for _, item in flat]
    assert boxes == [(x, i * k9.BWD_BM, min((i + 1) * k9.BWD_BM, d),
                      j * k9.BWD_BN, min((j + 1) * k9.BWD_BN, f))
                     for x in range(e) for i in range(n_d)
                     for j in range(n_f)]
    for _, (x, *_, tiles) in flat:
        assert tiles == tuple(i for i, h in enumerate(ids) if h == x)
        assert all(ids[i] >= 0 for i in tiles)
    empty = [x for x in range(e) if x not in ids]
    assert all(not item[5] for _, item in flat if item[0] in empty)
    assert {item[0] for _, item in flat} == set(range(e))


@pytest.mark.parametrize("b,l,d,kw,vec,want", [
    (2, 512, 16384, 4, 8, (128, 4, 64, 4)),     # the cut, bf16
    (2, 512, 16384, 4, 4, (256, 8, 64, 2)),     # the cut, f32
    (2, 100, 1024, 4, 4, (32, 1, 64, 4)),       # a small grid: one warp
    (1, 77, 1000, 3, 8, (32, 1, 64, 2)),        # ragged L and D
    (2, 300, 16384, 4, 8, (128, 4, 64, 4)),     # short and empty walks
    (1, 4096, 4096, 8, 8, (128, 4, 112, 10))])  # 8 taps: a longer walk
def test_conv1d_bwd_tile_plan(b, l, d, kw, vec, want):
    """K8''s tile route (``bwd_tile_plan``): threads, warps, a warp's walk
    and the partial's rows; the walk a whole number of ring stages with at
    least 16 (KW - 1) tokens, the runs cover L once, the grid reaches a
    block an SM unless one warp a block cannot, and the shared memory holds
    the ring and the warps' sums."""
    plan = k8.bwd_tile_plan(b, l, d, kw, vec)
    assert (plan.threads, plan.warps, plan.sub, plan.parts) == want
    assert plan.threads == k8.BWD_TILE_THREADS * plan.warps
    assert plan.warps in k8.BWD_TILE_WARPS
    assert plan.run == plan.warps * plan.sub
    assert plan.sub % plan.rows == 0 and plan.sub >= 16 * (kw - 1)
    assert plan.parts == b * -(-l // plan.run)
    blocks_d = -(-d // (vec * k8.BWD_TILE_THREADS))
    assert plan.blocks == blocks_d * -(-l // plan.run) * b
    assert plan.blocks >= k8.BWD_TILE_BLOCKS_PER_SM * 132 or plan.warps == 1
    assert plan.smem >= plan.stages * plan.rows * 2 * plan.threads * 16
    assert plan.smem >= plan.warps * (kw + 1) * 32 * vec * 4
    assert plan.smem <= 48 * 1024 * 2
