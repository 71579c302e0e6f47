"""The port's §II-H kernel streams on the CPU against the JAX package: the
dryrun schedules, segments and prefetch streams array for array, and K4's
plain version against the JAX Pallas K4 in interpret mode on the same
schedule and against ``ref.conv2d_fused``, on the same numpy inputs.

Tolerance: max |diff| <= 1e-5 * max |reference|; both sides sum in f32, in
different orders."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streams as jax_streams
from repro.kernels import ref as jax_ref
from repro.kernels.conv2d_streams import conv2d_streams as jax_conv2d_streams
from repro.kernels.conv2d_streams import \
    conv2d_streams_auto as jax_conv2d_streams_auto
from repro_torch.core import streams
from repro_torch.core.blocking import ConvBlocking
from repro_torch.kernels import conv2d_streams as k4
from repro_torch.kernels import ref
from repro_torch.launch import streams_demo

REL = 1e-5
ORDERS = ("nkpc", "npkc", "knpc", "pknc")

# n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk
CASES = [
    (2, 8, 8, 16, 16, 3, 1, 1, 4, 8, 8),      # c_b = k_b = 2
    (1, 9, 9, 8, 16, 3, 1, 1, 4, 8, 8),       # P = 9: a tail row block
    (2, 16, 16, 8, 8, 3, 2, 1, 3, 8, 8),      # stride 2, P = 8 over rb_p 3
    (1, 14, 14, 16, 32, 1, 1, 0, 4, 16, 8),   # 1x1, k_blk < K
    (1, 24, 24, 8, 16, 7, 2, 3, 5, 8, 8),     # 7x7 stride 2 halo, P tail
    (1, 8, 8, 16, 8, 1, 2, 0, 3, 8, 16),      # 1x1 stride 2, c_blk = C
]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), err


def _data(case, seed=0):
    n, h, w, c, k, r = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((r, r, c, k)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(k).astype(np.float32)
    return x, wt, bias


def _schedule(case, order, relu=True):
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    p = (h + 2 * pad - r) // stride + 1
    return streams.build_conv_schedule(
        n=n, k_b=k // k_blk, p_b=math.ceil(p / min(rb_p, p)), c_b=c // c_blk,
        order=order, relu=relu)


def _to_jax(sched):
    return jax_streams.ConvSchedule(
        n_ids=sched.n_ids, kb_ids=sched.kb_ids, pb_ids=sched.pb_ids,
        cb_ids=sched.cb_ids, flags=sched.flags, segments=sched.segments,
        grid=sched.grid)


def _shuffled(sched, seed=0):
    runs = len(streams.run_starts(sched))
    return streams.permute_runs(
        sched, np.random.default_rng(seed).permutation(runs).tolist())


# -- dryrun ------------------------------------------------------------------

@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("grid", [(1, 1, 1, 1), (2, 3, 4, 5), (3, 1, 2, 4),
                                  (1, 4, 7, 1)])
def test_schedule_equals_reference(order, relu, grid):
    n, k_b, p_b, c_b = grid
    ours = streams.build_conv_schedule(n=n, k_b=k_b, p_b=p_b, c_b=c_b,
                                       order=order, relu=relu)
    theirs = jax_streams.build_conv_schedule(n=n, k_b=k_b, p_b=p_b, c_b=c_b,
                                             order=order, relu=relu)
    for name in ("n_ids", "kb_ids", "pb_ids", "cb_ids", "flags"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ours.segments == theirs.segments and ours.grid == theirs.grid
    assert len(ours) == len(theirs) == n * k_b * p_b * c_b
    for a, b in zip(streams.prefetch_streams(ours),
                    jax_streams.prefetch_streams(theirs)):
        assert np.array_equal(a, b)
    assert np.array_equal(
        streams.decode_segments(ours.segments, len(ours)), ours.flags)
    assert np.array_equal(
        streams.decode_segments(ours.segments, len(ours)),
        jax_streams.decode_segments(theirs.segments, len(theirs)))


@pytest.mark.parametrize("order", ["nkcp", "cnkp", "nckp"])
def test_c_not_innermost_fails_as_in_reference(order):
    with pytest.raises(AssertionError, match="innermost"):
        jax_streams.build_conv_schedule(n=1, k_b=2, p_b=2, c_b=2, order=order)
    with pytest.raises(AssertionError, match="innermost"):
        streams.build_conv_schedule(n=1, k_b=2, p_b=2, c_b=2, order=order)


def test_rle_segments_equal_reference():
    flags = np.array([3, 3, 1, 0, 0, 2, 6, 6, 1], dtype=np.int32)
    assert streams.rle_segments(flags) == jax_streams.rle_segments(flags)


def test_permute_runs_keeps_runs_whole():
    sched = streams.build_conv_schedule(n=2, k_b=2, p_b=3, c_b=3, order="knpc",
                                        relu=True)
    shuf = _shuffled(sched, seed=3)
    assert len(shuf) == len(sched) and shuf.grid == sched.grid
    assert not np.array_equal(shuf.n_ids * 100 + shuf.kb_ids * 10
                              + shuf.pb_ids,
                              sched.n_ids * 100 + sched.kb_ids * 10
                              + sched.pb_ids)
    starts = streams.run_starts(shuf)
    assert np.array_equal(starts, np.arange(0, len(sched), 3))
    for s0 in starts:   # each run: one tile, c-blocks 0..2, INIT..EPILOGUE
        assert len({(shuf.n_ids[i], shuf.kb_ids[i], shuf.pb_ids[i])
                    for i in range(s0, s0 + 3)}) == 1
        assert shuf.cb_ids[s0:s0 + 3].tolist() == [0, 1, 2]
    k4._check_streams(shuf)


# -- replay --------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("order", ORDERS)
def test_plain_replay_matches_fused_reference(case, order):
    x, wt, bias = _data(case)
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    sched = _schedule(case, order)
    out = k4.conv2d_streams(torch.from_numpy(x), torch.from_numpy(wt),
                            schedule=sched, stride=stride, padding=pad,
                            bias=torch.from_numpy(bias), rb_p=rb_p,
                            k_blk=k_blk, c_blk=c_blk)
    assert out.dtype == torch.float32
    exp = jax_ref.conv2d_fused(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                               padding=pad, bias=jnp.asarray(bias), relu=True)
    _close(out.numpy(), exp)
    mine = ref.conv2d_fused(torch.from_numpy(x), torch.from_numpy(wt),
                            stride=stride, padding=pad,
                            bias=torch.from_numpy(bias), relu=True)
    _close(out.numpy(), mine.numpy())


@pytest.mark.parametrize("case", CASES)
def test_plain_replay_matches_jax_interpret_kernel(case):
    """The same schedule through the Pallas K4 in interpret mode."""
    x, wt, bias = _data(case, seed=1)
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    sched = _schedule(case, "npkc")
    kw = dict(stride=stride, padding=pad, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk)
    out = k4.conv2d_streams_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                  schedule=sched, bias=torch.from_numpy(bias),
                                  **kw)
    exp = jax_conv2d_streams(jnp.asarray(x), jnp.asarray(wt),
                             schedule=_to_jax(sched),
                             bias=jnp.asarray(bias), interpret=True, **kw)
    _close(out.numpy(), exp)


@pytest.mark.parametrize("order", ORDERS)
def test_every_order_matches_jax_interpret_kernel(order):
    case = CASES[1]
    x, wt, bias = _data(case, seed=2)
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    sched = _schedule(case, order, relu=False)
    kw = dict(stride=stride, padding=pad, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk)
    out = k4.conv2d_streams_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                  schedule=sched, bias=torch.from_numpy(bias),
                                  **kw)
    exp = jax_conv2d_streams(jnp.asarray(x), jnp.asarray(wt),
                             schedule=_to_jax(sched),
                             bias=jnp.asarray(bias), interpret=True, **kw)
    _close(out.numpy(), exp)


@pytest.mark.parametrize("case", [CASES[0], CASES[4]])
def test_shuffled_runs_replay_the_same(case):
    """Whole runs permuted: the plain replay gives the same bits, and the
    JAX interpret kernel agrees on the shuffled schedule too."""
    x, wt, bias = _data(case, seed=4)
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    sched = _schedule(case, "nkpc")
    shuf = _shuffled(sched, seed=5)
    kw = dict(stride=stride, padding=pad, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk,
              bias=torch.from_numpy(bias))
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    base = k4.conv2d_streams_plain(xt, wtt, schedule=sched, **kw)
    out = k4.conv2d_streams_plain(xt, wtt, schedule=shuf, **kw)
    assert torch.equal(out, base)
    kw["bias"] = jnp.asarray(bias)
    exp = jax_conv2d_streams(jnp.asarray(x), jnp.asarray(wt),
                             schedule=_to_jax(shuf), interpret=True, **kw)
    _close(out.numpy(), exp)


@pytest.mark.parametrize("knobs", [
    dict(),                                           # the defaults
    dict(rb_p=3, k_blk=8, c_blk=8, order="pknc"),     # explicit
    dict(blocking=ConvBlocking(rb_p=2, k_blk=8, c_blk=8, order="knpc",
                               vmem_bytes=0, rb_q=0)),
    dict(blocking=ConvBlocking(rb_p=2, k_blk=8, c_blk=8, order="knpc",
                               vmem_bytes=0, rb_q=0), rb_p=5),
])
def test_streams_auto_matches_reference(knobs):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 10, 16)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    jax_knobs = dict(knobs)
    if "blocking" in knobs:
        from repro.core.blocking import ConvBlocking as JaxBlocking
        jax_knobs["blocking"] = JaxBlocking(**vars(knobs["blocking"]))
    out = k4.conv2d_streams_auto(torch.from_numpy(x), torch.from_numpy(wt),
                                 stride=1, padding=1,
                                 bias=torch.from_numpy(bias), relu=True,
                                 autotune="off", **knobs)
    exp = jax_conv2d_streams_auto(jnp.asarray(x), jnp.asarray(wt), stride=1,
                                  padding=1, bias=jnp.asarray(bias),
                                  relu=True, autotune="off", interpret=True,
                                  **jax_knobs)
    _close(out.numpy(), exp)


def test_replay_obeys_the_flags():
    """Init, epilogue and ReLU come from the flag stream: without FLAG_RELU
    in the stream the output keeps its negatives."""
    case = CASES[0]
    x, wt, bias = _data(case)
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    kw = dict(stride=stride, padding=pad, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk,
              bias=torch.from_numpy(bias))
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    plain = k4.conv2d_streams_plain(xt, wtt, schedule=_schedule(case, "nkpc",
                                                                relu=False),
                                    **kw)
    relu = k4.conv2d_streams_plain(xt, wtt, schedule=_schedule(case, "nkpc"),
                                   **kw)
    assert float(plain.min()) < 0
    assert torch.equal(relu, torch.clamp_min(plain, 0))


@pytest.mark.parametrize("breakage", ["range", "no_init", "split_tile",
                                      "missing_tile", "grid"])
def test_malformed_schedules_raise(breakage):
    case = CASES[0]
    x, wt, bias = _data(case)
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    sched = _schedule(case, "nkpc")
    fields = {f: getattr(sched, f).copy() for f in
              ("n_ids", "kb_ids", "pb_ids", "cb_ids", "flags")}
    grid = sched.grid
    if breakage == "range":
        fields["cb_ids"][3] = grid[3]
    elif breakage == "no_init":
        fields["flags"][0] &= ~streams.FLAG_INIT
    elif breakage == "split_tile":
        fields["pb_ids"][1] = (fields["pb_ids"][0] + 1) % grid[2]
    elif breakage == "missing_tile":
        fields["n_ids"][2:4] = fields["n_ids"][0]
        fields["kb_ids"][2:4] = fields["kb_ids"][0]
        fields["pb_ids"][2:4] = fields["pb_ids"][0]
    else:
        grid = (n, k // k_blk, 1, c // c_blk)
    bad = streams.ConvSchedule(**fields, segments=sched.segments, grid=grid)
    with pytest.raises(ValueError):
        k4.conv2d_streams(torch.from_numpy(x), torch.from_numpy(wt),
                          schedule=bad, stride=stride, padding=pad,
                          rb_p=rb_p, k_blk=k_blk, c_blk=c_blk)


def test_non_dividing_blocks_raise():
    x, wt, _ = _data(CASES[0])
    with pytest.raises(ValueError, match="divide"):
        k4.conv2d_streams_auto(torch.from_numpy(x), torch.from_numpy(wt),
                               padding=1, k_blk=6, autotune="off")


def test_tile_config_covers_every_tile():
    """Each CTA tile of the kernel is chosen for some layer, and the
    modeled share of peak stays in (0, 1]."""
    chosen = set()
    for tile_m in (7, 28, 49, 56, 112, 448, 3136):
        for k_blk in (8, 16, 32, 64, 128):
            for runs in (1, 64, 4096):
                idx, util = k4.tile_config(tile_m=tile_m, k_blk=k_blk,
                                           c_blk=64, runs=runs)
                assert 0 < util <= 1
                chosen.add(idx)
    assert chosen == set(range(len(k4.TILES)))
    for bm, bn, tm, tn in k4.TILES:
        assert (bm // tm) * (bn // tn) == 256 and tm % 4 == 0 and tn % 4 == 0


def test_streams_demo_runs_on_cpu(capsys):
    res = streams_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "dryrun:" in out and "prefetch property holds: True" in out
    assert res["prefetch_ok"] and res["launches"] == 0
    assert res["steps"] == len(streams.build_conv_schedule(
        n=2, k_b=4, p_b=2, c_b=2, order=res["blocking"].order))
    assert res["max_err"] <= 1e-5
