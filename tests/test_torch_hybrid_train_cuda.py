"""Hybrid and MoE training on the card: K8' (``conv1d_causal_bwd``) and K9'
(``moe_gmm_bwd``) against their plain versions on every route and both
dtypes, the same bits twice: K8''s "tile" route (and "vec" forced on the
same inputs), K9''s "wgmma" route at bm 64 and 128 with ragged T, D and F,
-1 tiles and experts with no rows (and "mma" forced on the same inputs);
autograd through K8 and K9 on the card runs the backward kernels.

These need an NVIDIA GPU with the CUDA toolkit (``nvcc``): a CUDA kernel has
no CPU mode, so elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_hybrid_train_cuda.py

Tolerance: max |diff| <= 1e-5 (f32) or 1e-2 (bf16) * max |plain| per
gradient (f32 sums in another order; bf16 rounds each output once).
"""
import pytest
import torch

from repro_torch.kernels import conv1d_causal as k8
from repro_torch.kernels import moe_gmm as k9

pytestmark = pytest.mark.gpu

KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# b, l, d, kw, x read in place from a (b, l, 2d) projection, act, bias: the
# training cut's Mamba shape, a ragged L, an odd D (the thread route); then
# the tile route's tails: a D that leaves threads of the last block idle
# and a ragged L, and the cut's D with a last block whose warps walk short
# or no sub-runs
CONV_CASES = [(2, 512, 16384, 4, True, "silu", True),
              (2, 77, 1024, 4, True, "none", False),
              (1, 33, 1002, 3, False, "silu", True),
              (2, 77, 1000, 3, False, "silu", True),
              (2, 300, 16384, 4, True, "silu", False)]
# t, d, f, e, bm, tile_eid: the cut's tiles of 128 (an expert with no rows,
# -1 tail tiles), tiles of 64, tiles of 16 with D and F off the 16-byte rule;
# then the wgmma route's tails: T, D and F multiples of no block (a ragged
# last tile), -1 tiles in the middle and at the end, experts with no rows
MOE_CASES = [(1152, 512, 1024, 4, 128, [0, 0, 1, 1, 3, -1, -1, -1, -1]),
             (300, 256, 384, 3, 64, [2, 0, 0, -1, -1]),
             (77, 1003, 517, 3, 16, [0, 2, -1, 1, 0]),
             (333, 520, 392, 4, 64, [1, -1, 0, 2, 2, 0]),
             (700, 1032, 776, 5, 128, [4, -1, 0, 0, -1, 2])]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


def _rel(out, exp) -> float:
    return float((out.float() - exp.float()).abs().max()
                 / exp.float().abs().max())


def _conv_inputs(case, dtype, dev, seed=0):
    b, l, d, kw, in_place, _, with_bias = case
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    x = rnd(b, l, 2 * d if in_place else d)
    if in_place:
        x = x.chunk(2, dim=-1)[0]
    return x, rnd(kw, d), rnd(d) if with_bias else None, rnd(b, l, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv1d_bwd_kernel_matches_plain(cuda, case, dtype):
    act = case[5]
    x, w, bias, dy = _conv_inputs(case, dtype, cuda)
    exp = k8.conv1d_causal_bwd_plain(x, w, dy, bias=bias, act=act)
    path = k8.route_bwd(x, w, bias, dy)
    assert path == ("tile" if case[2] % (16 // x.element_size()) == 0
                    else "vec" if case[2] % k8.BWD_VEC == 0 else "thread")
    before = (k8.launches_bwd, k8.launches_bwd_vec, k8.launches_bwd_tile)
    got = k8.conv1d_causal_bwd(x, w, dy, bias=bias, act=act)
    again = k8.conv1d_causal_bwd(x, w, dy, bias=bias, act=act)
    torch.cuda.synchronize()
    assert (k8.launches_bwd - before[0], k8.launches_bwd_vec - before[1],
            k8.launches_bwd_tile - before[2]) \
        == (2, 2 * int(path == "vec"), 2 * int(path == "tile"))
    assert (got[2] is None) == (bias is None)
    for name, a, e, a2 in zip(("dx", "dw", "db"), got, exp, again):
        if e is None:
            continue
        assert a.dtype == dtype and a.shape == e.shape
        assert _rel(a, e) <= KERNEL_TOL[dtype], (name, _rel(a, e))
        assert torch.equal(a, a2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in CONV_CASES
                                  if c[2] % 8 == 0])
def test_conv1d_bwd_vec_route_forced_agrees(cuda, monkeypatch, case, dtype):
    """The vec route, which the tile route took over where rows start on
    16-byte boundaries, forced on the same inputs: against the plain
    version and the tile route's result, within the same limit."""
    act = case[5]
    x, w, bias, dy = _conv_inputs(case, dtype, cuda, seed=4)
    exp = k8.conv1d_causal_bwd_plain(x, w, dy, bias=bias, act=act)
    tile = k8.conv1d_causal_bwd(x, w, dy, bias=bias, act=act)
    monkeypatch.setattr(k8, "route_bwd", lambda *a, **k: "vec")
    before = k8.launches_bwd_vec
    vec = k8.conv1d_causal_bwd(x, w, dy, bias=bias, act=act)
    torch.cuda.synchronize()
    assert k8.launches_bwd_vec - before == 1
    for name, a, b, e in zip(("dx", "dw", "db"), vec, tile, exp):
        if e is None:
            continue
        assert _rel(a, e) <= KERNEL_TOL[dtype], (name, _rel(a, e))
        assert _rel(b, e) <= KERNEL_TOL[dtype], (name, _rel(b, e))


def _moe_inputs(case, dtype, dev, seed=1):
    t, d, f, e, bm, ids = case
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    return (rnd(t, d).to(dtype), (rnd(e, d, f) * d ** -0.5).to(dtype),
            torch.tensor(ids, dtype=torch.int32, device=dev),
            rnd(t, f).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_gmm_bwd_kernel_matches_plain(cuda, case, dtype):
    bm, ids = case[4], case[5]
    tokens, weights, tile_eid, dout = _moe_inputs(case, dtype, cuda)
    exp = k9.moe_gmm_bwd_plain(tokens, weights, tile_eid, dout, bm=bm)
    path = k9.route_bwd(tokens, weights, bm, dout)
    wgmma = bm % 64 == 0 and case[1] % 8 == 0 and case[2] % 8 == 0
    assert path == ("simt" if dtype == torch.float32 else
                    "wgmma" if wgmma else "mma")
    before = (k9.launches_bwd, k9.launches_bwd_mma, k9.launches_bwd_wgmma)
    got = k9.moe_gmm_bwd(tokens, weights, tile_eid, dout, bm=bm)
    again = k9.moe_gmm_bwd(tokens, weights, tile_eid, dout, bm=bm)
    torch.cuda.synchronize()
    assert (k9.launches_bwd - before[0], k9.launches_bwd_mma - before[1],
            k9.launches_bwd_wgmma - before[2]) \
        == (2, 2 * int(path == "mma"), 2 * int(path == "wgmma"))
    for name, a, e, a2 in zip(("dtokens", "dweights"), got, exp, again):
        assert a.dtype == dtype and a.shape == e.shape
        assert _rel(a, e) <= KERNEL_TOL[dtype], (name, _rel(a, e))
        assert torch.equal(a, a2), name
    dead = [r for r in range(case[0]) if ids[r // bm] < 0]
    assert not got[0][dead].any()
    for h in range(case[3]):
        if h not in ids:
            assert not got[1][h].any()


@pytest.mark.parametrize("case", [c for c in MOE_CASES
                                  if c[4] % 64 == 0])
def test_moe_gmm_bwd_mma_route_forced_agrees(cuda, monkeypatch, case):
    """The mma route, which the wgmma route took over for bf16 at bm a
    multiple of 64, forced on the same inputs: against the plain version,
    -1 rows and empty experts exactly zero, within the bf16 limit of the
    wgmma route's result."""
    bm, ids = case[4], case[5]
    tokens, weights, tile_eid, dout = _moe_inputs(case, torch.bfloat16, cuda,
                                                  seed=5)
    exp = k9.moe_gmm_bwd_plain(tokens, weights, tile_eid, dout, bm=bm)
    new = k9.moe_gmm_bwd(tokens, weights, tile_eid, dout, bm=bm)
    monkeypatch.setattr(k9, "route_bwd", lambda *a, **k: "mma")
    before = k9.launches_bwd_mma
    old = k9.moe_gmm_bwd(tokens, weights, tile_eid, dout, bm=bm)
    torch.cuda.synchronize()
    assert k9.launches_bwd_mma - before == 1
    for name, a, b, e in zip(("dtokens", "dweights"), old, new, exp):
        assert _rel(a, e) <= KERNEL_TOL[torch.bfloat16], (name, _rel(a, e))
        assert _rel(b, e) <= KERNEL_TOL[torch.bfloat16], (name, _rel(b, e))
    dead = [r for r in range(case[0]) if ids[r // bm] < 0]
    assert not old[0][dead].any()
    for h in range(case[3]):
        if h not in ids:
            assert not old[1][h].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_on_card_runs_the_backward_kernels(cuda, dtype):
    """K8 and K9 under grad on the card: outputs with a ``grad_fn`` whose
    backward launches K8' and K9' once each, matching the plain backward."""
    case = CONV_CASES[1]
    x, w, bias, dy = _conv_inputs(case, dtype, cuda, seed=2)
    leaves = [x.detach().clone().requires_grad_(), w.clone().requires_grad_()]
    fwd, bwd = k8.launches, k8.launches_bwd
    y = k8.conv1d_causal(*leaves, act=case[5])
    assert y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    assert (k8.launches - fwd, k8.launches_bwd - bwd) == (1, 1)
    exp = k8.conv1d_causal_bwd_plain(x, w, dy, act=case[5])
    for t, e in zip(leaves, exp):
        assert _rel(t.grad, e) <= KERNEL_TOL[dtype]

    case = MOE_CASES[1]
    tokens, weights, tile_eid, dout = _moe_inputs(case, dtype, cuda, seed=3)
    leaves = [tokens.clone().requires_grad_(), weights.clone().requires_grad_()]
    fwd, bwd = k9.launches, k9.launches_bwd
    out = k9.moe_gmm(*leaves, tile_eid, bm=case[4])
    assert out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert (k9.launches - fwd, k9.launches_bwd - bwd) == (1, 1)
    exp = k9.moe_gmm_bwd_plain(tokens, weights, tile_eid, dout, bm=case[4])
    for t, e in zip(leaves, exp):
        assert _rel(t.grad, e) <= KERNEL_TOL[dtype]


def test_bwd_wrappers_reject_what_they_do_not_take(cuda):
    x, w, bias, dy = _conv_inputs(CONV_CASES[1], torch.float32, cuda)
    with pytest.raises(ValueError):                  # dy not contiguous
        k8.conv1d_causal_bwd(x, w, dy.transpose(0, 1).contiguous()
                             .transpose(0, 1), act="none")
    with pytest.raises(ValueError):
        k8.conv1d_causal_bwd(x.double(), w.double(), dy.double())
    tokens, weights, tile_eid, dout = _moe_inputs(MOE_CASES[1],
                                                  torch.float32, cuda)
    with pytest.raises(ValueError):
        k9.moe_gmm_bwd(tokens, weights, tile_eid, dout[:, :5], bm=64)
    with pytest.raises(ValueError):
        k9.moe_gmm_bwd(tokens, weights, tile_eid, dout.bfloat16(), bm=64)
