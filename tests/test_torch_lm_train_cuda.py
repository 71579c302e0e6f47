"""LM training on the card: K7's backward kernel against its plain version,
the attention gradient through autograd, the wrappers that have no
backward refusing inputs that require grad, a reduced f32 train step and
RWKV-6 card against CPU, and a hybrid step that must raise.

These need an NVIDIA GPU with the CUDA toolkit (``nvcc``): a CUDA kernel has
no CPU mode, so elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_train_cuda.py
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as k7

pytestmark = pytest.mark.gpu

KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LOSS_REL_TOL = 1e-4
UPDATE_REL_TOL = 1e-3

# b, hq, hkv, l, dh, causal: GQA with a ragged L at Qwen2-1.5B's Dh, and a
# non-causal smoke-width case with one query head a KV head
BWD_CASES = [(2, 6, 2, 333, 128, True), (1, 4, 4, 77, 16, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


def _qkv(case, dtype, dev, seed=0):
    b, hq, hkv, l, dh, _ = case
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    return rnd(b, hq, l, dh), rnd(b, hkv, l, dh), rnd(b, hkv, l, dh), \
        rnd(b, hq, l, dh)


def _rel(out, exp) -> float:
    return float((out.float() - exp.float()).abs().max()
                 / exp.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    causal = case[-1]
    q, k, v, do = _qkv(case, dtype, cuda)
    o = k7.flash_attention(q, k, v, causal=causal)
    before = k7.launches_bwd
    got = k7.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert k7.launches_bwd == before + 1
    exp = k7.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    for name, a, e in zip(("dq", "dk", "dv"), got, exp):
        assert a.dtype == dtype and a.shape == e.shape
        assert _rel(a, e) <= KERNEL_TOL[dtype], (name, _rel(a, e))
    again = k7.flash_attention_bwd(q, k, v, o, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_autograd_on_card_runs_the_backward_kernel(cuda):
    case = (1, 6, 2, 200, 64, True)
    q, k, v, do = _qkv(case, torch.float32, cuda, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = k7.launches, k7.launches_bwd
    out = k7.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert (k7.launches - fwd, k7.launches_bwd - bwd) == (1, 1)
    exp = k7.flash_attention_bwd_plain(q, k, v, out.detach(), do,
                                       causal=True)
    for t, e in zip(leaves, exp):
        assert _rel(t.grad, e) <= KERNEL_TOL[torch.float32]


def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    q, k, v, do = _qkv((1, 2, 2, 8, 64, True), torch.float32, cuda)
    o = k7.flash_attention(q, k, v)
    with pytest.raises(ValueError):
        k7.flash_attention_bwd(q.double(), k.double(), v.double(),
                               o.double(), do.double())
    with pytest.raises(ValueError):
        k7.route_bwd(q[..., :48], k[..., :48], v[..., :48])


def test_wrappers_without_backward_refuse_grad(cuda):
    from repro_torch.kernels import conv1d_causal as k8
    from repro_torch.kernels import matmul_fused as k6
    from repro_torch.kernels import moe_gmm as k9
    a = torch.randn(64, 64, device=cuda, requires_grad=True)
    b = torch.randn(64, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="item 14"):
        k6.matmul_fused(a, b)
    x = torch.randn(1, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        k8.conv1d_causal(x, torch.randn(4, 64, device=cuda))
    tid = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="item 14"):
        k9.moe_gmm(a, b[None], tid, bm=64)
    with torch.no_grad():
        k6.matmul_fused(a, b)


def _chip_smoke():
    """``chip_smoke.py``, whose ``Sgd`` and ``twin_step`` phases 29 and 30
    hold the card against the CPU with."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _twin_step(cfg, batch, *, accum_steps=1, bonus=False):
    """One train step of ``cfg`` (f32) on the card and on the CPU from the
    same params (drawn on the CPU), through ``chip_smoke.twin_step`` with
    its SGD at lr 1 (an update far above one f32 ulp of the params):
    (loss card, loss CPU, max |update diff| / max |CPU update|)."""
    from repro_torch.nn import transformer as T
    from repro_torch.optim.adamw import tree_leaves

    smoke = _chip_smoke()
    base = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    if bonus:
        smoke._draw_bonus(base, cfg)
    twins = smoke.twin_step(cfg, base, batch, smoke.Sgd(),
                            lr=smoke.PARITY_LR, accum_steps=accum_steps)
    (m_g, new_g), (m_c, new_c) = twins["card"], twins["cpu"]
    upd = max(float((c.detach() - b).abs().max())
              for c, b in zip(tree_leaves(new_c), tree_leaves(base)))
    diff = max(float((g.detach().cpu() - c.detach()).abs().max())
               for g, c in zip(tree_leaves(new_g), tree_leaves(new_c)))
    return m_g["loss"], m_c["loss"], diff / upd


def _reduced(arch, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=2, vocab=512,
                               dtype="float32", **kw)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_reduced_train_step_card_vs_cpu(cuda, accum_steps):
    from repro_torch.data import SyntheticLMData
    cfg = _reduced("qwen2-1.5b", d_model=256, n_heads=4, n_kv_heads=2,
                   d_head=64, d_ff=512)
    batch = SyntheticLMData(cfg.vocab, 64, 4).batch_at(0)
    before = k7.launches_bwd
    loss_g, loss_c, rel = _twin_step(cfg, batch, accum_steps=accum_steps)
    assert k7.launches_bwd - before == 2 * accum_steps   # 2 layers
    assert abs(loss_g - loss_c) <= LOSS_REL_TOL * abs(loss_c)
    assert rel <= UPDATE_REL_TOL


def test_rwkv_reduced_card_vs_cpu(cuda):
    """Forward logits and decode against the CPU, and one training step."""
    from repro_torch.convert import params_to
    from repro_torch.data import SyntheticLMData
    from repro_torch.nn import transformer as T
    cfg = _reduced("rwkv6-1.6b", d_model=256, n_heads=4, n_kv_heads=4,
                   d_head=64, d_ff=512)
    params = T.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 70)))
    exp, _, cache_c = T.forward(params, cfg, tokens=toks[:, :-1],
                                return_cache=True)
    gpu = params_to(params, cuda)
    out, _, cache_g = T.forward(gpu, cfg, tokens=toks[:, :-1].to(cuda),
                                return_cache=True)
    scale = float(exp.abs().max())
    assert float((out.cpu() - exp).abs().max()) <= 1e-4 * scale
    assert torch.equal(out[:, -1].argmax(-1).cpu(), exp[:, -1].argmax(-1))
    dec_c, _ = T.decode_step(params, cfg, toks[:, -1:], cache_c, 69)
    dec_g, _ = T.decode_step(gpu, cfg, toks[:, -1:].to(cuda), cache_g, 69)
    assert float((dec_g.cpu() - dec_c).abs().max()) <= 1e-4 * scale
    batch = SyntheticLMData(cfg.vocab, 80, 2).batch_at(0)
    loss_g, loss_c, rel = _twin_step(cfg, batch, bonus=True)
    assert abs(loss_g - loss_c) <= LOSS_REL_TOL * abs(loss_c)
    assert rel <= UPDATE_REL_TOL


def test_hybrid_train_step_raises_on_the_card(cuda):
    """Jamba's Mamba (K8) and MoE (K9) kernels have no backward: a step on
    the card raises instead of losing their gradients."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import build
    cfg = smoke_config(get_config("jamba-1.5-large-398b"))
    state, step = build(cfg, device=cuda)
    batch = SyntheticLMData(cfg.vocab, 16, 2).batch_at(0)
    with pytest.raises(NotImplementedError, match="item 14"):
        step(state, batch)
