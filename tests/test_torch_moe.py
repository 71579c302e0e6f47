"""The port's MoE layer (``repro_torch.nn.moe``) on the CPU against the
reference's ``repro.nn.moe`` on the same numpy inputs and params: the full
expert share, the shares of expert parallelism summed, the aux losses on
every share, the drop order under forced overflow, several dispatch groups,
bf16, and ``convert.take_expert_share``.

Params are the reference's ``moe.init`` on ``smoke_config`` (d_model 64,
d_ff 128, 4 experts, top-2), carried across by ``params_from_jax``.
Tolerances: f32 max |diff| <= 1e-5 * max |ref| (the same einsums, summed
in another order), aux losses rtol 1e-5; bf16 2e-2 * max |ref| (bf16
intermediates rounded at other places, as in ``tests/test_decode_parity.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.nn import moe as jax_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, take_expert_share, to_tensor
from repro_torch.nn import moe

ARCHS = ["jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b"]
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _cfgs(arch="jamba-1.5-large-398b", dtype="float32", **moe_kw):
    cfg_t = dataclasses.replace(smoke_config(get_config(arch)), dtype=dtype)
    cfg_j = dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                                dtype=dtype)
    return (dataclasses.replace(cfg_t, moe=dataclasses.replace(
                cfg_t.moe, **moe_kw)),
            dataclasses.replace(cfg_j, moe=dataclasses.replace(
                cfg_j.moe, **{k: v for k, v in moe_kw.items()
                              if k != "expert_share"})))


def _share(cfg, index, count):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_share=(index, count)))


def _rel(out, exp) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    exp = np.asarray(exp, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - exp).max()
                 / np.abs(exp).max())


def _x(seed, b, l, d, dtype="float32"):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(
        (b, l, d)).astype(np.float32), dtype)


def _run(jp, cfg_t, x, share=None):
    """The port's layer on the share ``(index, count)`` of ``jp``."""
    cfg = cfg_t if share is None else _share(cfg_t, *share)
    tp = params_from_jax(take_expert_share(jp, cfg, axis=0), "cpu")
    return moe.apply(tp, cfg, to_tensor(np.asarray(x), "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,l", [(2, 16), (1, 13), (1, 1024), (3, 1)])
def test_moe_full_share_matches_reference(arch, b, l):
    """(1, 1024): two dispatch groups of 512 with drops; (1, 13): one group
    of 13; (3, 1): decode's groups of one token."""
    cfg_t, cfg_j = _cfgs(arch)
    jp, _ = jax_moe.init(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    x = _x(b * l, b, l, cfg_j.d_model)
    exp, aux_e = jax_moe.apply(jp, cfg_j, x)
    out, aux = _run(jp, cfg_t, x)
    assert out.shape == (b, l, cfg_t.d_model)
    assert _rel(out, exp) <= F32_TOL
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(aux_e[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("count", [2, 4])
def test_moe_shares_sum_to_the_full_layer(count):
    """Expert parallelism over ``count`` devices: each share's output is its
    experts' part, the parts sum to the reference's whole layer, and every
    share computes the same aux losses."""
    cfg_t, cfg_j = _cfgs()
    jp, _ = jax_moe.init(jax.random.PRNGKey(1), cfg_j, jnp.float32)
    x = _x(1, 2, 1024, cfg_j.d_model)
    exp, aux_e = jax_moe.apply(jp, cfg_j, x)
    parts = [_run(jp, cfg_t, x, (i, count)) for i in range(count)]
    total = sum(out for out, _ in parts)
    assert _rel(total, exp) <= F32_TOL
    for out, aux in parts:
        assert 0 < _rel(out, exp)          # a share is not the whole layer
        for name in ("lb_loss", "z_loss"):
            np.testing.assert_allclose(float(aux[name]),
                                       float(aux_e[name]), rtol=1e-5)


def test_moe_forced_overflow_drops_in_the_reference_order():
    """Every token's first choice is expert 0, so slot 0 fills expert 0's
    capacity of int(1.25 * 16 * 2 / 4) = 10 and drops the rest of the group
    in token order; the same tokens are dropped on both sides."""
    cfg_t, cfg_j = _cfgs()
    jp, _ = jax_moe.init(jax.random.PRNGKey(2), cfg_j, jnp.float32)
    rng = np.random.default_rng(2)
    router = rng.standard_normal(jp["router"].shape) * 0.01
    router[0, 0] = 10.0
    jp["router"] = jnp.asarray(router, jnp.float32)
    x = np.array(_x(2, 2, 16, cfg_j.d_model))
    x[..., 0] = 1.0 + np.abs(x[..., 0]) * 0.1     # logit 0 wins everywhere
    x = jnp.asarray(x)
    exp, _ = jax_moe.apply(jp, cfg_j, x)
    out, _ = _run(jp, cfg_t, x)
    assert _rel(out, exp) <= F32_TOL
    # the same inputs with room for every token: only the dropped tail moves
    roomy_t, roomy_j = _cfgs(capacity_factor=16.0)
    dropless, _ = _run(jp, roomy_t, x)
    moved = (out - dropless).abs().amax(dim=-1) > 1e-6       # (B, L)
    assert not moved[:, :10].any() and moved[:, 10:].all()
    assert _rel(dropless, jax_moe.apply(jp, roomy_j, x)[0]) <= F32_TOL


def test_moe_bf16_matches_reference():
    cfg_t, cfg_j = _cfgs(dtype="bfloat16")
    jp, _ = jax_moe.init(jax.random.PRNGKey(3), cfg_j, jnp.bfloat16)
    x = _x(3, 2, 16, cfg_j.d_model, "bfloat16")
    exp, _ = jax_moe.apply(jp, cfg_j, x)
    out, _ = _run(jp, cfg_t, x)
    assert out.dtype == torch.bfloat16
    assert _rel(out, exp) <= BF16_TOL


def test_moe_init_draws_the_held_experts_at_the_published_scale():
    """A share's init holds E / count experts of each stacked weight, drawn
    with the reference's std E^-1/2 (its fan-in is the stacked E axis)."""
    cfg = _share(dataclasses.replace(
        smoke_config(get_config("jamba-1.5-large-398b")), d_model=256,
        d_ff=512), 1, 2)
    p = moe.init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    e = cfg.moe.n_experts
    assert p["router"].shape == (cfg.d_model, e)
    assert p["w_gate"].shape == (e // 2, cfg.d_model, cfg.d_ff)
    assert p["w_down"].shape == (e // 2, cfg.d_ff, cfg.d_model)
    for name in ("w_gate", "w_up", "w_down"):
        assert abs(float(p[name].std()) - e ** -0.5) < 0.01
    assert abs(float(p["router"].std()) - cfg.d_model ** -0.5) < 0.01


def test_expert_share_bounds_and_take_expert_share():
    cfg = get_config("jamba-1.5-large-398b-1chip")
    assert cfg.moe.n_experts == 16 and cfg.moe.held_experts() == (0, 8)
    assert _share(cfg, 1, 2).moe.held_experts() == (8, 16)
    assert get_config("jamba-1.5-large-398b").moe.held_experts() == (0, 16)
    for bad in ((2, 2), (0, 3), (0, 0)):
        with pytest.raises(ValueError, match="expert_share"):
            _share(cfg, *bad).moe.held_experts()
    tree = {"embed": np.zeros(3),
            "blocks": {"1": {"mlp": {"router": np.zeros((2, 4, 16)),
                                     "w_gate": np.arange(16)[None, :, None]
                                     .repeat(2, 0)}},
                       "0": {"mlp": {"w_gate": np.zeros((2, 4, 8))}}}}
    tree["blocks"]["1"]["mlp"]["w_up"] = tree["blocks"]["1"]["mlp"]["w_gate"]
    tree["blocks"]["1"]["mlp"]["w_down"] = tree["blocks"]["1"]["mlp"]["w_gate"]
    cut = take_expert_share(tree, _share(cfg, 1, 2))
    assert cut["blocks"]["1"]["mlp"]["w_gate"][0, :, 0].tolist() == \
        list(range(8, 16))
    assert cut["blocks"]["1"]["mlp"]["router"].shape == (2, 4, 16)
    assert cut["blocks"]["0"]["mlp"]["w_gate"].shape == (2, 4, 8)  # dense
    assert cut["embed"] is tree["embed"]
