"""ZeRO-3 / FSDP training over a data group (``train/fsdp.py``,
``train.step.make_train_step(shardings=)``) on two gloo CPU ranks through
the host mesh (``launch.mesh.make_host_mesh``): smoke ``qwen3-8b`` and a
factored-AdamW config (smoke ``dbrx-132b`` at d_model 128, d_ff 256, so
its embedding, head and expert weights take the factored second moment,
split along their last dim and along their second-last), and smoke
``qwen3-8b`` under remat, whose recompute gathers each repeat's blocks
again in the backward.

Held: the ZeRO-3 step equals the whole-parameter data-parallel step within
1e-6 of max |update| at lr 1.0 (the same gradient bits, a norm and the
factored means summed in another order; at a small lr one ulp of a
param's rounding would read more than that), and at lr 1e-2 the
reference's single-device step on the whole batch
(``jax.value_and_grad(T.lm_loss, impl="xla")`` inside its
``make_train_step``) at the limits of ``tests/test_torch_train_dp_lm.py``
(loss 1e-5 relative, gradient norm 1e-4, each leaf within 1e-4 of its own
max |update|, AdamW at eps 1e-3); each rank holds at most 0.55 of the
whole state's bytes; a checkpoint the ZeRO-3 ranks write restores into
the whole state and back into the slices bit for bit, and a whole state's
checkpoint into the slices; the step gathers each split leaf where the
forward reads it (a repeat's blocks twice under remat) and reduces each
leaf's gradient once.  Then the trainer under ZeRO-3 on two ranks,
uninterrupted and under seeded chaos."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _dp_ranks import spawn
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.nn import transformer as jax_T
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import step as jax_step

ZERO3_TOL = 1e-6
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-4
HELD_SHARE = 0.55
LR = 1e-2
CASES = {"qwen3-8b": ("qwen3-8b", {}, False),
         "qwen3-8b-remat": ("qwen3-8b", {"remat": True}, False),
         "dbrx-132b": ("dbrx-132b", {"d_model": 128, "d_ff": 256}, True)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, v in tree.items():
            out.update(_flat(v, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero3_step_matches_dp_and_the_reference(case, tmp_path):
    import dataclasses
    arch, widths, factored = CASES[case]
    cfg = dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                              **widths)
    assert cfg.fsdp and cfg.factored_opt == factored
    jp = jax.device_get(jax.jit(
        lambda key: jax_T.init_lm(key, cfg)[0])(jax.random.PRNGKey(0)))
    opt = JaxAdamW(eps=1e-3, factored=factored)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (4, 10))
    labels = rng.integers(0, cfg.vocab, (4, 10))
    labels[:2, :7] = -1                      # unequal halves
    batch = {"tokens": toks, "labels": labels}
    state = {"params": jax.tree.map(jnp.asarray, jp),
             "opt": opt.init(jax.tree.map(jnp.asarray, jp)),
             "step": jnp.zeros((), jnp.int32)}
    new, m = jax.jit(jax_step.make_train_step(
        cfg, opt, lr=LR, clip=1.0, impl="xla"))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    exp, p0 = _flat(jax.device_get(new["params"])), _flat(jp)
    results = spawn("fsdp_rank", 2, tmp_path, arch=arch, widths=widths,
                    tree=jp, batch=batch, lr=LR, factored=factored,
                    ckpt_dir=str(tmp_path / "ckpt"))
    for res in results:
        # qwen3's qk-norm scales have no "embed" axis: held whole, counted
        # once in the clip
        assert res["sharded_leaves"] > 0
        assert res["whole_leaves"] > 0 or arch != "qwen3-8b"
        assert res["held_bytes"] <= HELD_SHARE * res["whole_bytes"], \
            (res["held_bytes"], res["whole_bytes"])
        assert res["calls"] == res["expected_calls"], res["calls"]
        assert res["ckpt_zero3_bits"] and res["ckpt_whole_bits"] \
            and res["ckpt_into_slices_bits"]
        assert res["loss"] == res["dp_loss"]
        assert abs(res["grad_norm"] - res["dp_grad_norm"]) \
            <= 1e-6 * res["dp_grad_norm"]
        got, dp = _flat(res["params"]), _flat(res["dp_params"])
        max_upd = max(np.abs(dp[k] - np.asarray(p0[k])).max() for k in dp)
        for k in dp:
            assert np.abs(got[k] - dp[k]).max() <= ZERO3_TOL * max_upd, k
        assert res["lr_loss"] == res["loss"]
        assert abs(res["lr_loss"] - float(m["loss"])) \
            <= LOSS_TOL * float(m["loss"])
        assert abs(res["lr_grad_norm"] - float(m["grad_norm"])) \
            <= 1e-4 * float(m["grad_norm"])
        for name, leaf in _flat(res["lr_params"]).items():
            upd = np.abs(np.asarray(exp[name]) - np.asarray(p0[name])).max()
            assert np.abs(leaf - np.asarray(exp[name])).max() \
                <= UPDATE_TOL * upd, name
    for key in ("params", "lr_params"):
        for name, leaf in _flat(results[0][key]).items():
            assert np.array_equal(leaf, _flat(results[1][key])[name])


def test_trainer_trains_zero3_on_two_ranks(tmp_path):
    """``launch.train.main`` on the host mesh of two ranks with a
    ``cfg.fsdp`` config: ZeRO-3, each rank's held bytes at most 0.55 of
    the whole state's, both ranks' final params the same, and a chaos
    replay (checkpoints of the gathered state by rank 0, restored into
    slices) ending on the uninterrupted run's params bit for bit."""
    argv = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps",
            "8", "--seq-len", "16", "--global-batch", "4", "--lr", "1e-3",
            "--ckpt-every", "2", "--chaos-seed", "15"]
    results = spawn("trainer_rank", 2, tmp_path, argv=argv)
    for res in results:
        for run in ("clean", "chaos"):
            s = res[run]
            assert s["zero3"] and s["ranks_agree"], s
            assert s["held_bytes"] <= HELD_SHARE * s["whole_state_bytes"]
        assert res["chaos"]["params_crc32"] == res["clean"]["params_crc32"]
        assert res["chaos"]["resilience"]["restarts"] >= 1


def test_adamw_updates_a_large_leaf_in_chunks_with_the_same_bits(
        monkeypatch):
    """AdamW's elementwise update takes a leaf larger than ``CHUNK`` in
    slices (one slice's f32 temporaries at a time): the same params and
    slots, bit for bit, as the whole leaf at once."""
    import torch

    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((300, 70), generator=gen),
              "b": torch.randn((50,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    opt = adamw.AdamW()
    runs = []
    for chunk in (adamw.CHUNK, 1000):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        s = opt.init(p)
        for _ in range(3):
            opt.update(grads, s, p, 1e-2)
        runs.append((p, s))
    (p1, s1), (p2, s2) = runs
    for k in params:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["mu"][k]["m"], s2["mu"][k]["m"])
        assert torch.equal(s1["mu"][k]["v"], s2["mu"][k]["v"])
