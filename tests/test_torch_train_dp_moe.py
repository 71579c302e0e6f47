"""An MoE config's data-parallel LM step: smoke ``phi3.5-moe-42b-a6.6b``
on two gloo CPU ranks (the host mesh's data group), each on its half of
the batch with unequal label masks, against the reference's single-device
step on the whole batch (``jax.value_and_grad(T.lm_loss, impl="xla")``
inside its ``make_train_step``).  Under the group the router's
load-balance statistics (``me``, ``ce``) are the whole batch's and the
z-loss each rank's share (``nn.moe.data_group``), so the two steps are the
same function: the loss within 1e-5 relative, the gradient norm 1e-4 and
each leaf within 1e-4 of its own max |update| (the limits of
``tests/test_torch_train_dp_lm.py``, AdamW at eps 1e-3), with the params
held whole and ZeRO-3 (the config is ``fsdp``).  A config holding a share
of its experts raises under the group."""
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

ARCH = "phi3.5-moe-42b-a6.6b"
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-4
LR = 1e-2


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, v in tree.items():
            out.update(_flat(v, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("zero3", [False, True], ids=["whole", "zero3"])
def test_moe_dp_step_matches_the_reference_full_batch(tmp_path, zero3):
    cfg = jax_smoke_config(jax_get_config(ARCH))
    assert cfg.moe is not None and cfg.fsdp
    jp = jax.device_get(jax.jit(
        lambda key: jax_T.init_lm(key, cfg)[0])(jax.random.PRNGKey(0)))
    opt = JaxAdamW(eps=1e-3)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (4, 12))
    labels = rng.integers(0, cfg.vocab, (4, 12))
    labels[:2, :8] = -1                  # rank 0 keeps 8 labels, rank 1 24
    batch = {"tokens": toks, "labels": labels}
    state = {"params": jax.tree.map(jnp.asarray, jp),
             "opt": opt.init(jax.tree.map(jnp.asarray, jp)),
             "step": jnp.zeros((), jnp.int32)}
    new, m = jax.jit(jax_step.make_train_step(
        cfg, opt, lr=LR, clip=1.0, impl="xla"))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    exp, p0 = _flat(jax.device_get(new["params"])), _flat(jp)
    results = spawn("moe_dp_rank", 2, tmp_path, arch=ARCH, tree=jp,
                    batch=batch, lr=LR, zero3=zero3)
    for res in results:
        assert abs(res["loss"] - float(m["loss"])) \
            <= LOSS_TOL * float(m["loss"])
        assert abs(res["grad_norm"] - float(m["grad_norm"])) \
            <= 1e-4 * float(m["grad_norm"])
        for name, leaf in _flat(res["params"]).items():
            upd = np.abs(np.asarray(exp[name]) - np.asarray(p0[name])).max()
            assert np.abs(leaf - np.asarray(exp[name])).max() \
                <= UPDATE_TOL * upd, name
        assert "expert_share" in res["share_error"], res["share_error"]
    for name, leaf in _flat(results[0]["params"]).items():
        assert np.array_equal(leaf, _flat(results[1]["params"])[name])
