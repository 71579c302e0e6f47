"""The port's data-parallel LM step (``train.step.make_train_step(group=)``)
over two CPU ranks (gloo, one process a rank), each on its half of the
batch, against the reference's single-device step on the whole batch
(``jax.value_and_grad(T.lm_loss, impl="xla")`` inside its
``make_train_step``): the loss is the mean over every unmasked label of
the group's batch, as the reference's is over the whole batch, and its
gradients are reduced before the global-norm clip and AdamW, so the two
steps are the same function, with the halves' masks equal or not.  An MoE
config raises under a group.  Tolerances: those of the CPU train-step test
(``tests/test_torch_lm_train.py``): the loss within 1e-5 relative, the
gradient norm 1e-4, the params within 1e-4 of each leaf's max |update|,
with AdamW at eps 1e-3 for the reason given there."""
import jax
import jax.numpy as jnp
import numpy as np

from _dp_ranks import spawn
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.nn import transformer as jax_T
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import step as jax_step

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


def _check_against_the_reference(tmp_path, labels_of, **rank_args):
    arch = "qwen2-1.5b"
    cfg = jax_smoke_config(jax_get_config(arch))
    jp = jax.device_get(jax.jit(
        lambda key: jax_T.init_lm(key, cfg)[0])(jax.random.PRNGKey(0)))
    opt = JaxAdamW(eps=1e-3)
    opt_state = jax.device_get(opt.init(jp))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (4, 10))
    labels = labels_of(rng.integers(0, cfg.vocab, (4, 10)))
    batch = {"tokens": toks, "labels": labels}
    state = {"params": jax.tree.map(jnp.asarray, jp),
             "opt": jax.tree.map(jnp.asarray, opt_state),
             "step": jnp.zeros((), jnp.int32)}
    step = jax_step.make_train_step(cfg, opt, lr=LR, clip=1.0, impl="xla")
    new, m = jax.jit(step)(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    exp, p0 = _flat(jax.device_get(new["params"])), _flat(jp)
    results = spawn("lm_step_rank", 2, tmp_path, arch=arch, tree=jp,
                    opt_state=opt_state, batch=batch, lr=LR, **rank_args)
    for res in results:
        assert abs(res["loss"] - float(m["loss"])) \
            <= LOSS_TOL * float(m["loss"])
        assert abs(res["grad_norm"] - float(m["grad_norm"])) \
            <= 1e-4 * float(m["grad_norm"])
        for name, leaf in _flat(res["params"]).items():
            upd = np.abs(np.asarray(exp[name]) - np.asarray(p0[name])).max()
            assert np.abs(leaf - np.asarray(exp[name])).max() \
                <= UPDATE_TOL * upd, name
    # both ranks hold the same params after the step
    for name, leaf in _flat(results[0]["params"]).items():
        assert np.array_equal(leaf, _flat(results[1]["params"])[name])
    return results


def test_dp_lm_step_matches_the_reference_full_batch(tmp_path):
    def labels_of(labels):
        labels[:, :2] = -1
        return labels
    _check_against_the_reference(tmp_path, labels_of)


def test_dp_lm_step_with_unequal_masks_matches_the_reference(tmp_path):
    """Rank 0's half keeps 6 labels, rank 1's 18: a mean of the ranks'
    means would weight rank 0's tokens three times as much as the
    reference does.  The same ranks then refuse an MoE config."""
    def labels_of(labels):
        labels[:2, :7] = -1
        labels[2:, :1] = -1
        return labels
    results = _check_against_the_reference(tmp_path, labels_of,
                                            moe_arch="phi3.5-moe-42b-a6.6b")
    for res in results:
        assert "MoE" in res["moe_error"], res["moe_error"]
