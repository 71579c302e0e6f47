"""The port's SGD training step on the CPU against the JAX package's
``GxM(impl="xla").sgd_train_step``, on shared params (the layout of the
reference's ``GxM.init``, filled in numpy) and one numpy batch.

Limits, the reference's own (``tests/test_train_cnn.py``): the loss
rtol 1e-5; every leaf of the new params rtol 1e-4, atol 1e-5.

ReLU has a kink: a pre-activation within about 1e-7 of zero can fall on
either side of it under f32 sums in another order, and then that pixel's
whole gradient moves.  The batch seed is one where no pre-activation of
either net comes closer to zero than 2e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticImageData as JaxSyntheticImageData
from repro.graph import GxM as JaxGxM
from repro.graph import inception_v3 as jax_inception_v3
from repro.graph import resnet50 as jax_resnet50
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.graph import GxM, inception_v3, resnet50
from repro_torch.graph.executor import apply_bn_updates
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.launch import train_cnn
from repro_torch.train.step import make_cnn_train_step

from test_torch_executor import _reference_params

LR = 0.1
NETS = {
    # name: (port topology, reference topology, image size, batch)
    "resnet50": (lambda: resnet50(10, stages=(1, 1, 1, 1)),
                 lambda: jax_resnet50(10, stages=(1, 1, 1, 1)), 64, 4),
    "inception_v3": (lambda: inception_v3(10),
                     lambda: jax_inception_v3(10), 48, 4),
}


def _batch(image, batch, seed=5):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((batch, image, image, 3)).astype(
                np.float32),
            "label": rng.integers(0, 10, size=(batch,)).astype(np.int32)}


@pytest.fixture(scope="module", params=list(NETS))
def stepped(request):
    """One SGD step of each side from the same params and batch, the
    reference's step jitted once per net."""
    ours_nl, ref_nl, image, n = NETS[request.param]
    ref = JaxGxM(ref_nl(), impl="xla", num_classes=10)
    tree = _reference_params(ref)
    batch = _batch(image, n)
    exp, exp_loss = jax.jit(ref.sgd_train_step, static_argnums=(2,))(
        {name: {k: jnp.asarray(v) for k, v in p.items()}
         for name, p in tree.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, LR)
    ours = GxM(ours_nl(), device="cpu", num_classes=10)
    params = params_from_jax(tree, device="cpu")
    got, got_loss = ours.sgd_train_step(
        params, {"image": torch.from_numpy(batch["image"]),
                 "label": torch.from_numpy(batch["label"])}, LR)
    return dict(tree=tree, params=params, got=got, got_loss=got_loss,
                exp=jax.device_get(exp), exp_loss=float(exp_loss))


def test_loss_matches_reference(stepped):
    np.testing.assert_allclose(float(stepped["got_loss"]),
                               stepped["exp_loss"], rtol=1e-5)


def test_every_leaf_matches_reference(stepped):
    got, exp = stepped["got"], stepped["exp"]
    assert got.keys() == exp.keys()
    for name, p in exp.items():
        assert got[name].keys() == p.keys(), name
        for leaf, v in p.items():
            np.testing.assert_allclose(got[name][leaf].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}.{leaf}")


def test_step_moves_weights_and_running_stats(stepped):
    """Every conv weight and the running statistics moved; the input tree
    is untouched (the step is not in place)."""
    got, tree, params = stepped["got"], stepped["tree"], stepped["params"]
    for name, p in tree.items():
        for leaf, v in p.items():
            np.testing.assert_array_equal(params[name][leaf].numpy(), v)
            assert not got[name][leaf].requires_grad
        if "w" in p:
            assert not np.array_equal(got[name]["w"].numpy(), p["w"]), name
        if "mean" in p:
            assert not np.array_equal(got[name]["mean"].numpy(), p["mean"])


def test_unfused_bn_step_matches_reference():
    """fuse=False: BN as tasks of its own, batch statistics there."""
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 fuse=False, num_classes=10)
    tree = _reference_params(ref)
    batch = _batch(64, 4)
    exp, exp_loss = jax.jit(ref.sgd_train_step, static_argnums=(2,))(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, batch), LR)
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu", fuse=False,
               num_classes=10)
    got, loss = ours.sgd_train_step(
        params_from_jax(tree, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    np.testing.assert_allclose(float(loss), float(exp_loss), rtol=1e-5)
    for name, p in jax.device_get(exp).items():
        for leaf, v in p.items():
            np.testing.assert_allclose(got[name][leaf].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}.{leaf}")


def test_forward_defaults_to_training_as_the_reference():
    """``forward(params, x)`` normalises with batch statistics in both
    packages (``train=True`` is the default), and ``collect_stats`` returns
    the batch statistics."""
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 num_classes=10)
    tree = _reference_params(ref)
    x = _batch(32, 2)["image"]
    exp = ref.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10)
    params = params_from_jax(tree, device="cpu")
    out = ours.forward(params, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp),
                               rtol=1e-4, atol=1e-4)
    out2, stats = ours.forward(params, torch.from_numpy(x),
                               collect_stats=True)
    assert torch.equal(out, out2)
    convs_with_bn = {t.name for t in ours.etg.tasks if t.op == "conv"
                     and any(kind == "bn" for kind, _ in t.fused)}
    assert set(stats) == convs_with_bn
    inferred = ours.infer(params, torch.from_numpy(x))
    assert not torch.allclose(out, inferred)


def test_bn_stats_are_population_statistics():
    """The running update takes the population variance (``jnp.var``), not
    torch's unbiased default."""
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 3, 4)).astype(np.float32))
    params = {"bn": {"mean": torch.zeros(4), "var": torch.ones(4)}}
    from repro_torch.graph.executor import _batch_stats
    mu, var = _batch_stats(y)
    apply_bn_updates(params, {"bn": (mu, var)}, 0.9)
    flat = y.reshape(-1, 4).numpy()
    np.testing.assert_allclose(params["bn"]["var"].numpy(),
                               0.9 + 0.1 * flat.var(axis=0), rtol=1e-6)
    np.testing.assert_allclose(params["bn"]["mean"].numpy(),
                               0.1 * flat.mean(axis=0), rtol=1e-5, atol=1e-7)


def test_make_cnn_train_step_is_the_plain_step():
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10)
    params = ours.init()
    batch = _batch(32, 2)
    got, loss = make_cnn_train_step(ours, lr=LR)(params, batch)
    exp, exp_loss = ours.sgd_train_step(
        params, {"image": torch.from_numpy(batch["image"]),
                 "label": torch.from_numpy(batch["label"]).long()}, LR)
    assert float(loss) == float(exp_loss)
    for name, p in exp.items():
        for leaf, v in p.items():
            assert torch.equal(got[name][leaf], v), (name, leaf)


def test_synthetic_data_matches_reference():
    ours = SyntheticImageData(hw=8, n_classes=10, global_batch=4, seed=7)
    theirs = JaxSyntheticImageData(hw=8, n_classes=10, global_batch=4,
                                   seed=7)
    for step in (0, 3):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for key in ("image", "label"):
            np.testing.assert_array_equal(a[key], b[key])


def test_train_cnn_runs_on_the_cpu_without_kernel_launches(capsys):
    k1.launches = k2.launches = 0
    losses = train_cnn.main(["--device", "cpu", "--steps", "2", "--batch",
                             "4"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert k1.launches == 0 and k2.launches == 0
    out = capsys.readouterr().out
    assert "step   1  loss=" in out and "accuracy" in out


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        train_cnn.build_trainer(full=False)
    with pytest.raises(RuntimeError, match="no GPU"):
        train_cnn.main(["--steps", "1"])
