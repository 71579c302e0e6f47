"""The port's GxM inference forward against the JAX package's on shared
params in the layout of the reference's ``GxM(impl="xla").init``, with
random BN leaves, carried over with ``params_from_jax``.  rtol = atol = 1e-4: some fifty f32 layers, summed in
different orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import GxM as JaxGxM
from repro.graph import inception_v3 as jax_inception_v3
from repro.graph import resnet50 as jax_resnet50
from repro.graph.executor import _maxpool as jax_maxpool
from repro_torch.convert import params_from_jax
from repro_torch.graph import GxM, inception_v3, resnet50
from repro_torch.graph.executor import _maxpool

TOL = dict(rtol=1e-4, atol=1e-4)

NETS = {
    # name: (port topology, reference topology, image size)
    "resnet50": (lambda: resnet50(10, stages=(1, 1, 1, 1)),
                 lambda: jax_resnet50(10, stages=(1, 1, 1, 1)), 32),
    "inception_v3": (lambda: inception_v3(10),
                     lambda: jax_inception_v3(10), 48),
}


def _reference_params(ref, seed=0):
    """A params tree in the layout of the reference's ``GxM.init`` (read
    with ``jax.eval_shape``, so no random op compiles), filled in numpy:
    He-normal conv weights, LeCun-normal fc, and random BN leaves and
    biases, so the folded epilogue is not the identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    tree = {}
    for name, leaves in shapes.items():
        p = {}
        for leaf, sd in leaves.items():
            shape = sd.shape
            if leaf == "w":
                fan_in = int(np.prod(shape[:-1]))
                gain = 2.0 if len(shape) == 4 else 1.0
                v = rng.standard_normal(shape) * np.sqrt(gain / fan_in)
            elif leaf in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, shape)
            else:                                   # mean, shift, bias, b
                v = rng.standard_normal(shape) * 0.1
            p[leaf] = v.astype(np.float32)
        tree[name] = p
    return tree


def _pair(net, *, fuse=True):
    ours_nl, ref_nl, image = NETS[net]
    ref = JaxGxM(ref_nl(), impl="xla", fuse=fuse, num_classes=10)
    ours = GxM(ours_nl(), device="cpu", fuse=fuse, num_classes=10)
    return ours, ref, _reference_params(ref), image


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("net", NETS)
def test_infer_matches_reference(net, fuse):
    ours, ref, tree, image = _pair(net, fuse=fuse)
    x = np.random.default_rng(1).standard_normal(
        (2, image, image, 3)).astype(np.float32)
    exp = np.asarray(jax.jit(ref.infer)({n: {k: jnp.asarray(v) for k, v in p.items()}
                                for n, p in tree.items()}, jnp.asarray(x)))
    out = ours.infer(params_from_jax(tree, device="cpu"), torch.from_numpy(x))
    assert out.shape == (2, 10) and out.is_inference()
    np.testing.assert_allclose(out.numpy(), exp, **TOL)


@pytest.mark.parametrize("net", NETS)
def test_init_matches_reference_layout_and_distribution(net):
    ours, ref, _, _ = _pair(net)
    mine = ours.init(torch.Generator().manual_seed(0))
    theirs = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    assert mine.keys() == theirs.keys()
    ones = {"scale", "var"}
    for name, p in theirs.items():
        assert mine[name].keys() == p.keys(), name
        for leaf, v in p.items():
            assert tuple(mine[name][leaf].shape) == v.shape, (name, leaf)
            assert mine[name][leaf].dtype == torch.float32
            if leaf != "w":             # the reference's constant leaves
                assert bool((mine[name][leaf] == float(leaf in ones)).all())
    # He-normal conv weights: the std of the widest conv is sqrt(2 / fan_in)
    t = max((t for t in ours.etg.tasks if t.op == "conv"),
            key=lambda t: t.attrs["c"] * t.attrs["k"])
    fan_in = t.attrs["c"] * t.attrs["r"] * t.attrs["s"]
    std = float(mine[t.name]["w"].std())
    assert abs(std / np.sqrt(2.0 / fan_in) - 1) < 0.05


def test_params_from_jax_copies_layouts():
    _, ref, tree, _ = _pair("resnet50")
    ported = params_from_jax(tree, device="cpu")
    for name, p in tree.items():
        for leaf, v in p.items():
            np.testing.assert_array_equal(ported[name][leaf].numpy(), v)
    tree["conv1"]["w"][0, 0, 0, 0] += 1.0         # a copy, not a view
    assert ported["conv1"]["w"][0, 0, 0, 0] != tree["conv1"]["w"][0, 0, 0, 0]


def test_later_slices_raise(monkeypatch):
    ours, _, _, image = _pair("resnet50")
    params = ours.init()
    x = torch.zeros((1, image, image, 3))
    with pytest.raises(NotImplementedError, match="int8 slice"):
        ours.forward(params, x, tap=lambda name, inp: None)
    params["conv1"]["w_q"] = params["conv1"]["w"]
    with pytest.raises(NotImplementedError, match="int8 slice"):
        ours.forward(params, x)
    monkeypatch.setenv("REPRO_CHAIN_FUSION", "on")
    with pytest.raises(NotImplementedError, match="chain"):
        ours.infer(ours.init(), x)


@pytest.mark.parametrize("hw,window,stride,padding", [
    ((9, 9), 3, 2, 1), ((8, 11), 3, 2, 1), ((7, 7), 2, 1, 0)])
def test_maxpool_matches_reduce_window(hw, window, stride, padding):
    """-inf padding, as ``lax.reduce_window``: the inputs are negative too,
    so zero padding would show."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 5)).astype(
        np.float32) - 1.0
    out = _maxpool(torch.from_numpy(x), window, stride, padding)
    exp = jax_maxpool(jnp.asarray(x), window, stride, padding)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), np.asarray(exp))
