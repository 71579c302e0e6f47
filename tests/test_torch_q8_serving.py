"""The port's int8 serving slice (§II-K) on the CPU against the JAX package:
the ``REPRO_QUANTIZE`` knob, q8 marking, calibration, the int8 GxM forward,
the quantized serving engine and the image server.

Reduced ResNet-50 (one block per stage, 10 classes, 32x32).  Params come
from the reference's ``GxM.init`` with random BN leaves; one JAX
calibration, made by the reference's ``CnnInferenceEngine.calibrate(seed=0)``
on its default synthetic batches, is shared by the module.

Tolerances: calibrated scales within 1e-5 relative (the f32 forwards sum in
other orders); int8 logits within 1e-3 * max |logit| of the reference's
``GxM(impl="xla", quantized=True)`` with the same top-1 on every image (the
reference folds the dequant scale into the BN scale and sums int8 products
in f32, so a quantized activation near a rounding tie may land one step
apart); int8 against f32 on the same net, the same top-1 and a relative gap
below 0.1 (the reference's own test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jax_quantize
from repro.graph import GxM as JaxGxM
from repro.graph import resnet50 as jax_resnet50
from repro.graph import etg as jax_etg
from repro.graph import serving as jax_serving
from repro_torch import backend
from repro_torch.convert import params_from_jax
from repro_torch.core.quantize import calibrate_network
from repro_torch.graph import GxM, build_etg, resnet50
from repro_torch.graph.etg import conv_signature, quantize_etg
from repro_torch.graph.serving import CnnInferenceEngine
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.launch import serve_cnn

IMAGE = 32


def _reference_params(ref, seed=0):
    """The reference's init, with random BN leaves so the folded epilogue
    is not the identity; numpy leaves."""
    tree = jax.tree.map(np.array, ref.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p in tree.values():
        if "var" in p:
            k = p["var"].shape[0]
            p["mean"] = (rng.standard_normal(k) * 0.1).astype(np.float32)
            p["var"] = rng.uniform(0.5, 1.5, k).astype(np.float32)
            p["scale"] = rng.uniform(0.5, 1.5, k).astype(np.float32)
            p["shift"] = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return tree


def _port_gxm(**kw):
    return GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10, **kw)


@pytest.fixture(scope="module")
def reference():
    """The reference's quantized net, its f32 params tree, and one
    calibration by its engine (seed 0) with the quantized tree from it."""
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 num_classes=10, quantized=True)
    tree = _reference_params(ref)
    jax_tree = jax.tree.map(jnp.asarray, tree)
    eng = jax_serving.CnnInferenceEngine(ref, jax_tree,
                                         image_hw=(IMAGE, IMAGE),
                                         max_batch=4, autotune="off")
    scales = eng.calibrate(seed=0)
    return dict(ref=ref, tree=tree, scales=jax.tree.map(np.array, scales),
                qtree=jax.tree.map(np.array, eng.qparams))


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, IMAGE, IMAGE, 3)).astype(np.float32)


def _assert_scales_close(got, exp):
    assert got.keys() == exp.keys()
    for name, v in got.items():
        assert v.dtype == torch.float32 and v.dim() == 0, name
        e = float(exp[name])
        assert abs(float(v) - e) <= 1e-5 * e, (name, float(v), e)


def test_engine_calibrate_matches_reference(reference):
    """The port's engine draws the reference's default calibration batches
    (``np.random.default_rng(0)``) and finds the same scales."""
    ours = _port_gxm()
    eng = CnnInferenceEngine(ours, params_from_jax(reference["tree"],
                                                   device="cpu"),
                             image_hw=(IMAGE, IMAGE), max_batch=4,
                             quantized=True)
    scales = eng.calibrate(seed=0)
    assert ours.quantized and eng.qparams is not None
    _assert_scales_close(scales, reference["scales"])
    assert eng.act_scales is scales
    assert eng._run_params is eng.qparams


def test_calibrate_network_matches_reference(reference):
    """Explicit batches, tensors or arrays, through both packages'
    ``calibrate_network``."""
    batches = [_images(2, 7), _images(3, 8)]
    exp = jax_quantize.calibrate_network(
        reference["ref"], jax.tree.map(jnp.asarray, reference["tree"]),
        batches)
    got = calibrate_network(_port_gxm(quantized=True),
                            params_from_jax(reference["tree"], device="cpu"),
                            [batches[0], torch.from_numpy(batches[1])])
    _assert_scales_close(got, jax.tree.map(np.array, exp))


def test_tap_sees_every_conv_input_in_order(reference):
    ours = _port_gxm()
    seen = []
    x = torch.from_numpy(_images(1, 9))
    ours.forward(params_from_jax(reference["tree"], device="cpu"), x,
                 train=False, tap=lambda name, v: seen.append((name,
                                                               v.shape)))
    convs = [t for t in ours.etg.tasks if t.op == "conv"]
    assert [n for n, _ in seen] == [t.name for t in convs]
    assert seen[0][1] == x.shape
    assert all(shape[-1] == t.attrs["c"] for (_, shape), t in
               zip(seen, convs))


def test_params_from_jax_carries_a_quantized_tree(reference):
    got = params_from_jax(reference["qtree"], device="cpu")
    for name, p in reference["qtree"].items():
        assert got[name].keys() == p.keys()
        for leaf, v in p.items():
            assert got[name][leaf].numpy().dtype == v.dtype, (name, leaf)
            assert tuple(got[name][leaf].shape) == v.shape, (name, leaf)
            np.testing.assert_array_equal(got[name][leaf].numpy(), v)
    assert got["s1b0_c1"]["w_q"].dtype == torch.int8
    assert got["s1b0_c1"]["x_scale"].dim() == 0


def test_int8_infer_matches_reference(reference):
    """The slice: the port's int8 forward on the reference's quantized tree
    against ``GxM(impl="xla", quantized=True)``."""
    x = _images(4, 1)
    exp = np.asarray(jax.jit(reference["ref"].infer)(
        jax.tree.map(jnp.asarray, reference["qtree"]), jnp.asarray(x)))
    ours = _port_gxm(quantized=True)
    before = (k1.launches, k3.launches)
    out = ours.infer(params_from_jax(reference["qtree"], device="cpu"),
                     torch.from_numpy(x))
    assert (k1.launches, k3.launches) == before      # the CPU runs no kernel
    assert out.shape == (4, 10) and out.dtype == torch.float32
    scale = float(np.abs(exp).max())
    assert float(np.abs(out.numpy() - exp).max()) <= 1e-3 * scale
    np.testing.assert_array_equal(out.numpy().argmax(-1), exp.argmax(-1))


def test_int8_engine_keeps_f32_top1(reference):
    """The reference's own test (``tests/test_serve_cnn.py``): a quantized
    engine keeps the f32 top-1, within the calibration error band."""
    params = params_from_jax(reference["tree"], device="cpu")
    x = _images(4, 2)
    f32 = _port_gxm(quantized=False).infer(params, torch.from_numpy(x))
    eng = CnnInferenceEngine(_port_gxm(quantized=True), params,
                             image_hw=(IMAGE, IMAGE), buckets=(4,))
    report = eng.warmup()
    assert report["quantized"] and eng.qparams is not None
    got = eng.infer(x)
    assert torch.equal(got.argmax(-1), f32.argmax(-1))
    rel = float((got - f32).abs().max()) / float(f32.abs().max())
    assert rel < 0.1, rel


def test_int8_padded_lanes_invisible(reference):
    """Pad-to-bucket on the q8 path: junk in the padded lane moves no bit
    of the real lanes (activation scales are calibration constants)."""
    eng = CnnInferenceEngine(
        _port_gxm(quantized=True),
        params_from_jax(reference["tree"], device="cpu"),
        image_hw=(IMAGE, IMAGE), buckets=(4,))
    eng.warmup()
    x = _images(3, 3)
    got = eng.infer(x)                                 # pads 3 -> bucket 4
    junk = 100 * _images(1, 4)
    with_zeros = eng.gxm.infer(eng._run_params, torch.from_numpy(
        np.concatenate([x, 0 * junk])))
    with_junk = eng.gxm.infer(eng._run_params, torch.from_numpy(
        np.concatenate([x, junk])))
    assert torch.equal(with_zeros[:3], with_junk[:3])
    assert torch.equal(got, with_zeros[:3])


def test_training_over_int8_weights_raises(reference):
    ours = _port_gxm(quantized=True)
    qparams = params_from_jax(reference["qtree"], device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        ours.forward(qparams, torch.from_numpy(_images(1, 5)), train=True)


def test_quantize_etg_matches_reference():
    """q8 marking, by ``build_etg(quantized=True)`` and by re-marking an
    f32 ETG in place, gives the reference's signatures and dedup cache."""
    nl, ref_nl = resnet50(10, stages=(1, 1, 1, 1)), \
        jax_resnet50(10, stages=(1, 1, 1, 1))
    exp = jax_etg.build_etg(ref_nl, quantized=True)
    built = build_etg(nl, quantized=True)
    remarked = quantize_etg(build_etg(nl))
    for etg in (built, remarked):
        assert etg.kernel_cache == exp.kernel_cache
        assert [conv_signature(t) for t in etg.tasks if t.op == "conv"] == \
            [jax_etg.conv_signature(t) for t in exp.tasks if t.op == "conv"]
    assert all(t.attrs["kernel_kind"] == "q8" for t in built.tasks
               if t.op == "conv")


def test_engine_quantized_true_remarks_an_f32_gxm(reference):
    ours = _port_gxm(quantized=False)
    assert not ours.quantized
    eng = CnnInferenceEngine(ours, params_from_jax(reference["tree"],
                                                   device="cpu"),
                             image_hw=(IMAGE, IMAGE), max_batch=2,
                             quantized=True)
    assert eng.quantized and ours.quantized
    assert all(t.attrs["kernel_kind"] == "q8" for t in ours.etg.tasks
               if t.op == "conv")
    plain = CnnInferenceEngine(_port_gxm(quantized=False), eng.params,
                               image_hw=(IMAGE, IMAGE), max_batch=2)
    with pytest.raises(ValueError, match="not quantized"):
        plain.calibrate()
    assert plain._run_params is plain.params


def test_uncalibrated_quantized_engine_never_serves_f32(reference):
    """A quantized engine serves only its quantized tree: before
    ``calibrate``/``warmup`` made one, ``infer`` raises instead of running
    the f32 params."""
    eng = CnnInferenceEngine(_port_gxm(quantized=True),
                             params_from_jax(reference["tree"], device="cpu"),
                             image_hw=(IMAGE, IMAGE), max_batch=2)
    images = np.random.default_rng(3).standard_normal(
        (2, IMAGE, IMAGE, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="not calibrated"):
        eng.infer(images)
    with pytest.raises(ValueError, match="not calibrated"):
        eng._run_params
    eng.calibrate(seed=0)
    assert eng._run_params is eng.qparams
    assert eng.infer(images).shape == (2, 10)


@pytest.mark.parametrize("value,quantized", [("int8", True), ("off", False),
                                             (None, False)])
def test_repro_quantize_selects_the_path(monkeypatch, value, quantized):
    if value is None:
        monkeypatch.delenv("REPRO_QUANTIZE", raising=False)
    else:
        monkeypatch.setenv("REPRO_QUANTIZE", value)
    ours = _port_gxm()
    assert ours.quantized is quantized
    kinds = {t.attrs.get("kernel_kind", "f32") for t in ours.etg.tasks
             if t.op == "conv"}
    assert kinds == {"q8" if quantized else "f32"}
    eng = CnnInferenceEngine(ours, ours.init(), image_hw=(IMAGE, IMAGE),
                             max_batch=1)
    assert eng.quantized is quantized
    assert _port_gxm(quantized=not quantized).quantized is not quantized


def test_invalid_repro_quantize_raises(monkeypatch):
    monkeypatch.setenv("REPRO_QUANTIZE", "int4")
    with pytest.raises(ValueError, match="REPRO_QUANTIZE"):
        backend.get_quantize()
    with pytest.raises(ValueError, match="REPRO_QUANTIZE"):
        _port_gxm()


def test_calibration_deterministic_for_a_seed(reference):
    params = params_from_jax(reference["tree"], device="cpu")

    def scales(seed):
        eng = CnnInferenceEngine(_port_gxm(quantized=True), params,
                                 image_hw=(IMAGE, IMAGE), max_batch=1)
        return eng.calibrate(seed=seed)
    a, b, c = scales(0), scales(0), scales(1)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert any(not torch.equal(a[n], c[n]) for n in a)


def test_serve_cnn_int8_smoke_on_cpu(monkeypatch, capsys):
    """``REPRO_QUANTIZE=int8`` reaches the int8 path through the CLI, as the
    reference's does; every request is served and K3's launches reported
    (none on the CPU)."""
    monkeypatch.setenv("REPRO_QUANTIZE", "int8")
    summary = serve_cnn.main(["--smoke", "--device", "cpu", "--requests",
                              "6", "--max-batch", "4"])
    assert summary["quantized"] is True and summary["requests"] == 6
    assert summary["conv2d_q8_launches"] == 0
    assert summary["conv2d_direct_launches"] == 0
    out = capsys.readouterr().out
    assert "int8" in out and '"conv2d_q8_launches": 0' in out
