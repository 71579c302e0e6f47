"""The whole-plane path (``REPRO_CONV_TILING=whole``) of the port on the CPU
against the JAX package.

The reference's whole-plane Pallas kernels use plain blocked BlockSpecs, so
they run in interpret mode on the CPU (the tiled ones do not on jax 0.9.0):
each plain version of the port is held against the reference's real kernel.

* K10a ``conv2d_direct_whole_plain`` against
  ``conv2d_direct(..., whole_plane=True, interpret=True)``: strides 1 and
  2, 1x1 and 3x3, every epilogue combination, P tails; <= 1e-5 * max |JAX|.
* K10b ``conv2d_wu_whole_plain`` against ``conv2d_wu(..., whole_plane=True,
  interpret=True)``, b_p dividing P; <= 1e-5 * max |JAX|; a b_p that does
  not divide P raises, as in the reference.
* K10c ``conv2d_q8_whole_plain`` against ``conv2d_q8(..., whole_plane=True,
  interpret=True)``, <= 1e-6 * max |JAX|, and bit for bit against K3's
  plain version on the reference's tiled-vs-whole cases.
* The switch (default, invalid values, the context manager), the dispatch
  of ``core.conv`` under ``whole``, and the blocking of every ResNet-50
  signature against the reference's ``conv_blocking``.
* The slice, on reduced ResNet-50 (one block per stage, 10 classes): the
  f32 and int8 ``GxM.infer`` at 2 x 32 x 32 against
  ``repro.graph.GxM(impl="interpret")`` under the reference's own
  ``use_conv_tiling("whole")`` (1e-4 and 1e-3 * max |logit|, one quantized
  tree for both, the same top-1), and one SGD step at 4 x 64 x 64 against
  ``impl="xla"`` with ``tests/test_torch_train.py``'s limits and seed (the
  reference's interpret step takes 47 s here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as jax_backend
from repro.core import blocking as jax_blocking
from repro.graph import GxM as JaxGxM
from repro.graph import resnet50 as jax_resnet50
from repro.kernels.conv2d_direct import conv2d_direct as jax_conv2d_direct
from repro.kernels.conv2d_q8 import conv2d_q8 as jax_conv2d_q8
from repro.kernels.conv2d_wu import conv2d_wu as jax_conv2d_wu
from repro_torch import backend as be
from repro_torch.convert import params_from_jax
from repro_torch.core import conv
from repro_torch.core.duality import dual_conv_signatures
from repro_torch.core.quantize import calibrate_network, quantize_gxm_params
from repro_torch.graph import GxM, build_etg, resnet50
from repro_torch.graph.serving import CnnInferenceEngine, conv_shapes
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2

from test_torch_executor import _reference_params
from test_torch_train import LR, _batch

# n, h, c, k, r, stride, pad, rb_p, k_blk: strides 1 and 2, 1x1 and 3x3,
# P tails (P = 9 by 4, 6 by 4, 10 by 3), more than one K block
CASES = [
    (2, 9, 8, 16, 3, 1, 1, 4, 8),
    (2, 12, 8, 16, 3, 2, 1, 4, 16),
    (1, 10, 16, 8, 1, 1, 0, 3, 8),
    (1, 11, 16, 16, 1, 2, 0, 2, 8),
]
# bias, bn, residual, relu: every combination
EPILOGUES = [dict(bias=b, bn=s, residual=res, relu=u)
             for b in (False, True) for s in (False, True)
             for res in (False, True) for u in (False, True)]


def _f32_case(case, seed, *, bias=False, bn=False, residual=False,
              relu=False):
    n, h, c, k, r, st, pad, rb_p, k_blk = case
    rng = np.random.default_rng(seed)
    p = (h + 2 * pad - r) // st + 1
    arr = {"x": rng.standard_normal((n, h, h, c)),
           "w": rng.standard_normal((r, r, c, k)) / np.sqrt(r * r * c)}
    if bias:
        arr["bias"] = rng.standard_normal(k)
    if bn:
        arr["scale"] = rng.uniform(0.5, 1.5, k)
        arr["shift"] = rng.standard_normal(k)
    if residual:
        arr["residual"] = rng.standard_normal((n, p, p, k))
    arr = {key: v.astype(np.float32) for key, v in arr.items()}
    kw = dict(stride=st, padding=pad, relu=relu, rb_p=rb_p, k_blk=k_blk)
    return arr, kw


# every combination on the 3x3 cases, every fifth on the 1x1 ones
K10A_PARAMS = [(case, epi) for case in CASES[:2]
               for epi in range(len(EPILOGUES))] + \
    [(case, epi) for case in CASES[2:] for epi in range(0, len(EPILOGUES), 5)]


@pytest.mark.parametrize("case,epi", K10A_PARAMS)
def test_k10a_plain_matches_pallas_whole_plane(case, epi):
    arr, kw = _f32_case(case, epi, **EPILOGUES[epi])
    x, w = arr.pop("x"), arr.pop("w")
    exp = np.asarray(jax_conv2d_direct(
        jnp.asarray(x), jnp.asarray(w), whole_plane=True, interpret=True,
        **{key: jnp.asarray(v) for key, v in arr.items()}, **kw))
    before = k1.launches_whole
    got = k1.conv2d_direct_whole(
        torch.from_numpy(x), torch.from_numpy(w),
        **{key: torch.from_numpy(v) for key, v in arr.items()}, **kw)
    assert k1.launches_whole == before          # the CPU runs no kernel
    assert got.shape == exp.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - exp).max()) <= \
        1e-5 * float(np.abs(exp).max())


def test_k10a_plain_tail_rows_and_blocking_do_not_change_the_function():
    """rb_p that does not divide P, rb_p past P, and k_blk < K give the
    plain direct conv of K1 (<= 1e-6 relative)."""
    arr, kw = _f32_case(CASES[0], 1, bn=True, relu=True)
    t = {key: torch.from_numpy(v) for key, v in arr.items()}
    exp = k1.conv2d_direct_plain(**t, stride=1, padding=1, relu=True)
    for rb_p, k_blk in ((4, 8), (9, 16), (20, 16), (1, 8)):
        got = k1.conv2d_direct_whole(**t, stride=1, padding=1, relu=True,
                                     rb_p=rb_p, k_blk=k_blk)
        assert float((got - exp).abs().max()) <= \
            1e-6 * float(exp.abs().max())


def test_k10a_rejects_a_k_blk_that_does_not_divide_k():
    arr, kw = _f32_case(CASES[0], 0)
    with pytest.raises(ValueError, match="k_blk"):
        k1.conv2d_direct_whole(torch.from_numpy(arr["x"]),
                               torch.from_numpy(arr["w"]), stride=1,
                               padding=1, rb_p=4, k_blk=12)


# n, h, c, k, r, stride, pad, b_p, k_blk (b_p divides P)
WU_CASES = [
    (2, 9, 8, 16, 3, 1, 1, 3, 8),
    (2, 12, 8, 16, 3, 2, 1, 2, 16),
    (1, 10, 16, 8, 1, 1, 0, 5, 8),
    (2, 13, 8, 8, 3, 2, 1, 7, 8),
]


def _wu_case(case, seed):
    n, h, c, k, r, st, pad, b_p, k_blk = case
    rng = np.random.default_rng(seed)
    p = (h + 2 * pad - r) // st + 1
    x = rng.standard_normal((n, h, h, c)).astype(np.float32)
    do = rng.standard_normal((n, p, p, k)).astype(np.float32)
    return x, do, dict(stride=st, padding=pad, filter_rs=(r, r), b_p=b_p,
                       k_blk=k_blk)


@pytest.mark.parametrize("case", WU_CASES)
def test_k10b_plain_matches_pallas_whole_plane(case):
    x, do, kw = _wu_case(case, 3)
    exp = np.asarray(jax_conv2d_wu(jnp.asarray(x), jnp.asarray(do),
                                   whole_plane=True, interpret=True, **kw))
    before = k2.launches_whole
    got = k2.conv2d_wu_whole(torch.from_numpy(x), torch.from_numpy(do), **kw)
    assert k2.launches_whole == before
    assert got.shape == exp.shape
    assert float(np.abs(got.numpy() - exp).max()) <= \
        1e-5 * float(np.abs(exp).max())
    tiled = k2.conv2d_wu_plain(torch.from_numpy(x), torch.from_numpy(do),
                               stride=kw["stride"], padding=kw["padding"],
                               filter_rs=kw["filter_rs"])
    assert float((got - tiled).abs().max()) <= 1e-5 * float(tiled.abs().max())


def test_k10b_raises_when_b_p_does_not_divide_p():
    """The reference asserts b_p | P (``conv2d_wu.py:190``); the port
    raises ``ValueError`` on the CPU and the card alike."""
    x, do, kw = _wu_case(WU_CASES[0], 0)      # P = 9
    with pytest.raises(ValueError, match="does not divide P"):
        k2.conv2d_wu_whole(torch.from_numpy(x), torch.from_numpy(do),
                           **{**kw, "b_p": 4})
    with pytest.raises(AssertionError):
        jax_conv2d_wu(jnp.asarray(x), jnp.asarray(do), whole_plane=True,
                      interpret=True, **{**kw, "b_p": 4})


# the reference's tiled-vs-whole q8 cases (tests/test_kernels_q8_pool.py),
# n, h, c, k, r, stride, pad, and a whole-plane rb_p, k_blk
Q8_CASES = [
    (2, 12, 16, 16, 3, 1, 1, 5, 16),
    (1, 13, 8, 16, 3, 2, 1, 3, 8),
    (1, 11, 8, 24, 1, 1, 0, 4, 8),
    (1, 24, 8, 16, 7, 2, 3, 4, 16),
    (1, 10, 16, 8, 3, 1, 1, 4, 8),
]


def _q8_case(case, seed, epilogue=True):
    n, h, c, k, r, st, pad, rb_p, k_blk = case
    rng = np.random.default_rng(seed)
    p = (h + 2 * pad - r) // st + 1
    x = torch.from_numpy(rng.standard_normal((n, h, h, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((r, r, c, k)) * 0.1)
                         .astype(np.float32))
    x_q, w_q, x_scale, w_scale = k3.quantize_conv_inputs(x, w)
    kw = dict(x_scale=x_scale, w_scale=w_scale, stride=st, padding=pad)
    if epilogue:
        kw.update(bias=torch.from_numpy(rng.standard_normal(k)
                                        .astype(np.float32)),
                  scale=torch.from_numpy(rng.uniform(0.5, 1.5, k)
                                         .astype(np.float32)),
                  shift=torch.from_numpy(rng.standard_normal(k)
                                         .astype(np.float32)),
                  residual=torch.from_numpy(rng.standard_normal(
                      (n, p, p, k)).astype(np.float32)),
                  relu=True)
    return x_q, w_q, kw, dict(rb_p=rb_p, k_blk=k_blk)


@pytest.mark.parametrize("case", Q8_CASES)
@pytest.mark.parametrize("epilogue", [False, True])
def test_k10c_plain_matches_pallas_whole_plane(case, epilogue):
    x_q, w_q, kw, blk = _q8_case(case, 5, epilogue)
    jkw = {key: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                 else v) for key, v in kw.items()}
    exp = np.asarray(jax_conv2d_q8(jnp.asarray(x_q.numpy()),
                                   jnp.asarray(w_q.numpy()), whole_plane=True,
                                   interpret=True, **jkw, **blk))
    before = k3.launches_whole
    got = k3.conv2d_q8_whole(x_q, w_q, **kw, **blk)
    assert k3.launches_whole == before
    assert got.shape == exp.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - exp).max()) <= \
        1e-6 * float(np.abs(exp).max())


@pytest.mark.parametrize("case", Q8_CASES)
def test_k10c_plain_equals_k3_plain_bit_for_bit(case):
    """The reference's contract between its tiled and whole-plane int8
    kernels (``tests/test_kernels_q8_pool.py:89``), in the port's plain
    versions: exact int32 sums, the same f32 epilogue."""
    x_q, w_q, kw, blk = _q8_case(case, 7)
    whole = k3.conv2d_q8_whole(x_q, w_q, **kw, **blk)
    tiled = k3.conv2d_q8_plain(x_q, w_q, **kw)
    assert torch.equal(whole, tiled)


def test_whole_plan_fits_every_resnet50_signature():
    """K10a and K10c plan every lane-aligned ResNet-50 forward, dual and
    int8 launch at batch 16 and 224x224 within a block's shared memory,
    with the reference's blocking."""
    etg = build_etg(resnet50())
    seen = 0
    for sh in conv_shapes(etg, (224, 224)):
        if not conv.lane_ok(sh["c"], sh["k"]):
            continue
        geos = [(sh, "fwd"), (sh, "q8")] + [
            (d, "bwd") for d in dual_conv_signatures(
                r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"],
                stride=sh["stride"], padding=sh["padding"],
                input_hw=(sh["h"], sh["w"])) if conv.lane_ok(d["c"], d["k"])]
        for g, kind in geos:
            blk = conv.whole_blocking(
                (16, g["h"], g["w"], g["c"]), (g["r"], g["s"], g["c"], g["k"]),
                stride=g["stride"], padding=g["padding"], kind=kind)
            p = (g["h"] + 2 * g["padding"] - g["r"]) // g["stride"] + 1
            plan = k1.whole_plan(p=p, q=p, k_blk=blk.k_blk, rb_p=blk.rb_p,
                                 r=g["r"], s=g["s"], stride=g["stride"],
                                 wp=g["w"] + 2 * g["padding"],
                                 slice_bytes=32)
            assert plan.smem <= k1.SMEM_LIMIT
            assert plan.rows_pass * p <= plan.tm * 256 // (plan.bn // 8)
            seen += 1
    assert seen > 100


# -- the switch ---------------------------------------------------------------


def test_conv_tiling_defaults_to_tiled(monkeypatch):
    monkeypatch.delenv("REPRO_CONV_TILING", raising=False)
    assert be.get_conv_tiling() == "tiled"
    monkeypatch.setenv("REPRO_CONV_TILING", "whole")
    assert be.get_conv_tiling() == "whole"     # read at each call


def test_invalid_conv_tiling_raises(monkeypatch):
    monkeypatch.setenv("REPRO_CONV_TILING", "streamed")
    with pytest.raises(ValueError, match="REPRO_CONV_TILING"):
        be.get_conv_tiling()
    with pytest.raises(ValueError, match="conv_tiling"):
        be.set_conv_tiling("Whole")
    with pytest.raises(ValueError):
        with be.use_conv_tiling("none"):
            pass


def test_use_conv_tiling_restores_the_previous_value(monkeypatch):
    monkeypatch.delenv("REPRO_CONV_TILING", raising=False)
    with be.use_conv_tiling("whole"):
        assert be.get_conv_tiling() == "whole"
        with be.use_conv_tiling("tiled"):
            assert be.get_conv_tiling() == "tiled"
        assert be.get_conv_tiling() == "whole"
    assert be.get_conv_tiling() == "tiled"
    with pytest.raises(RuntimeError):
        with be.use_conv_tiling("whole"):
            raise RuntimeError("inside")
    assert be.get_conv_tiling() == "tiled"


def _spy(monkeypatch):
    """Replace the six wrappers ``core.conv`` calls by recorders of the
    blocking each receives."""
    calls = []

    def recorder(name, fn):
        def spy(*args, **kw):
            calls.append((name, kw.get("rb_p", kw.get("b_p")),
                          kw.get("k_blk")))
            return fn(*args, **kw)
        return spy
    for name in ("conv2d_direct", "conv2d_direct_whole", "conv2d_q8",
                 "conv2d_q8_whole", "conv2d_wu", "conv2d_wu_whole"):
        monkeypatch.setattr(conv, name, recorder(name, getattr(conv, name)))
    return calls


@pytest.mark.parametrize("tiling", ["tiled", "whole"])
def test_core_conv_calls_the_wrappers_of_the_switch(monkeypatch, tiling):
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 8, 16))
                         .astype(np.float32) * 0.2)
    xs = x.abs().max() / 127
    w_q, w_scale = k3.quantize_conv_inputs(x, w)[1::2]
    with be.use_conv_tiling(tiling):
        conv.conv2d_fwd(x, w, stride=1, padding=1)
        conv.conv2d_q8_fwd(x, w_q, x_scale=xs, w_scale=w_scale, stride=2,
                           padding=1)
        y = conv.conv2d_train(x.requires_grad_(), w.requires_grad_(), 1, 1)
        y.sum().backward()
        conv.conv2d_fwd(x.detach()[..., :3], w[:, :, :3].detach(),
                        stride=1, padding=1)            # the C=3 stem: ref
    names = [c[0] for c in calls]
    suffix = "_whole" if tiling == "whole" else ""
    assert names == [f"conv2d_direct{suffix}", f"conv2d_q8{suffix}",
                     f"conv2d_direct{suffix}", f"conv2d_direct{suffix}",
                     f"conv2d_wu{suffix}"]
    if tiling == "whole":       # the reference's blocking of each launch
        assert calls[0][1:] == (8, 16)    # rb_p = P (64 px < 128), k_blk K
        assert calls[4][1:] == (8, 16)    # b_p | P = 8
    else:
        assert all(c[1] is None for c in calls)


def _resnet50_launches():
    """(x shape, w shape, stride, padding, kind, dtype bytes) of every
    lane-aligned launch kind of one ResNet-50 training step and int8
    forward at batch 16, 224x224."""
    out = []
    for sh in conv_shapes(build_etg(resnet50()), (224, 224)):
        if not conv.lane_ok(sh["c"], sh["k"]):
            continue
        x = (16, sh["h"], sh["w"], sh["c"])
        w = (sh["r"], sh["s"], sh["c"], sh["k"])
        for kind, db in (("fwd", 4), ("q8", 1), ("wu", 4)):
            out.append((x, w, sh["stride"], sh["padding"], kind, db))
        for d in dual_conv_signatures(
                r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"],
                stride=sh["stride"], padding=sh["padding"],
                input_hw=(sh["h"], sh["w"])):
            if conv.lane_ok(d["c"], d["k"]):
                out.append(((16, d["h"], d["w"], d["c"]),
                            (d["r"], d["s"], d["c"], d["k"]), d["stride"],
                            d["padding"], "bwd", 4))
    return out


def test_whole_blocking_equals_the_references_on_resnet50():
    """``core.conv.whole_blocking`` is the reference's ``conv_blocking`` as
    ``repro/core/conv.py`` calls it under ``whole``: fwd, bwd, q8 (one
    byte) and wu with ``require_divisor``, at minibatch N."""
    launches = _resnet50_launches()
    assert {kind for *_, kind, _ in launches} == {"fwd", "bwd", "q8", "wu"}
    for x, w, st, pad, kind, db in launches:
        n, h, wd, c = x
        r, s, _, k = w
        got = conv.whole_blocking(x, w, stride=st, padding=pad, kind=kind)
        exp = jax_blocking.conv_blocking(
            h=h, w=wd, c=c, k=k, r=r, s=s, stride=st, padding=pad,
            dtype_bytes=db, require_divisor=(kind == "wu"), kind=kind,
            minibatch=n)
        assert (got.rb_p, got.k_blk, got.c_blk, got.rb_q, got.order,
                got.vmem_bytes) == (exp.rb_p, exp.k_blk, exp.c_blk, exp.rb_q,
                                    exp.order, exp.vmem_bytes), (x, w, kind)
        if kind == "wu":
            assert ((h + 2 * pad - r) // st + 1) % got.rb_p == 0


# -- the slice -----------------------------------------------------------------

IMAGE = 32


@pytest.fixture(scope="module")
def reduced():
    """Reduced ResNet-50's params in the reference's layout (random BN
    leaves), and one quantized tree: the port's calibration on its CPU
    forward, shared by both sides."""
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="interpret",
                 num_classes=10)
    tree = _reference_params(ref)
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10, quantized=True)
    params = params_from_jax(tree, device="cpu")
    batches = [np.random.default_rng(9).standard_normal(
        (4, IMAGE, IMAGE, 3)).astype(np.float32)]
    scales = calibrate_network(ours, params, batches)
    qparams = quantize_gxm_params(ours.etg, params, scales)
    qtree = {name: {leaf: v.numpy() for leaf, v in p.items()}
             for name, p in qparams.items()}
    x = np.random.default_rng(1).standard_normal(
        (2, IMAGE, IMAGE, 3)).astype(np.float32)
    return dict(tree=tree, qtree=qtree, x=x)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_whole_plane_infer_matches_pallas_interpret(reduced, quantized):
    """The slice: the port's ``GxM.infer`` under ``whole`` on the CPU (the
    plain versions of K10a / K10c) against the reference's GxM on its
    whole-plane Pallas kernels in interpret mode."""
    tree = reduced["qtree"] if quantized else reduced["tree"]
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="interpret",
                 num_classes=10, quantized=quantized)
    with jax_backend.use_conv_tiling("whole"):
        exp = np.asarray(ref.infer(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(reduced["x"])))
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10, quantized=quantized)
    before = (k1.launches, k1.launches_whole, k3.launches, k3.launches_whole)
    with be.use_conv_tiling("whole"):
        got = ours.infer(params_from_jax(tree, device="cpu"),
                         torch.from_numpy(reduced["x"])).numpy()
    assert (k1.launches, k1.launches_whole, k3.launches,
            k3.launches_whole) == before        # the CPU runs no kernel
    assert got.shape == (2, 10)
    limit = 1e-3 if quantized else 1e-4
    assert float(np.abs(got - exp).max()) <= limit * float(np.abs(exp).max())
    np.testing.assert_array_equal(got.argmax(-1), exp.argmax(-1))


def test_whole_plane_infer_equals_tiled_infer_int8(reduced):
    """int8: the whole-plane forward equals the tiled one bit for bit on
    the CPU, as K10c equals K3."""
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10, quantized=True)
    q = params_from_jax(reduced["qtree"], device="cpu")
    x = torch.from_numpy(reduced["x"])
    tiled = ours.infer(q, x)
    with be.use_conv_tiling("whole"):
        whole = ours.infer(q, x)
    assert torch.equal(whole, tiled)


def test_whole_plane_engine_reports_its_tiling(reduced):
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10)
    eng = CnnInferenceEngine(ours, params_from_jax(reduced["tree"],
                                                   device="cpu"),
                             image_hw=(IMAGE, IMAGE), max_batch=2)
    assert eng.warmup()["conv_tiling"] == "tiled"
    with be.use_conv_tiling("whole"):
        assert eng.warmup()["conv_tiling"] == "whole"


def test_whole_plane_train_step_matches_reference():
    """One SGD step under ``whole`` on the CPU (K10a's and K10b's plain
    versions in every conv's forward, dual and weight gradient) against
    the reference's ``impl="xla"`` step, with ``test_torch_train``'s limits
    and seed."""
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 num_classes=10)
    tree = _reference_params(ref)
    batch = _batch(64, 4)
    exp, exp_loss = jax.jit(ref.sgd_train_step, static_argnums=(2,))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch), LR)
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10)
    with be.use_conv_tiling("whole"):
        got, loss = ours.sgd_train_step(
            params_from_jax(tree, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    np.testing.assert_allclose(float(loss), float(exp_loss), rtol=1e-5)
    for name, p in jax.device_get(exp).items():
        for leaf, v in p.items():
            np.testing.assert_allclose(got[name][leaf].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}.{leaf}")
