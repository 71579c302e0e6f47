"""The port's serving path on the CPU: bucketing as the JAX package does it,
pad-to-bucket, the continuous-batching server, and the rule that entry
points raise rather than run on the CPU when no GPU is present and no device
was asked for."""
import numpy as np
import pytest
import torch

from repro.graph import serving as jax_serving
from repro_torch import backend
from repro_torch.convert import params_from_jax
from repro_torch.graph import GxM, resnet50
from repro_torch.graph.serving import (CnnInferenceEngine, make_buckets,
                                       pick_bucket, round_buckets)
from repro_torch.launch import serve_cnn
from repro_torch.launch.serve_cnn import ImageServer, build_model


@pytest.fixture(scope="module")
def tiny():
    m = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu", num_classes=10)
    return m, m.init(torch.Generator().manual_seed(0))


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("max_batch", [1, 3, 8, 12, 16, 33])
def test_buckets_match_reference(max_batch):
    assert make_buckets(max_batch) == jax_serving.make_buckets(max_batch)
    assert make_buckets(max_batch) == \
        jax_serving.make_buckets(max_batch, num_shards=1)
    ladder = (3, max_batch, 2 * max_batch + 1)
    assert round_buckets(ladder, 1) == jax_serving.round_buckets(ladder, 1)
    buckets = make_buckets(max_batch)
    for n in range(1, max(buckets) + 1):
        assert pick_bucket(n, buckets) == jax_serving.pick_bucket(n, buckets)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        pick_bucket(max(buckets) + 1, buckets)


def test_pad_to_bucket_equals_unbatched_forward(tiny):
    m, params = tiny
    eng = CnnInferenceEngine(m, params, image_hw=(32, 32), max_batch=8)
    images = _images(3)
    out = eng.infer(images)                           # bucket 4, one pad lane
    assert out.shape == (3, 10)
    for i in range(3):
        alone = m.infer(params, torch.from_numpy(images[i:i + 1]))
        torch.testing.assert_close(out[i:i + 1], alone, rtol=1e-5, atol=1e-5)


def test_padded_lanes_are_invisible(tiny):
    m, params = tiny
    images = torch.from_numpy(_images(4))
    zeros_pad = m.infer(params, torch.cat([images[:3], torch.zeros_like(
        images[:1])]))
    junk_pad = m.infer(params, torch.cat([images[:3], 100 * images[3:]]))
    assert torch.equal(zeros_pad[:3], junk_pad[:3])


def test_warmup_covers_every_bucket(tiny):
    m, params = tiny
    eng = CnnInferenceEngine(m, params, image_hw=(32, 32), max_batch=4)
    report = eng.warmup()
    assert report["buckets"] == [1, 2, 4]
    assert set(report["warmup_s"]) == {1, 2, 4}
    assert report["conv_signatures"] == 16
    assert report["kernel_path_signatures"] == 15     # all but the C=3 stem
    assert report["kernel_cache_entries"] == len(m.etg.kernel_cache)


def test_image_server_answers_every_request(tiny):
    m, params = tiny
    eng = CnnInferenceEngine(m, params, image_hw=(32, 32), max_batch=4)
    server = ImageServer(eng)
    rng = np.random.default_rng(3)
    results = serve_cnn.serve_bursts(
        server, serve_cnn.make_images(11, 32, rng), rng=rng)
    assert sorted(results) == list(range(11))
    st = server.stats()
    assert st["images"] == 11 and st["latency"]["count"] == 11
    assert sum(b * c for b, c in st["by_bucket"].items()) == \
        11 + st["padded_lanes"]
    assert set(st["by_bucket"]) == {1, 2, 4}          # every bucket served
    assert st["wall_s"] > 0
    assert st["images_per_s"] == pytest.approx(11 / st["wall_s"])
    # a request's top-1 is the argmax of its own logits
    images = _images(2, seed=5)
    ids = [server.submit(img) for img in images]
    server.run()
    logits = m.infer(params, torch.from_numpy(images))
    for rid, row in zip(ids, logits):
        assert server.results[rid][0] == int(row.argmax())


def test_image_server_window_is_wall_time(tiny):
    m, params = tiny
    eng = CnnInferenceEngine(m, params, image_hw=(32, 32), max_batch=4)
    ticks = iter(range(100))
    server = ImageServer(eng, clock=lambda: float(next(ticks)))
    for img in _images(3):                            # submitted at 0, 1, 2
        server.submit(img)
    server.run()                                      # done at 3
    st = server.stats()
    assert st["wall_s"] == 3.0 and st["images_per_s"] == 1.0
    assert st["latency"]["max_ms"] == 3000.0          # queue wait included


def test_main_smoke_on_cpu(capsys):
    summary = serve_cnn.main(["--smoke", "--device", "cpu", "--requests",
                              "5", "--max-batch", "4"])
    assert summary["requests"] == 5 and summary["device"] == "cpu"
    assert summary["images_per_s"] == pytest.approx(5 / summary["wall_s"])
    assert summary["conv2d_direct_launches"] == 0     # the CPU runs no kernel
    assert '"requests": 5' in capsys.readouterr().out


def test_entry_points_raise_without_gpu_and_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nl = resnet50(10, stages=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.resolve_device(None)
    with pytest.raises(RuntimeError, match="no GPU"):
        GxM(nl)
    with pytest.raises(RuntimeError, match="no GPU"):
        params_from_jax({"fc": {"b": np.zeros(3, np.float32)}})
    with pytest.raises(RuntimeError, match="no GPU"):
        build_model(smoke=True)
    with pytest.raises(RuntimeError, match="no GPU"):
        serve_cnn.main(["--smoke"])
    assert GxM(nl, device="cpu").device == torch.device("cpu")
