"""K6's tuned plans and the data-parallel step on the card.

Every ``MatmulPlan`` the tuner may time (``plan_candidates("matmul")``),
on both of K6's routes, against the plain version at Qwen2-1.5B's
projection shapes and two ragged ones (limits of ``PERF.md`` §2: 1e-5 f32,
1e-2 bf16 of max |plain|; a plan changes which block computes an output,
not its sums, so every plan must give the default plan's bits); and the
data-parallel CNN step of two ranks sharing the card over gloo
(``launch.ranks``), identical shards against the single-device step bit
for bit.

These need an NVIDIA GPU with ``nvcc``; elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dp_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import matmul_fused as k6
from repro_torch.launch.ranks import run_ranks
from repro_torch.tune import space

pytestmark = pytest.mark.gpu

# m, k, n, dtype
BF16, F32 = torch.bfloat16, torch.float32
SHAPES = [(4096, 1536, 1536, BF16), (4096, 1536, 8960, BF16),
          (4096, 8960, 1536, BF16), (1000, 1528, 1000, BF16),
          (1000, 1530, 1000, BF16), (4096, 1536, 256, F32),
          (333, 96, 200, F32)]
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


@pytest.mark.parametrize("m,k,n,dtype", SHAPES)
def test_every_matmul_plan_equals_plain(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5).to(dtype)
    bias = torch.randn(n, generator=gen, device=cuda).to(dtype)
    res = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    kw = dict(bias=bias, residual=res, act="gelu")
    plain = k6.matmul_fused_plain(a, b, **kw).float()
    default = k6.matmul_fused(a, b, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    plans = space.plan_candidates("matmul", m=m, n=n, k=k,
                                  dtype_bytes=a.element_size())
    assert plans[0].route == k6.route(a, b)
    for plan in plans:
        before = k6.launches
        out = k6.matmul_fused(a, b, plan=plan, **kw)
        assert k6.launches == before + 1
        torch.cuda.synchronize()
        rel = float((out.float() - plain).abs().max() / plain.abs().max())
        assert rel <= tol, (plan, rel)
        assert torch.equal(out, default), plan


def _identical_shards(rank, group):
    from repro_torch.graph import GxM, resnet50
    from repro_torch.train import distributed as D
    from repro_torch.train.step import make_cnn_train_step
    torch.backends.cudnn.deterministic = True
    m = GxM(resnet50(num_classes=10, stages=(1, 1, 1, 1)), device="cuda",
            num_classes=10)
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mb = {"image": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
          "label": rng.integers(0, 10, size=(4,)).astype(np.int32)}
    got, metrics = D.make_cnn_train_step_dp(m, group, lr=0.1)(
        D.init_cnn_train_state_dp(params, group), mb)
    ref, loss = make_cnn_train_step(m, lr=0.1)(params, mb)
    return {"loss": float(metrics["loss"]) == float(loss),
            "params": all(torch.equal(got["params"][n][k], ref[n][k])
                          for n in ref for k in ref[n])}


def test_two_ranks_on_one_card_equal_the_single_device_step(cuda, tmp_path):
    results, _ = run_ranks(
        "test_torch_dp_cuda:_identical_shards", 2, workdir=tmp_path,
        timeout_s=300.0,
        env={"PYTHONPATH": os.pathsep.join([
            os.path.join(os.path.dirname(HERE), "src"), HERE])})
    assert results == [{"loss": True, "params": True}] * 2
