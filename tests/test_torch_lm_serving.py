"""The port's LM serving functions on the CPU against the reference's:
lockstep ``generate`` and ``serve_continuous`` (per-lane batch-1 prefill
into a cache slot, per-lane positions) give the same greedy token ids on
the same converted params and prompts, and the CLI runs end to end.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.nn import transformer as jax_T
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    cfg_t = dataclasses.replace(smoke_config(get_config("qwen2-1.5b")),
                                n_layers=2)
    cfg_j = dataclasses.replace(jax_smoke_config(jax_get_config(
        "qwen2-1.5b")), n_layers=2)
    jp, _ = jax_T.init_lm(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab, size=rng.integers(3, 11))
               for _ in range(5)]
    return cfg_t, cfg_j, jp, params_from_jax(jp, "cpu"), prompts


def test_generate_gives_the_reference_token_ids(model):
    cfg_t, cfg_j, jp, tp, prompts = model
    out = serve.generate(tp, cfg_t, prompts, max_new=6, max_len=24)
    exp = jax_serve.generate(jp, cfg_j, prompts, max_new=6, max_len=24)
    assert out == exp
    assert all(len(o) == 6 for o in out)


def test_serve_continuous_gives_the_reference_token_ids(model):
    cfg_t, cfg_j, jp, tp, prompts = model
    out = serve.serve_continuous(tp, cfg_t, prompts, lanes=2, max_len=24,
                                 max_new=6)
    exp = jax_serve.serve_continuous(jp, cfg_j, prompts, lanes=2,
                                     max_len=24, max_new=6)
    assert out == exp
    assert sorted(out) == list(range(5))


def test_generate_samples_from_its_generator(model):
    """Sampling draws from a seeded ``torch.Generator``: the same seed gives
    the same ids, every id a token of the vocabulary.  (Not held to the
    reference: torch cannot reproduce ``jax.random``.)"""
    cfg_t, _, _, tp, prompts = model
    first = serve.generate(tp, cfg_t, prompts, max_new=4, max_len=24,
                           greedy=False, seed=3)
    assert first == serve.generate(tp, cfg_t, prompts, max_new=4,
                                   max_len=24, greedy=False, seed=3)
    assert all(0 <= t < cfg_t.vocab for ids in first for t in ids)


def test_serve_cli_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"continuous"' in proc.stdout.splitlines()[-1]
