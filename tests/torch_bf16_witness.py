"""bf16 decode against forward in the JAX reference and in the port, on the
CPU, at the Jamba cut's structure (one 8-layer period: 7 Mamba + 1
attention mixer, 4 dense + 4 MoE MLPs of 16 experts, top-2, vocabulary
65,536, d_state 16, scan chunk 64) and a width the CPU holds:

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bf16_witness.py 1024

For d_model D it uses D/128 heads of 128 (one KV head), d_inner 2D and
d_ff 3D, the reference's ``init_lm`` params from seed 0 in bf16 (and the
same values in f32), capacity factor 16 (dropless), batch 2: a 96-token
prefill and 8 decode steps against ``forward`` over all 104 tokens, as
``chip_smoke.py``'s phase 20.  It prints max |diff| / max |logit| of

- the reference's bf16 decode and prefill against its bf16 forward;
- the reference's bf16 forward and decode against its f32 forward;
- the port's bf16 decode and prefill against its own bf16 forward, and its
  bf16 forward against the reference's.

It is a measurement, not a test: nothing is asserted.
"""
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import transformer as jax_T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import decode_parity
from repro_torch.nn import transformer as T

ARCH = "jamba-1.5-large-398b"
BATCH, PREFILL, STEPS = 2, 96, 8


def _cfg(base, d):
    return dataclasses.replace(
        base, name=f"{ARCH}-d{d}", n_layers=8, d_model=d,
        n_heads=max(d // 128, 1), n_kv_heads=1, d_head=128, d_ff=3 * d,
        remat=False, dtype="bfloat16", moe=dataclasses.replace(
            base.moe, capacity_factor=decode_parity.CAPACITY_FACTOR))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _jax_paths(params, cfg, toks):
    """The reference's forward over all tokens, its prefill logits and its
    decode logits."""
    full, _ = jax_T.forward(params, cfg, tokens=toks)
    logits, _, cache = jax_T.forward(params, cfg, tokens=toks[:, :PREFILL],
                                     return_cache=True,
                                     cache_len=PREFILL + STEPS)
    outs = []
    for t in range(PREFILL, PREFILL + STEPS):
        out, cache = jax_T.decode_step(params, cfg, toks[:, t:t + 1], cache,
                                       jnp.int32(t))
        outs.append(out)
    return full, logits, jnp.concatenate(outs, axis=1)


def witness(d: int) -> dict:
    t0 = time.perf_counter()
    cfg_j = _cfg(jax_get_config(ARCH), d)
    cfg_t = _cfg(get_config(ARCH), d)
    p16, _ = jax_T.init_lm(jax.random.PRNGKey(0), cfg_j)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                       if a.dtype == jnp.bfloat16 else a, p16)
    toks_t = decode_parity.tokens(cfg_t, BATCH, PREFILL + STEPS, 0, "cpu")
    toks_j = jnp.asarray(toks_t.numpy())
    full16, pre16, dec16 = _jax_paths(p16, cfg_j, toks_j)
    full32, _, dec32 = _jax_paths(
        p32, dataclasses.replace(cfg_j, dtype="float32"), toks_j)
    params = params_from_jax(p16, "cpu")
    port = decode_parity.measure(params, cfg_t, toks_t, PREFILL)
    with torch.no_grad():
        port_full = T.forward(params, cfg_t, tokens=toks_t)[0].float()
    return {
        "d_model": d, "seconds": time.perf_counter() - t0,
        "max_logit": float(np.abs(np.asarray(full16, np.float32)).max()),
        "reference": {
            "decode_vs_forward": _rel(dec16, full16[:, PREFILL:]),
            "prefill_vs_forward": _rel(pre16, full16[:, :PREFILL]),
            "bf16_forward_vs_f32": _rel(full16, full32),
            "bf16_decode_vs_f32_forward": _rel(dec16, full32[:, PREFILL:]),
            "f32_decode_vs_f32_forward": _rel(dec32, full32[:, PREFILL:])},
        "port": {
            "decode_vs_forward": port["rel"],
            "prefill_vs_forward": port["prefill_rel"],
            "forward_vs_reference": _rel(port_full.numpy(), full16)},
    }


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["256"]:
        print(json.dumps(witness(int(arg))), flush=True)
