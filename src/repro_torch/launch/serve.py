"""Batched LM serving, the counterpart of ``repro/launch/serve.py``:
lockstep batched generation and continuous batching over a shared KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b-1chip
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Every prefill runs the whole prompt through ``transformer.forward``, whose
attention is K7 and whose Mamba conv1d is K8 on the card; decode steps are
plain torch (``attention.decode``, ``mamba.decode``).  The MoE layer's
expert products are K9 in both.  A lane's refill
copies every entry of its packed prefill cache into the lane's slot: K/V
for attention, conv and ssm states for Mamba.  Weights are random, drawn
from seed 0.  Greedy
decoding gives the reference's token ids on the same params and prompts;
sampling draws from a ``torch.Generator``, which cannot reproduce
``jax.random`` and is not held to it.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels import attention as k7
from repro_torch.kernels import conv1d_causal as k8
from repro_torch.kernels import moe_gmm as k9
from repro_torch.nn import transformer as T


def _next_tokens(logits, greedy: bool, generator) -> torch.Tensor:
    """(B,1,V) logits -> (B,1) token ids."""
    if greedy:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits[:, 0].float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def generate(params, cfg, prompts, *, max_new: int = 16, max_len: int = 64,
             greedy: bool = True, seed: int = 0):
    """prompts: list of 1-D int arrays.  Left-pads them to one length,
    prefills the batch in lockstep, then decodes ``max_new`` tokens per
    prompt in lockstep.  Returns the list of generated ids."""
    device = params["embed"].device
    b = len(prompts)
    plen = max(len(p) for p in prompts)
    toks = np.zeros((b, plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p          # left-pad (lockstep decode)
    logits, _, cache = T.forward(params, cfg,
                                 tokens=torch.from_numpy(toks).to(device),
                                 return_cache=True, cache_len=max_len)
    generator = torch.Generator(device=device).manual_seed(seed)
    out = [[] for _ in range(b)]
    last = logits[:, -1:, :].argmax(dim=-1)
    for t in range(max_new):
        for i, tok in enumerate(last[:, 0].tolist()):
            out[i].append(tok)
        logits, cache = T.decode_step(params, cfg, last, cache, plen + t)
        last = _next_tokens(logits, greedy, generator)
    return out


def serve_continuous(params, cfg, request_queue, *, lanes: int = 4,
                     max_len: int = 64, max_new: int = 16, eos: int = 0,
                     calls: dict | None = None):
    """Continuous batching: ``lanes`` sequences decode in lockstep at their
    own positions; a lane that finishes (EOS, ``max_new`` tokens or a full
    cache) is refilled at once from the queue by a batch-1 prefill of the
    next prompt written into that lane's cache slot.  Greedy.  ``calls``,
    when given, counts the ``transformer.forward`` and ``decode_step``
    calls made, under "forward" and "decode_step".  Returns
    {request_id: generated ids}."""
    calls = {} if calls is None else calls
    calls.setdefault("forward", 0)
    calls.setdefault("decode_step", 0)
    device = params["embed"].device
    queue = list(enumerate(request_queue))
    results: dict[int, list[int]] = {}
    lane_req = [-1] * lanes
    lane_new = [0] * lanes
    cache = T.init_cache(cfg, lanes, max_len, device=device)
    pos = np.zeros(lanes, np.int64)          # per-lane decode position
    cur = np.zeros((lanes, 1), np.int64)

    def refill(lane):
        if not queue:
            lane_req[lane] = -1
            return
        rid, prompt = queue.pop(0)
        lane_req[lane] = rid
        results[rid] = []
        # prefill just this lane (batch-1 forward), write its cache slot
        tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=device)[None, :]
        logits, _, one = T.forward(params, cfg, tokens=tokens,
                                   return_cache=True, cache_len=max_len)
        calls["forward"] += 1
        for name, entry in one.items():
            for state, t in entry.items():
                cache[name][state][:, lane:lane + 1] = t
        pos[lane] = len(prompt)
        first = int(logits[0, -1].argmax())
        results[rid].append(first)            # first token comes from prefill
        lane_new[lane] = 1
        cur[lane, 0] = first
        if first == eos or max_new <= 1:
            refill(lane)

    for lane in range(lanes):
        refill(lane)

    while any(r >= 0 for r in lane_req):
        logits, cache = T.decode_step(params, cfg,
                                      torch.from_numpy(cur).to(device), cache,
                                      torch.from_numpy(pos).to(device))
        calls["decode_step"] += 1
        nxt = logits.argmax(dim=-1).cpu().numpy()
        for lane in range(lanes):
            rid = lane_req[lane]
            if rid < 0:
                continue
            tok = int(nxt[lane, 0])
            results[rid].append(tok)
            lane_new[lane] += 1
            pos[lane] += 1
            cur[lane, 0] = tok
            done = (tok == eos or lane_new[lane] >= max_new
                    or pos[lane] >= max_len - 1)
            if done:
                refill(lane)
    return results


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (tiny widths, f32)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(args.device)
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(3, 10))
               for _ in range(args.requests)]
    max_len = max(len(p) for p in prompts) + args.max_new + 1

    k7.launches = k8.launches = k9.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    outs = generate(params, cfg, prompts, max_new=args.max_new,
                    max_len=max_len)
    _sync(device)
    gen_s = time.perf_counter() - t0
    gen_launches = k7.launches, k8.launches, k9.launches
    for i, o in enumerate(outs):
        print(f"req{i}: prompt={[int(t) for t in prompts[i][:6]]}... -> "
              f"{o[:8]}...")

    k7.launches = k8.launches = k9.launches = 0
    t0 = time.perf_counter()
    results = serve_continuous(params, cfg, prompts, max_len=max_len,
                               max_new=args.max_new, eos=-1)
    _sync(device)
    cont_s = time.perf_counter() - t0
    tokens = sum(len(r) for r in results.values())
    summary = {
        "arch": cfg.name, "device": str(device), "dtype": cfg.dtype,
        "requests": args.requests, "max_new": args.max_new,
        "generate": {"tokens": args.requests * args.max_new,
                     "seconds": gen_s,
                     "tokens_per_s": args.requests * args.max_new / gen_s,
                     "flash_attention_launches": gen_launches[0],
                     "conv1d_causal_launches": gen_launches[1],
                     "moe_gmm_launches": gen_launches[2]},
        "continuous": {"tokens": tokens,
                       "seconds": cont_s, "tokens_per_s": tokens / cont_s,
                       "flash_attention_launches": k7.launches,
                       "conv1d_causal_launches": k8.launches,
                       "moe_gmm_launches": k9.launches},
    }
    print(json.dumps(summary))
    if len(results) != args.requests:
        raise RuntimeError(f"served {len(results)} of {args.requests}")
    return summary


if __name__ == "__main__":
    main()
