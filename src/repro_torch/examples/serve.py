"""Batched decode serving: prefill + KV-cache decode loop on one shared
position clock.

Serves a smoke-sized LM: requests arrive with prompts, get batched, prefilled
(decode replays the prompt token by token to fill the cache, which is exact
for these lengths), then decoded greedily for N tokens per request.  Every
step passes one scalar position to the serve step, so all four slots write
and attend at the same clock.  The counterpart of ``examples/serve.py``:
llama3.2-1b smoke, prompts of 8, 12, 5 and 9 tokens, 24 generated tokens.
On the card each step's attention runs through the flash-attention kernel
(f32: its CUDA-core variant).

  python -m repro_torch.examples.serve               # the card
  python -m repro_torch.examples.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..launch.serve import resolve_device
from ..launch.steps import make_serve_step
from ..models import model as M

PROMPT_LENS = (8, 12, 5, 9)
MAX_LEN, GEN_LEN = 96, 24


def serve_batch(cfg, params):
    """Greedy tokens of each request (``GEN_LEN`` each) and the seconds the
    loop took.  ``params`` lie on the device the loop runs on; the prompts
    are drawn from numpy's ``default_rng(0)``, as the JAX example draws
    them."""
    device = params["embed"]["tokens"].device
    batch = len(PROMPT_LENS)
    params = M.prepare_params(cfg, params)
    serve = make_serve_step(cfg)

    # --- batched requests (different prompt lengths, left-aligned) ---
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    cache = M.init_cache(cfg, batch, MAX_LEN, device)
    # Prefill by stepping the prompts through the decode path (batched;
    # shorter prompts pad with token 0 and get overwritten by generation).
    maxp = max(PROMPT_LENS)
    padded = np.zeros((batch, maxp), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tok = torch.from_numpy(padded[:, :1]).to(device)
    out_tokens = [[] for _ in range(batch)]
    with torch.inference_mode():
        for pos in range(maxp + GEN_LEN - 1):
            nxt, cache = serve(params, cache, tok, pos)
            if pos + 1 < maxp:
                # still consuming prompts: teacher-force next prompt column
                tok = torch.from_numpy(padded[:, pos + 1:pos + 2]).to(device)
            else:
                tok = nxt
                for i, t in enumerate(nxt[:, 0].tolist()):
                    out_tokens[i].append(t)
    return out_tokens, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("llama3_2_1b")
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    out_tokens, dt = serve_batch(cfg, params)

    total_steps = max(PROMPT_LENS) + GEN_LEN - 1
    print(f"served {len(PROMPT_LENS)} requests, {total_steps} decode steps "
          f"in {dt:.2f}s ({dt / total_steps * 1e3:.1f} ms/step batched) on "
          f"{device}")
    for i, n in enumerate(PROMPT_LENS):
        print(f"req{i} (prompt {n} toks) -> {out_tokens[i][:12]}...")
    return out_tokens


if __name__ == "__main__":
    main()
