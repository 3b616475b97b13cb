"""Batched LM serving demo: teacher-force a batch of prompts through the
KV-cache decode step, then greedy-decode.  (For the streaming
*aggregation* service demo see ``repro_torch.examples.serve_agg``.)

  python -m repro_torch.examples.serve_lm --arch qwen3-0.6b --tokens 32
  python -m repro_torch.examples.serve_lm --arch rwkv6-1.6b  # O(1)-state
  python -m repro_torch.examples.serve_lm --device cpu

Each arch runs its reduced smoke config with random weights (seed 0).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import configs, devices
from repro_torch.launch import steps
from repro_torch.models import model as M


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window size (ring-buffer KV cache)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = devices.resolve(args.device)
    model = configs.load_smoke(args.arch)
    if args.window:
        model = dataclasses.replace(model, sliding_window=args.window)
    params = M.init_model(model, seed=0, device=dev)

    b = args.batch
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, model.vocab_size, (b, args.prompt_len),
                           generator=g, device=dev, dtype=torch.int32)

    # prefill by teacher-forcing the prompt through decode steps (exact,
    # and the same cache path the decode takes)
    cache = M.init_cache(model, b, args.prompt_len + args.tokens + 1,
                         device=dev)
    decode = steps.make_decode_step(model, dev)
    t0 = time.time()
    nxt = None
    for t in range(args.prompt_len):
        nxt, cache = decode(params, prompt[:, t:t + 1], cache)
    _sync(dev)
    t_prefill = time.time() - t0

    out = [nxt]
    t0 = time.time()
    for _ in range(args.tokens - 1):
        nxt, cache = decode(params, out[-1], cache)
        out.append(nxt)
    _sync(dev)
    t_decode = time.time() - t0

    gen = torch.cat(out, dim=1).cpu()
    print(f"arch={model.name} batch={b} prompt={args.prompt_len} "
          f"generated={args.tokens} device={dev}")
    print(f"prefill: {t_prefill*1e3:.0f} ms   decode: "
          f"{t_decode/max(args.tokens-1,1)*1e3:.1f} ms/token")
    for i in range(min(b, 2)):
        print(f"  seq{i}: {gen[i].tolist()[:16]} ...")
    if not bool(((gen >= 0) & (gen < model.padded_vocab)).all()):
        print("FAIL: a generated token lies outside the vocabulary",
              file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
