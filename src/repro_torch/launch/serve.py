"""Batched serving: prefill a batch of prompts, then decode greedily —
the port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch mamba2-130m --reduced --batch 4 --new-tokens 16

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_bulk_prefill_step, make_serve_step
from repro_torch.models import build_model


def _prompts_on(params, prompts) -> torch.Tensor:
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.asarray(prompts))
    return prompts.to(device=params["embed"]["table"].device, dtype=torch.int32)


def serve_batch(cfg, params, prompts, *, new_tokens: int) -> torch.Tensor:
    """prompts: (B, S) int → (B, new_tokens) int32 greedy continuations, on
    the parameters' device.

    One ``bulk_prefill_step`` fills the decode cache from the whole prompt
    (its argmax IS the first generated token), then ``serve_step`` extends
    one token at a time."""
    model = build_model(cfg)
    prompts = _prompts_on(params, prompts)
    B, S = prompts.shape
    cache = model.init_cache(B, capacity=S + new_tokens, device=prompts.device)
    prefill = make_bulk_prefill_step(cfg)
    serve_step = make_serve_step(cfg)
    tok, cache = prefill(params, prompts, cache)
    out = [tok]
    for t in range(1, new_tokens):
        tok, cache = serve_step(params, tok, cache, S - 1 + t)
        out.append(tok)
    return torch.stack(out, dim=1)


def serve_batch_loop(cfg, params, prompts, *, new_tokens: int) -> torch.Tensor:
    """Token-at-a-time reference: the prompt is pushed through ``serve_step``
    one position at a time. The equivalence oracle for ``serve_batch``: on
    the card it runs the decode path alone, where ``serve_batch`` prefills
    through the flash_attention (GQA) or ssd_scan (Mamba2) kernel. (An MoE
    model agrees only while batch x prompt ≤ 64 tokens: above that the bulk
    prefill takes the Switch capacity and drops overflow, as the
    reference's does, where each decode step keeps every choice.)"""
    model = build_model(cfg)
    prompts = _prompts_on(params, prompts)
    B, S = prompts.shape
    cache = model.init_cache(B, capacity=S + new_tokens, device=prompts.device)
    serve_step = make_serve_step(cfg)
    for t in range(1, S):
        _, cache = serve_step(params, prompts[:, t - 1], cache, t - 1)
    out = []
    tok = prompts[:, -1]
    for t in range(new_tokens):
        tok, cache = serve_step(params, tok, cache, S - 1 + t)
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = build_model(cfg).init(args.seed, device=args.device)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    t0 = time.time()
    out = serve_batch(cfg, params, prompts, new_tokens=args.new_tokens).cpu().numpy()
    dt = time.time() - t0
    tps = args.batch * (args.prompt_len + args.new_tokens) / dt
    print(f"arch={cfg.name} batch={args.batch} tokens/s={tps:.1f}")
    print("continuations:", out[:2].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
