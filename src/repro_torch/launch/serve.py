"""Batched serving: prefill a batch of prompts, then decode greedily —
the port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch mamba2-130m --reduced --batch 4 --new-tokens 16

Runs on the card unless ``--device cpu`` is given. An enc-dec (``--arch
seamless-m4t-medium``) is fed 64 stub audio frames per prompt. ``serve_batch``
also takes DTensor weights (placed on a ``DeviceMesh`` by
``launch.sharding``): the prompts are then sharded with ``shard_batch``, the
cache placed with ``serve_cache_shardings``, and the tokens come back whole.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import distribute, serve_cache_shardings
from repro_torch.launch.steps import make_bulk_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.frontends import stub_audio_frames
from repro_torch.models.sharded import is_dtensor, on_mesh, serving_mode


def _on(params, x, dtype=None) -> torch.Tensor:
    """``x`` (a tensor or an array) on the parameters' device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=params["embed"]["table"].device, dtype=dtype)


def _init_cache(cfg, model, params, B: int, capacity: int, frames):
    if cfg.is_encdec:
        with serving_mode(params):
            return model.init_cache(params, _on(params, frames), capacity=capacity)
    cache = model.init_cache(B, capacity=capacity, device=params["embed"]["table"].device)
    if on_mesh(params):
        cache = distribute(cache, serve_cache_shardings(cache, params["embed"]["table"].device_mesh))
    return cache


def _prompts_on(params, prompts) -> torch.Tensor:
    """The (B, S) prompts on the parameters' device, batch-sharded on a mesh."""
    prompts = _on(params, prompts, torch.int32)
    if on_mesh(params):
        mesh = params["embed"]["table"].device_mesh
        prompts = shard_batch({"t": prompts}, mesh, batch_axes=data_axes(mesh))["t"]
    return prompts


def _whole(tokens: torch.Tensor) -> torch.Tensor:
    return tokens.full_tensor() if is_dtensor(tokens) else tokens


def serve_batch(cfg, params, prompts, *, new_tokens: int, frames=None,
                embeds=None) -> torch.Tensor:
    """prompts: (B, S) int → (B, new_tokens) int32 greedy continuations, on
    the parameters' device.

    One ``bulk_prefill_step`` fills the decode cache from the whole prompt
    (its argmax IS the first generated token), then ``serve_step`` extends
    one token at a time. An enc-dec's ``frames`` (B, T, D) are encoded once
    into its cache; a VLM's ``embeds`` (B, P, D) prefix takes positions
    0…P−1, so decode positions start past it."""
    model = build_model(cfg)
    prompts = _prompts_on(params, prompts)
    B, S = prompts.shape
    n_prefix = 0 if embeds is None else embeds.shape[1]
    cache = _init_cache(cfg, model, params, B, n_prefix + S + new_tokens, frames)
    prefill = make_bulk_prefill_step(cfg)
    serve_step = make_serve_step(cfg)
    tok, cache = prefill(params, prompts, cache, None if embeds is None else _on(params, embeds))
    out = [tok]
    for t in range(1, new_tokens):
        tok, cache = serve_step(params, tok, cache, n_prefix + S - 1 + t)
        out.append(tok)
    return _whole(torch.stack(out, dim=1))


def serve_batch_loop(cfg, params, prompts, *, new_tokens: int, frames=None) -> torch.Tensor:
    """Token-at-a-time reference: the prompt is pushed through ``serve_step``
    one position at a time. The equivalence oracle for ``serve_batch``: on
    the card it runs the decode path alone, where ``serve_batch`` prefills
    through the flash_attention (GQA, the enc-dec's decoder) or ssd_scan
    (Mamba2) kernel. (An MoE model agrees only while batch x prompt ≤ 64
    tokens: above that the bulk prefill takes the Switch capacity and drops
    overflow, as the reference's does, where each decode step keeps every
    choice.)"""
    model = build_model(cfg)
    prompts = _prompts_on(params, prompts)
    B, S = prompts.shape
    cache = _init_cache(cfg, model, params, B, S + new_tokens, frames)
    serve_step = make_serve_step(cfg)
    for t in range(1, S):
        _, cache = serve_step(params, prompts[:, t - 1], cache, t - 1)
    out = []
    tok = prompts[:, -1]
    for t in range(new_tokens):
        tok, cache = serve_step(params, tok, cache, S - 1 + t)
        out.append(tok)
    return _whole(torch.stack(out, dim=1))


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
    kwargs = {}
    if cfg.is_encdec:
        kwargs["frames"] = stub_audio_frames(args.seed, cfg, args.batch, 64, device=args.device)
    t0 = time.time()
    out = serve_batch(cfg, params, prompts, new_tokens=args.new_tokens, **kwargs).cpu().numpy()
    dt = time.time() - t0
    tps = args.batch * (args.prompt_len + args.new_tokens) / dt
    print(f"arch={cfg.name} batch={args.batch} tokens/s={tps:.1f}")
    print("continuations:", out[:2].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
