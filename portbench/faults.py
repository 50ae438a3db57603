"""Faults planted under a run's timed path, to show that the check catches
them: each takes a run's dict of the program's objects and breaks one of
them in place. Used by the fault tests and by ``portbench.probe``; a
benchmark run plants none."""
from __future__ import annotations

import copy

import torch

from portbench import harness


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in harness.flat_paths(tree).values() if isinstance(t, torch.Tensor)]


def frozen_step(objs: dict) -> None:
    """Training: every step hands back the state it was given, unchanged."""
    trainer = objs["trainer"]
    step = trainer._train_step

    def frozen(params, opt_state, batch, rng):
        saved = [t.clone() for t in _tensors(params) + _tensors(opt_state)]
        _, _, metrics = step(params, opt_state, batch, rng)
        with torch.no_grad():
            for t, s in zip(_tensors(params) + _tensors(opt_state), saved):
                t.copy_(s)
        return params, opt_state, metrics

    trainer._train_step = frozen


def half_batch(objs: dict) -> None:
    """Training: each step leaves out half of its batch (the mean is taken
    over the rest). Serving: the second half of a batch is answered with the
    first half's prompts."""
    if "trainer" in objs:
        trainer = objs["trainer"]
        step = trainer._train_step

        def half(params, opt_state, batch, rng):
            rows = len(batch["y"]) // 2
            return step(params, opt_state, {k: v[:rows] for k, v in batch.items()}, rng)

        trainer._train_step = half
        return
    node = objs["node"]
    prefill = node._prefill

    def half_prefill(params, prompts, cache, *rest):
        rows = prompts.shape[0] // 2
        prompts = torch.cat([prompts[:rows], prompts[:prompts.shape[0] - rows]])
        return prefill(params, prompts, cache, *rest)

    node._prefill = half_prefill


def altered(objs: dict) -> None:
    """An answer altered where it is produced: one element of every aggregate
    (training), one token of every batch (serving)."""
    if "strategy" in objs:
        strategy = objs["strategy"]
        combine = strategy._combine

        def altered_combine(*args, **kwargs):
            out = combine(*args, **kwargs)
            out[0] += 1.0
            return out

        strategy._combine = altered_combine
        return
    node = objs["node"]
    generate = node._generate_on
    vocab = node.cfg.vocab_size

    def altered_generate(*args):
        tokens, meta = generate(*args)
        tokens = tokens.copy()
        tokens[0, -1] = (tokens[0, -1] + 1) % vocab
        return tokens, meta

    node._generate_on = altered_generate


def frozen_state(objs: dict) -> None:
    """Serving: every decode step hands back the cache it was given,
    unchanged."""
    node = objs["node"]
    step = node._serve_step

    def frozen(params, token, cache, pos):
        saved = [t.clone() for t in _tensors(cache)]
        out, cache = step(params, token, cache, pos)
        with torch.no_grad():
            for t, s in zip(_tensors(cache), saved):
                t.copy_(s)
        return out, cache

    node._serve_step = frozen


def stale_push(objs: dict) -> None:
    """Training: each round pushes the parameters the client handed over at
    the round before, not those it has now (the first round pushes its own)."""
    node = objs["node"]
    push = node._push
    last: dict = {}

    def stale(params, num_examples, metrics=None):
        pushed = last.get("params", params)
        last["params"] = copy.deepcopy(params)  # on the CPU the host tree shares memory
        return push(pushed, num_examples, metrics)

    node._push = stale


def blocked_watcher(objs: dict) -> None:
    """Serving: the store watcher finds nothing new from now on, so the
    replica keeps serving the set it has and never swaps again."""
    objs["node"].watcher.poll = lambda: None


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch, "altered": altered,
          "frozen_state": frozen_state, "stale_push": stale_push,
          "blocked_watcher": blocked_watcher}
