"""Batches of prompts for a closed loop, from a mix's parameters and a seed.

Every seed gets the same set of sizes in another order: the prompt lengths
and the new-token counts are the ``sizes`` quantiles of log-uniform draws
between their bounds, and the seed shuffles each list and the token ids.
Where a window runs whole cycles of ``sizes`` batches, its work does not
depend on the seed; where it ends inside a cycle, the seed decides which
sizes of that cycle fall in it."""
from __future__ import annotations

import math

import numpy as np


def log_grid(lo: int, hi: int, n: int) -> list[int]:
    """n midpoint quantiles of a log-uniform law on [lo, hi], rounded."""
    if n == 1 or lo == hi:
        return [lo] * n
    return [int(round(math.exp(math.log(lo) + (k + 0.5) / n * (math.log(hi) - math.log(lo)))))
            for k in range(n)]


def schedule(mix: dict, seed: int):
    """Endless (prompt length, new tokens) pairs: each cycle of ``sizes``
    batches takes every grid size once, in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    n = mix["sizes"]
    prompts = log_grid(*mix["prompt_tokens"], n)
    news = log_grid(*mix["new_tokens"], n)
    while True:
        for s, t in zip(rng.permutation(prompts), rng.permutation(news)):
            yield int(s), int(t)


def prompt_lengths(mix: dict) -> list[int]:
    """Every prompt length a run may send: the lengths to warm up."""
    return sorted(set(log_grid(*mix["prompt_tokens"], mix["sizes"])))


def prompt_ids(rng: np.random.Generator, batch: int, length: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=(batch, length), dtype=np.int64).astype(np.int32)
