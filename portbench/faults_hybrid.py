"""Faults of a hybrid model's attention, planted to show that its cell's
check catches them (``faults.py``'s, for the layers the other cells lack).
Each takes a run's dict of the program's objects and breaks one in place.
Used by the fault tests and by ``portbench.probe_hybrid``; a benchmark run
plants none."""
from __future__ import annotations

import torch


def attention_zeroed(objs: dict) -> None:
    """Serving: every attention layer's output is zero (its output projection
    zeroed in the deployed weights)."""
    blocks = objs["node"]._deployed.params["blocks"]
    with torch.no_grad():
        for key, block in blocks.items():
            if key.endswith("_attn"):
                block["attn"]["wo"]["w"].zero_()


def attention_scale_default(objs: dict) -> None:
    """Serving: scores scaled by 1/sqrt(head_dim), as if the model's
    ``attention_multiplier`` were unset (the node's steps rebuilt without it)."""
    from repro_torch.launch.steps import make_bulk_prefill_step, make_serve_step

    node = objs["node"]
    cfg = node.cfg.replace(attention_multiplier=0.0)
    node._prefill = make_bulk_prefill_step(cfg)
    node._serve_step = make_serve_step(cfg)


FAULTS = {"attention_zeroed": attention_zeroed,
          "attention_scale_default": attention_scale_default}
