"""Public SSD op in model layout with device dispatch: a CPU tensor takes the
plain ``ssd_chunked`` in ``ref.py``; a CUDA tensor takes the hand-written
kernel, or raises. There is no flag or fallback that routes a CUDA tensor
elsewhere.

Unlike the reference's ``ops.ssd`` (which returns y only), the op keeps
``ssd_chunked``'s contract: an optional initial state in, the final state
out, so the Mamba2 prefill can run on it. B and C may be (B, S, N), shared by
every head (the model's case, read in place on the card), or (B, S, H, N).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import local_only

from . import kernel
from .ref import ssd_chunked


def ssd(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
        chunk: int = 256, initial_state: torch.Tensor | None = None,
        state_out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dA (B,S,H), Bm/Cm (B,S,N) or (B,S,H,N), initial_state
    (B,H,P,N) f32 or None → (y (B,S,H,P), final_state (B,H,P,N) f32). With
    ``state_out`` the final state is written into it (it may be
    ``initial_state`` itself: a decode cache updated in place)."""
    local_only("ssd_scan", x, dA, Bm, Cm, initial_state, state_out)
    if x.is_cuda:
        return kernel.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=initial_state,
                          state_out=state_out)
    if Bm.dim() == 3:
        shape = (*Bm.shape[:2], x.shape[2], Bm.shape[-1])
        Bm, Cm = Bm[:, :, None].expand(shape), Cm[:, :, None].expand(shape)
    y, state = ssd_chunked(x, dA, Bm, Cm, chunk, initial_state=initial_state)
    if state_out is not None:
        state = state_out.copy_(state)
    return y, state
