"""Plain PyTorch SSD (Mamba2's state-space duality): the CPU path of
``ops.ssd`` and the oracle the CUDA kernel is held against on the card.

``segsum``, ``ssd_chunked`` and ``ssd_sequential`` are the port of the SSD
core of ``repro.models.ssm``; ``repro_torch.models.ssm`` takes them from here
(the model imports the op, and the op imports this file, so the core lives
below both). ``ssd_scan_ref`` and ``ssd_scan_sequential`` are the port of
``repro.kernels.ssd_scan.ref``: the (BH, S, P) layout of the TPU kernel.
``ssd_cluster_ref`` emulates the bf16 CUDA kernel's arithmetic (chunk states
computed apart, chained over the ranks of a cluster and its rounds, bf16
operands where the kernel rounds to bf16) for the CPU tests; nothing on the
card's path calls it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative segment sums: out[..., i, j] = sum x[j+1..i],
    -inf above the diagonal."""
    c = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dA, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD dual form. x (B,S,H,P) dt-premultiplied, dA (B,S,H),
    Bm/Cm (B,S,H,N) (a head-broadcast view will do), initial_state
    (B,H,P,N) or None → (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32).
    Computes in f32, as the reference does; f64 inputs compute in f64 (an
    accurate yardstick where f32 prefix sums lose digits)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk != 0:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Sp = x.shape[1]
    nc = Sp // chunk

    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P).to(acc)
    dAc = dA.reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2).to(acc)   # (B,H,nc,c)
    Bc = Bm.reshape(Bsz, nc, chunk, H, N).to(acc)
    Cc = Cm.reshape(Bsz, nc, chunk, H, N).to(acc)

    A_cumsum = torch.cumsum(dAc, dim=-1)                            # (B,H,nc,c)
    L = torch.exp(segsum(dAc))                                       # (B,H,nc,c,c)
    # 1. intra-chunk (diagonal blocks)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    # 2. chunk states: contribution of each chunk to its final state
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)         # (B,H,nc,c)
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", Bc, decay_states, xc)
    # 3. inter-chunk recurrence: state_c = decay_c * state_{c-1} + states_c
    chunk_decay = torch.exp(A_cumsum[..., -1])                       # (B,H,nc)
    state = (torch.zeros(Bsz, H, P, N, dtype=acc, device=x.device)
             if initial_state is None else initial_state.to(acc))
    prev_states = []                                                 # the state ENTERING each chunk
    for c in range(nc):
        prev_states.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, c]
    prev = torch.stack(prev_states, dim=1)                           # (B,nc,H,P,N)
    # 4. inter-chunk output: y_off[l] = C_l · (decay into l) · prev_state
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, prev, torch.exp(A_cumsum))
    y = (y_diag + y_off).reshape(Bsz, Sp, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_cluster_ref(x, dA, Bm, Cm, chunk: int, initial_state=None, *, cluster: int = 8,
                    bf16_products: bool = True, split: bool = True):
    """The arithmetic of ``csrc/ssd_scan.cu``'s bf16 kernel in plain PyTorch.
    Same arguments and results as ``ssd_chunked``. Per chunk, apart: the
    running sum of dA in f64, each decay exp(f32(difference)); the chunk's
    own state S_c = (x o exp(cums_last - cums))^T . B. Then the scan: a
    cluster of ``cluster`` blocks takes ``cluster`` chunks a round, and the
    state h (the initial state, then the previous round's) is chained
    through them, h <- h * exp(cums_last) + S_c, the value before each step
    being the state entering that chunk. Then y = (C.B^T o L).x +
    (C.state^T) o exp(cums). With ``bf16_products`` every tensor-core
    operand that is not an input is rounded to bf16 as the kernel rounds it:
    the entering state in C.state^T, the masked, decayed scores, and x o
    decay in S_c; with ``split`` each as two bf16 terms, hi = bf16(v) and
    lo = bf16(v - hi), else as one. Products accumulate in f32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if Bm.dim() == 3:
        Bm, Cm = (t[:, :, None].expand(Bsz, S, H, N) for t in (Bm, Cm))
    nc = -(-S // chunk)
    pad = nc * chunk - S
    f32 = torch.float32
    xc = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, H, P)
    Bc, Cc = (F.pad(t.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, H, N)
              for t in (Bm, Cm))
    cums = torch.cumsum(F.pad(dA.double(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, H), dim=2)
    last = cums[:, :, -1]                                             # (B,nc,H) f64

    def bf16(t):
        return t.to(torch.bfloat16).to(f32) if bf16_products else t

    def bf16_pair(t):  # hi + lo, each bf16, summed exactly in f32
        hi = bf16(t)
        return hi + bf16(t - hi) if split else hi

    # phase A, every chunk apart: its own contribution to the state
    v = xc * torch.exp((last[:, :, None] - cums).to(f32))[..., None]
    states = torch.einsum("bcshp,bcshn->bchpn", bf16_pair(v), Bc)  # (B,nc,H,P,N)
    decay = torch.exp(last.to(f32))                                   # (B,nc,H)
    # the scan over the ranks of each round
    h = (torch.zeros(Bsz, H, P, N, dtype=f32) if initial_state is None
         else initial_state.to(f32))
    entering = []
    for rnd in range(-(-nc // cluster)):
        for rank in range(min(cluster, nc - rnd * cluster)):
            c = rnd * cluster + rank
            entering.append(h)
            h = h * decay[:, c, :, None, None] + states[:, c]
    prev = bf16_pair(torch.stack(entering, dim=1))                    # (B,nc,H,P,N)
    # phase B: y = (C.B^T o L).x + (C.state^T) o exp(cums)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, prev) * torch.exp(cums.to(f32))[..., None]
    diff = (cums[:, :, :, None] - cums[:, :, None, :]).to(f32)       # (B,nc,i,j,H)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[None, None, :, :, None]
    L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    scores = bf16_pair(torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_sequential(x, dA, Bm, Cm, initial_state=None):
    """O(S) sequential oracle: h_t = exp(dA_t) h_{t-1} + x_t ⊗ B_t; y_t = C_t·h_t.
    → (y (B,S,H,P) in x's dtype, final h (B,H,P,N) f32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        h = (h * torch.exp(dA[:, t].float())[..., None, None]
             + x[:, t].float()[..., :, None] * Bm[:, t].float()[..., None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_scan_ref(x, dA, Bm, Cm, *, chunk: int = 256) -> torch.Tensor:
    """(BH,S,P)-layout wrapper over ssd_chunked (adds a singleton head dim)."""
    y, _ = ssd_chunked(x[:, :, None], dA[:, :, None], Bm[:, :, None], Cm[:, :, None], chunk)
    return y[:, :, 0]


def ssd_scan_sequential(x, dA, Bm, Cm) -> torch.Tensor:
    y, _ = ssd_sequential(x[:, :, None], dA[:, :, None], Bm[:, :, None], Cm[:, :, None])
    return y[:, :, 0]
