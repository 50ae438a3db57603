"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), holds each one against its plain PyTorch version at
the main paths' shapes and times it beside its bound, then drives the port's
main paths end to end:

* the federation loop: four threaded clients (two FedAvg, two FedAdam) train
  the GroupNorm ResNet-18 at full width and federate through a disk folder
  (``fed_agg``, ``fed_opt``);
* the federation plane: the same four clients on a two-group ``shard2+``
  gossip store, group 0 writing ``delta(chain=4)`` and group 1
  ``topk(adaptive)`` blobs, each group folding the other's summary in as a
  pseudo-peer; then a publisher pushes eight frozen-backbone fine-tune steps
  (classifier head and GroupNorm affines) through ``delta(chain=4)``, each
  rebuilt bit for bit by a fresh reader;
* federated LM training, the paper's §4.4: three threaded silos train
  pythia-14m at full width through ``python -m repro_torch.launch.train``'s
  ``main`` (one FedAvg run, one FedAdam run: ``fed_agg``, ``fed_opt``);
  then a few ``make_train_step`` steps of mamba2-130m at full width (bf16,
  all 24 layers), and one step held against the plain CPU path in f32;
* the serving tier: a publisher pushes granite-3-2b weights (full width,
  bf16, made from a seed) to a store, ``api.serve`` deploys them, batches of
  8 prompts x 512 tokens decode 64 greedy tokens each, and a second push
  hot-swaps new weights in while traffic runs (``flash_attention`` prefill,
  ``decode_attention`` per token);
* the same for the reference's serving default, mamba2-130m at full width
  (bf16, all 24 layers), with batches of 8 prompts x 2048 tokens (``ssd_scan``
  between ``ssm_prefill_in`` and ``ssm_prefill_out`` in every layer of the
  bulk prefill; those two also checked and timed at the long-prompt
  benchmark cells' shapes);
* the two LM examples: ``repro_torch.examples.federated_llm`` at its full
  widths (three async nodes train a 63.68M-parameter LoRA decoder through a
  ``delta(chain=4)`` store, then federate the adapters alone) and
  ``repro_torch.examples.federated_serving`` whole (two trainers federate
  pythia-14m while a serving node hot-swaps their aggregates under traffic,
  its served tokens held against the plain f32 model);
* the nine other example twins (``repro_torch.examples``), each through its
  ``main`` at the reference's defaults: transport pipelines and FedAvgM
  recovery, Mamba2 serving with three strategies on one store (also
  ``serve_demo`` at mamba2-130m's published config: a 12-token prompt,
  shorter than one chunk, through ``ssd_scan`` in every layer), sync vs
  async MnistCNN threads, spawned clients (one SIGKILLed), sharded and
  hierarchical gossip, an observed fleet (also at ResNet-18's parameter
  count), a chaos soak and an elastic fleet, each aggregating with
  ``fed_agg``;
* the rest of the decoder zoo through the serving path, at full width in
  bf16 with depth cut: llama4-scout (MoE), recurrentgemma-9b (RG-LRU and
  windowed attention) and minicpm3-4b (MLA, plain attention), each also held
  bulk-vs-loop and card-vs-CPU;
* the encoder-decoder and the VLM prefix through ``serve_batch`` at their
  published configs (bf16): seamless-m4t-medium on 1,024 stub audio frames
  an utterance, internvl2-1b on 256 stub patch embeddings + 256 text
  tokens (``flash_attention`` in the decoder's prefill, ``decode_attention``
  a token), each held against the plain f32 model, in f32 at two layers
  (bulk == loop; prefill == ``apply``), and card-vs-CPU;
* grok-1, whose logit softcap takes the capped plain attention on every
  device as the reference routes it: full width, one layer, weights drawn on
  the card, through ``serve_batch`` (no attention kernel may launch), and
  card-vs-CPU at ``reduced()``;
* the launch layer: ``api.serve(mesh=)`` on a world-1 NCCL mesh in a child
  process (granite-3-2b at 8 layers, mamba2-130m whole; each kernel on the
  local shards through ``local_map``, tokens equal to the mesh-less path's),
  ``launch.costs.step_costs`` of the served steps beside their measured p50s
  (the share of the roofline), and ``python -m repro_torch.launch.dryrun`` on
  the fake 16 x 16 mesh (CPU only, beside `serving_zoo`).

Prints one JSON line per phase, then the card's name and power limit, the
kernel summary and, last, ``{"ok": true, "device": {...}}``. Any failure
raises (exit code != 0). Without a CUDA card, or without the repository
beside it, it exits non-zero before printing any result.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Main-path shapes: the two paper models' parameter counts.
N_MNIST, N_RESNET18 = 421_642, 11_176_970
# K = 4 at N_RESNET18: the federation phases; K = 8: a fleet_soak node's own + 7 pulled peers
CHECK_SHAPES = [(2, N_MNIST), (4, N_RESNET18), (8, N_RESNET18), (8, 8193), (65, 8192),
                (200, 4000), (3, 7)]
TIME_SHAPES = [(4, N_RESNET18), (16, N_RESNET18)]
FED_CLIENTS, FED_EPOCHS, FED_STEPS, FED_BATCH = 4, 3, 8, 64
# The sharded federation: two gossip groups, one transport each (no envelope:
# the card's machine has no zstd module, and npz's deflate would time zlib);
# a publisher's frozen-backbone fine-tune touches the head and GN affines only.
GOSSIP_TRANSPORTS = {0: "delta(chain=4)", 1: "topk(adaptive)"}
PUBLISH_PUSHES, PUBLISH_FAMILY = 8, {"head_and_gn": r"^fc/|(^|/)gn[0-9]*/"}
OPT_HP = dict(lr=0.3, b1=0.9, b2=0.95, tau=1e-2)

# Federated LM training (paper §4.4): pythia-14m at every published width,
# the vocab cut to the launcher's --vocab default of 512; LM_CLIENTS threaded
# silos, LM_EPOCHS x LM_STEPS steps of LM_BATCH x LM_SEQ tokens each. LM_LR
# in place of the launcher's 2e-5: a cut run takes 60 steps, and bf16
# weights near 0.09 have a ulp of 4.9e-4, so steps of 2e-5 round away.
LM_ARCH, LM_CLIENTS, LM_EPOCHS, LM_STEPS, LM_BATCH, LM_SEQ, LM_LR = (
    "pythia-14m", 3, 3, 20, 8, 128, "1e-3")
# Mamba2 training: mamba2-130m at full width (bf16 weights, f32 adamw
# moments), TRAIN_SSM_STEPS steps on one repeated batch of TRAIN_SSM_B x
# TRAIN_SSM_S tokens at TRAIN_SSM_LR (a bf16 weight near 0.036 has a ulp of
# 2.4e-4: the default 2e-5 would round away); one step is held against the
# CPU in f32 at TRAIN_SSM_CHECK_LAYERS layers.
TRAIN_SSM_ARCH, TRAIN_SSM_B, TRAIN_SSM_S, TRAIN_SSM_STEPS, TRAIN_SSM_LR = (
    "mamba2-130m", 2, 512, 4, 1e-3)
TRAIN_SSM_CHECK_LAYERS = 2
# card vs CPU, f32: the loss (relative), adamw's first m = 0.1 * grad (relative
# to each leaf's largest entry: the f32 running sums of dA reach ~-1e4 at
# A = -(1..24), where one ulp is 1e-3, and the card's cumsum adds in another
# order), and the weights after the step (Adam's first step is about
# +-lr * sign(grad), so a gradient entry at rounding noise can flip: 2 lr)
TRAIN_SSM_TOL = {"loss_rel": 1e-4, "grad_rel": 2e-3, "param_abs": 2 * TRAIN_SSM_LR + 1e-6}

# The serving path: granite-3-2b at full width (bf16), batches of SERVE_B
# prompts x SERVE_S tokens decoding SERVE_NEW greedy tokens each; the
# consistency check runs the same widths in f32 at CONSIST_LAYERS layers.
SERVE_ARCH, SERVE_B, SERVE_S, SERVE_NEW = "granite-3-2b", 8, 512, 64
CONSIST_LAYERS, CONSIST_B, CONSIST_S, CONSIST_NEW = 4, 4, 128, 16
# Mamba2 serving: mamba2-130m at full width (bf16), batches of SSM_B prompts x
# SSM_S tokens decoding SSM_NEW greedy tokens; its consistency check runs the
# same widths in f32 at CONSIST_LAYERS layers, with a ragged S (1000 = 3
# chunks of 256 and a partial one).
SSM_ARCH, SSM_B, SSM_S, SSM_NEW = "mamba2-130m", 8, 2048, 64
SSM_CONSIST_B, SSM_CONSIST_S, SSM_CONSIST_NEW = 4, 1000, 16
# The rest of the decoder zoo, served as `serving` serves granite: full width,
# bf16, weights from a seed, batches of ZOO_B prompts x the model's prompt
# length decoding ZOO_NEW greedy tokens, one hot swap. Depth is the only cut
# (arch, layers, prompt): llama4-scout (MoE) to one layer — the serving path
# holds ~20 B of host memory a parameter (two f32 standby buffers, the store's
# f32 blob and its decoded flat; granite's 2.53 B parameters peaked at 60 GB
# RSS), so two layers' 5.44 B parameters would need ~110 GB of the 96 GiB
# host; recurrentgemma-9b to one (rglru, rglru, attn) group, its 3,072-token
# prompt past the 2,048 window, so the window mask and the ring's wrap both
# run; minicpm3-4b (MLA) to 4 layers.
ZOO = [("llama4-scout-17b-a16e", 1, 512), ("recurrentgemma-9b", 3, 3072), ("minicpm3-4b", 4, 512)]
ZOO_B, ZOO_NEW = 4, 32
# The enc-dec and the VLM prefix, served through `serve_batch` at full width
# and depth in bf16, weights and stub inputs from a seed: seamless-m4t-medium
# with MODAL_B utterances of its 1,024 stub frames (`frontend_tokens`) and
# ENCDEC_S-token prompts; internvl2-1b with MODAL_B requests of its 256 stub
# patch embeddings and PREFIX_S text tokens; MODAL_NEW greedy tokens each,
# MODAL_BATCHES batches. Their f32 checks at full width cut the depth to
# MODAL_CHECK_LAYERS (decoder; and encoder, for the enc-dec).
ENCDEC_ARCH, PREFIX_ARCH = "seamless-m4t-medium", "internvl2-1b"
MODAL_B, ENCDEC_S, PREFIX_S, MODAL_NEW, MODAL_BATCHES = ZOO_B, 64, 256, 32, 3
MODAL_CHECK_LAYERS = 2
# The zoo's GQA attention layers, where both kernels are also timed (arch, S,
# KV, G, hd, window, ring C): llama4-scout's, recurrentgemma-9b's, the
# enc-dec's decoder (prompt; ring of prompt + new tokens) and the VLM's
# (256 patches + text).
ZOO_ATTENTION = [("llama4-scout-17b-a16e", 512, 8, 5, 128, 0, 512 + ZOO_NEW),
                 ("recurrentgemma-9b", 3072, 1, 16, 256, 2048, 2048),
                 (ENCDEC_ARCH, ENCDEC_S, 16, 1, 64, 0, ENCDEC_S + MODAL_NEW),
                 (PREFIX_ARCH, 256 + PREFIX_S, 2, 7, 64, 0, 256 + PREFIX_S + MODAL_NEW)]
# Bulk prefill vs the token-at-a-time loop on the card, f32 at full width and
# one pattern group: ZOO_LOOP_B prompts of each model's ZOO_LOOP_S tokens. The
# MoE prompt keeps B x S at 64 tokens: above that the bulk prefill takes the
# Switch capacity and drops, where each loop step keeps every choice (the
# reference's bulk-vs-loop test leaves MoE out). recurrentgemma's window is
# cut to ZOO_LOOP_WINDOW there so the ring wraps within a short loop.
ZOO_LOOP_B, ZOO_LOOP_NEW, ZOO_LOOP_WINDOW = 2, 8, 256
ZOO_LOOP_S = {"llama4-scout-17b-a16e": 32, "recurrentgemma-9b": 300, "minicpm3-4b": 64}
# Card vs CPU at reduced(), f32: greedy tokens equal, the prefill's logits
# within ZOO_CPU_TOL of their largest magnitude. 2 x 80 tokens: past the
# reduced window of 64 and past the MoE's 64-token capacity rule.
ZOO_CPU_B, ZOO_CPU_S, ZOO_CPU_NEW, ZOO_CPU_TOL = 2, 80, 8, 2e-5
# grok-1 (logit softcap 30: plain capped attention on every device, as the
# reference routes it) at full width, bf16, one layer (5.73 B parameters,
# 11.5 GB, drawn on the card: the ~22 B of host a parameter that ServingNode
# holds would not fit), through serve_batch: GROK_B prompts x GROK_S tokens,
# GROK_NEW greedy tokens.
GROK_ARCH, GROK_LAYERS, GROK_B, GROK_S, GROK_NEW = "grok-1-314b", 1, 4, 256, 16
# Serving on a device mesh: a world-1 NCCL group (FileStore) and its (1, 1)
# host mesh, in a child process; `serving`'s path with mesh= (arch, layers,
# batch, prompt, new tokens). granite-3-2b cut to MESH_GRANITE_LAYERS layers
# (DTensor dispatch costs host time in every op), mamba2-130m whole. Its
# prefill logits against the mesh-less path's within MESH_LOGITS_TOL of their
# largest (f32, MESH_CHECK_B x MESH_CHECK_S prompts).
MESH_GRANITE_LAYERS = 8
MESH_SERVING = [(SERVE_ARCH, MESH_GRANITE_LAYERS, SERVE_B, SERVE_S, SERVE_NEW),
                (SSM_ARCH, None, SSM_B, SSM_S, SSM_NEW)]
MESH_LOGITS_TOL, MESH_CHECK_B, MESH_CHECK_S = 1e-6, 2, 256
MESH_CHILD_TIMEOUT_S = 400
# Whole-step costs (launch.costs.step_costs, meta tensors) of the serving
# phases' steps at full width and depth: granite's bulk prefill (SERVE_B x
# SERVE_S) and one decode step (SERVE_B tokens against a ring of SERVE_S +
# SERVE_NEW), mamba2's (SSM_B x SSM_S; one token).
# The dry run (python -m repro_torch.launch.dryrun) on the fake 16x16 mesh,
# in the background from serving_zoo on (CPU only), each combination capped.
DRYRUN = [("granite-3-2b", "decode_32k"), ("granite-3-2b", "prefill_32k"),
          ("mamba2-130m", "decode_32k"), ("llama4-scout-17b-a16e", "decode_32k")]
DRYRUN_TIMEOUT_S = 420
# The two LM examples (repro_torch.examples): federated_llm at its full
# widths, 3 nodes x FED_LLM_EPOCHS epochs (the example's 10 cut to 2) x 30
# steps, with delta(chain=4) and adapters-only; federated_serving whole.
FED_LLM_EPOCHS = 2
FED_LLM_ADAPTER_SHARE = 0.01  # an adapters-only push, over a full run's push
# federated_serving's served tokens, held against the plain f32 model on the
# same weights (teacher-forced): each token's logit within SERVED_TOL of the
# position's largest logit magnitude below the best (bf16's attention
# tolerance). The first batch on each of the first SERVED_SAMPLES weight sets.
SERVED_TOL, SERVED_SAMPLES = 2e-2, 2
# The nine remaining example twins (repro_torch.examples), each through its
# main at the reference's defaults: sharded_federation's scan-cost fleets (the
# reference's own), the stdout lines kept per run, and the prefill's timed
# calls in serve_full (mamba2-130m's published config, 4 x 12-token prompts).
EXAMPLE_SCAN_FLEETS, EXAMPLE_TAIL_LINES, EXAMPLE_PREFILL_REPS = (200, 2000), 6, 5

# ssd_scan checks: the reference's sweeps (tests/test_kernels.py:186-190, f32,
# its 1e-4), then model layout with B/C shared by the heads.
SSD_SWEEPS = [(2, 128, 64, 32, 32), (3, 256, 64, 128, 64), (1, 512, 128, 64, 128),
              (2, 256, 64, 128, 256)]  # BH, S, P, N, chunk
SSD_TOL = 1e-4
# The Mamba2 bulk prefill's two elementwise kernels (ssm_prefill_in and
# ssm_prefill_out) are held against their plain composition and timed, bf16,
# at (arch, B, S): the Mamba2 serving phase's prefill and the two prefills of
# the benchmark's long-prompt cells, mamba2-130m at 8 x 8,192
# (mamba2.long_prompts) and granite-4.0-h-micro's Mamba2 layers at 4 x 32,768
# (granite4h.long_docs). Every output, the new conv cache included, equal to
# the plain version's bit for bit.
PREFILL_SHAPES = [(SSM_ARCH, SSM_B, SSM_S), ("mamba2-130m", 8, 8192),
                  ("granite-4.0-h-micro", 4, 32768)]
# Attention checks: the reference's sweeps (tests/test_kernels.py), the
# serving path's shapes, ragged S / C and windows.
FLASH_CHECK = [  # B, S, KV, G, hd, window
    (2, 256, 2, 2, 64, 0), (1, 256, 1, 4, 64, 128), (2, 512, 4, 1, 128, 0),
    (1, 128, 2, 2, 256, 64), (1, 256, 2, 3, 64, 0),
    (SERVE_B, SERVE_S, 8, 4, 64, 0), (2, 200, 8, 4, 64, 0), (1, 333, 2, 6, 128, 100),
    (2, 200, 4, 2, 32, 0),      # hd 32, ragged S
    (1, 256, 8, 5, 128, 0),     # qwen3-14b's group: KV 8, G 5, hd 128
    (1, 333, 16, 1, 256, 0),    # gemma-7b's: KV 16, G 1, hd 256, ragged S
    (2, 200, 2, 16, 64, 50),    # G 16, windowed, ragged
    (1, 96, 1, 64, 64, 0),      # the widest group: one position per q tile
    (1, 64, 1, 32, 256, 16),    # the widest group at hd 256, windowed
    (1, 1, 2, 4, 64, 0),        # S = 1
    (ZOO_B, 512, 8, 5, 128, 0),     # llama4-scout's serving prefill
    (ZOO_B, 3072, 1, 16, 256, 2048),  # recurrentgemma-9b's: KV 1, G 16, windowed
    (MODAL_B, ENCDEC_S, 16, 1, 64, 0),     # seamless-m4t-medium's decoder: KV 16, G 1
    (MODAL_B, 256 + PREFIX_S, 2, 7, 64, 0)]  # internvl2-1b's prefix + text: G 7
DECODE_CHECK = [  # B, KV, G, hd, C
    (2, 2, 4, 64, 1024), (1, 8, 1, 128, 512), (3, 1, 6, 64, 2048), (1, 2, 2, 256, 256),
    (SERVE_B, 8, 4, 64, SERVE_S + SERVE_NEW), (SERVE_B, 8, 4, 64, 32768), (2, 8, 4, 64, 1000),
    (2, 8, 4, 64, 1), (1, 2, 5, 128, 63), (2, 2, 16, 64, 1000), (1, 16, 1, 256, 576),
    (2, 2, 4, 32, 100),
    (1, 1, 16, 256, 576),       # the largest block: G 16 at hd 256 (recurrentgemma-9b's group)
    (ZOO_B, 8, 5, 128, 512 + ZOO_NEW),  # llama4-scout's serving decode
    (ZOO_B, 1, 16, 256, 2048),  # recurrentgemma-9b's: its ring of 2,048
    (MODAL_B, 16, 1, 64, ENCDEC_S + MODAL_NEW),            # seamless-m4t-medium's
    (MODAL_B, 2, 7, 64, 256 + PREFIX_S + MODAL_NEW)]       # internvl2-1b's
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference's own
# bf16's atol is also scaled by max|want| where that is below 1: at C = 32,768
# the outputs are ~0.01, under a plain 2e-2, which zeros would meet.
# Each port kernel's function name in a profiler trace.
KERNEL_SYMBOLS = {"flash_attention": "flash_mma_kernel", "decode_attention": "decode_split_kernel",
                  "ssd_scan": "ssd_mma_kernel", "ssm_prefill_in": "ssm_prefill_in_kernel",
                  "ssm_prefill_out": "ssm_prefill_out_kernel"}

# Device-memory rate by card (NVIDIA data sheets), bytes/s, and the f32 rate
# outside the tensor cores (the fed kernels' arithmetic), flop/s.
_BANDWIDTH = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
_F32_FLOPS = [("H100 PCIe", 51e12), ("H100", 67e12), ("H200", 67e12)]
# Dense bf16 tensor-core rate (NVIDIA data sheets, without sparsity), flop/s.
_BF16_FLOPS = [("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12), ("H200", 989e12)]


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the script's own seconds at its end."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _T0, **fields}), flush=True)


def card_rate(table, name: str) -> tuple[float, str]:
    for key, rate in table:
        if key in name:
            return rate, key
    raise RuntimeError(f"no published rate for card {name!r}")


L2_BYTES = 50 * 2**20  # H100's L2


def time_ms(fn, arg_sets=((),), reps: int = 25, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls run back to back
    between one pair of CUDA events, the elapsed time over ``reps``. A spin
    on the stream (``torch.cuda._sleep``) is queued first and holds the device
    until the host has enqueued every call, so the device never waits for the
    host's next launch (Python checks, a ctypes call) inside the interval; if
    the host was not done when the spin ended, the run is repeated with a
    longer spin. The calls rotate through ``arg_sets`` (see ``cold_sets``).
    The device holds a bounded queue of launches: a function of many small
    ones (a plain version) takes a few ``reps``, or the host waits for room
    in the queue and the spin never covers the enqueue."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[0])
    host_s = time.perf_counter() - t0  # one call's enqueue (the device may still run it)
    torch.cuda.synchronize()
    spin_s = 2 * reps * host_s + 2e-3
    for _ in range(4):
        spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin_start.record()
        torch.cuda._sleep(int(spin_s * 2.0e9))  # cycles; the SM clock is at most ~2 GHz
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        enqueue_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if spin_start.elapsed_time(start) / 1e3 > enqueue_s:
            return start.elapsed_time(end) / reps
        spin_s *= 4
    raise RuntimeError("the host never finished enqueueing within the spin: the call waits "
                       "on the device, or its launches overflow the device's queue")


def cold_sets(make, set_bytes: int) -> list:
    """Copies of a call's inputs (``make()`` returns one tuple) enough to
    cover twice the L2, so that rotating through them the call finds its
    data cold, as a real caller whose data was not just written does (a
    decode step reads each layer's cache once; an aggregation reads weights
    written an epoch ago). One set where the inputs alone exceed that."""
    return [make() for _ in range(max(1, -(-2 * L2_BYTES // set_bytes)))]


def bound(name: str, k: int, n: int, card: str) -> dict:
    """Least time for the work: bytes each input read once / each output
    written once over the memory rate, vs flops over the f32 rate."""
    nbytes = (k + 1) * n * 4 if name == "fed_agg" else (k + 6) * n * 4
    flops = 2 * k * n if name == "fed_agg" else (2 * k + 16) * n
    bw, _ = card_rate(_BANDWIDTH, card)
    peak, _ = card_rate(_F32_FLOPS, card)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "bandwidth_Bps": bw, "flops": flops}


def attn_bound(kind: str, card: str, *, B: int, T: int, KV: int, G: int, hd: int,
               itemsize: int, pairs: int) -> dict:
    """Least time for one attention call: q, k, v and o each moved once
    (plus the decode mask) over the memory rate, vs 4·hd flops for each
    visible (query head, key) pair — ``pairs`` per (batch, head), counted from
    this run's mask — over the peak rate for the inputs' type (bf16 tensor
    cores; f32 outside them). ``T`` is S (flash) or C (decode)."""
    H = KV * G
    rows = T if kind == "flash_attention" else 1  # query positions per (b, head)
    nbytes = (2 * B * rows * H * hd + 2 * B * T * KV * hd) * itemsize
    if kind == "decode_attention":
        nbytes += T  # the (C,) bool mask
    flops = 4 * B * H * hd * pairs
    bw, _ = card_rate(_BANDWIDTH, card)
    peak, _ = card_rate(_BF16_FLOPS if itemsize == 2 else _F32_FLOPS, card)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "bandwidth_Bps": bw, "peak_flops": peak}


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) mask keeps per (batch, head)."""
    return sum(min(s + 1, window) if window > 0 else s + 1 for s in range(S))


def sdpa_inputs(q, k, v):
    """The library call's operands, made once outside the timed region:
    heads-first q (B, H, L, hd) and k/v (B, KV, T, hd), and whether SDPA
    maps the G query heads onto their KV head itself (``enable_gqa``) or
    needs k/v expanded to H heads."""
    import torch.nn.functional as F

    B, L = q.shape[0], q.shape[1]
    hd = q.shape[-1]
    qh = q.reshape(B, L, -1, hd).transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    try:
        F.scaled_dot_product_attention(qh[:, :, :1], kh[:, :, :1], vh[:, :, :1], enable_gqa=True)
        return qh, kh, vh, {"enable_gqa": True}
    except TypeError:
        G = qh.shape[1] // kh.shape[1]
        return qh, kh.repeat_interleave(G, 1), vh.repeat_interleave(G, 1), {}


def federated_serving_shapes() -> tuple[tuple, tuple]:
    """The attention shapes of ``federated_serving``'s served batches, from
    the example's constants and pythia-14m's config: flash (B, S, KV, G, hd,
    window) and decode (B, KV, G, hd, C), C the ring of prompt + new tokens."""
    from repro_torch.configs import get_config
    from repro_torch.examples.federated_serving import NEW_TOKENS, PROMPT_LEN, PROMPTS

    cfg = get_config("pythia-14m")
    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    return (PROMPTS, PROMPT_LEN, KV, G, hd, 0), (PROMPTS, KV, G, hd, PROMPT_LEN + NEW_TOKENS)


def check_attention(dev, gen) -> tuple[list, dict]:
    """Each attention kernel against its plain version at the reference's
    sweep shapes, the serving paths' (``federated_serving``'s included) and
    the reach of the redesigns (hd 32 to 256, G 1 to 64, ragged S and C,
    windows, a split of the cache whose slots are all invalid, a ring with no
    valid slot), f32 and bf16; each call launches its kernel once. Raises on
    a miss."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref, split_bounds
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    served_flash, served_decode = federated_serving_shapes()

    checks, max_err = [], {"flash_attention": 0.0, "decode_attention": 0.0}
    wrappers = {"flash_attention": fk, "decode_attention": dk}

    def hold(name, call, want, dtype, note):
        before = wrappers[name].LAUNCHES[name]
        got = call()
        launches = wrappers[name].LAUNCHES[name] - before
        tol = atol = ATTN_TOL[dtype]
        if dtype == torch.bfloat16:
            atol = tol * min(1.0, float(want.float().abs().max()))
        err = float((got.float() - want.float()).abs().max())
        ok = (launches == 1 and bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), rtol=tol, atol=atol))
        checks.append({"kernel": name, "shape": note, "dtype": str(dtype), "max_abs_err": err,
                       "rtol": tol, "atol": atol, "launches": launches, "ok": ok})
        max_err[name] = max(max_err[name], err)
        if not ok:
            raise AssertionError(f"{name} {note} {dtype}: {launches} launches, max abs err {err} "
                                 f"over rtol {tol} / atol {atol}")

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, KV, G, hd, window in FLASH_CHECK + [served_flash]:
            q = torch.randn(B, S, KV, G, hd, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen).to(dtype) for _ in range(2))
            hold("flash_attention", lambda: fk.flash_attention(q, k, v, window=window),
                 flash_attention_ref(q, k, v, window=window), dtype,
                 f"B={B} S={S} KV={KV} G={G} hd={hd} window={window}")
        for B, KV, G, hd, C in DECODE_CHECK + [served_decode]:
            q = torch.randn(B, KV, G, hd, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(B, C, KV, hd, device=dev, generator=gen).to(dtype) for _ in range(2))
            valid = torch.rand(C, device=dev, generator=gen) < 0.7
            n_split = dk.split_count(B, KV, C, dk.sm_count(dev))
            hold("decode_attention", lambda: dk.decode_attention(q, k, v, valid),
                 decode_attention_ref(q, k, v, valid), dtype,
                 f"B={B} KV={KV} G={G} hd={hd} C={C} n_split={n_split}")
        # the serving shape with one split's slots all invalid, then with none valid
        B, KV, G, hd, C = SERVE_B, 8, 4, 64, SERVE_S + SERVE_NEW
        n_split = dk.split_count(B, KV, C, dk.sm_count(dev))
        q = torch.randn(B, KV, G, hd, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(B, C, KV, hd, device=dev, generator=gen).to(dtype) for _ in range(2))
        valid = torch.rand(C, device=dev, generator=gen) < 0.7
        lo, hi = split_bounds(C, n_split)[1]
        valid[lo:hi] = False
        hold("decode_attention", lambda: dk.decode_attention(q, k, v, valid),
             decode_attention_ref(q, k, v, valid), dtype,
             f"B={B} KV={KV} G={G} hd={hd} C={C} n_split={n_split}, slots {lo}:{hi} all invalid")
        none = torch.zeros(C, dtype=torch.bool, device=dev)
        # both give the plain mean of v (all scores -1e30)
        hold("decode_attention", lambda: dk.decode_attention(q, k, v, none),
             decode_attention_ref(q, k, v, none), dtype,
             f"B={B} KV={KV} G={G} hd={hd} C={C} n_split={n_split}, no valid slot")
    q = torch.randn(1, 2, 4, 64, device=dev, generator=gen)
    k, v = (torch.randn(1, 100, 2, 64, device=dev, generator=gen) for _ in range(2))
    none = torch.zeros(100, dtype=torch.bool, device=dev)
    hold("decode_attention", lambda: dk.decode_attention(q, k, v, none),
         decode_attention_ref(q, k, v, none), torch.float32, "B=1 KV=2 G=4 hd=64 C=100 no valid slot")
    torch.cuda.synchronize()
    return checks, max_err


def time_flash(dev, gen, card, B: int, S: int, KV: int, G: int, hd: int,
               window: int = 0) -> dict:
    """flash_attention's device time (``time_ms``) at one bf16 causal shape,
    beside its plain version, SDPA (with the window as a mask where there is
    one) and its bound. The inputs are not rotated: in a prefill they were
    just written by the projections."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.attention import causal_mask

    bf16 = torch.bfloat16
    q = torch.randn(B, S, KV, G, hd, device=dev, generator=gen).to(bf16)
    k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen).to(bf16) for _ in range(2))
    qh, kh, vh, gqa = sdpa_inputs(q, k, v)
    if window:
        mask = causal_mask(S, window, device=dev)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, **gqa)  # noqa: E731
        library = "F.scaled_dot_product_attention(attn_mask=window mask)"
    else:
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, **gqa)  # noqa: E731
        library = "F.scaled_dot_product_attention(is_causal=True)"
    nbytes = sum(t.numel() * 2 for t in (q, k, v))
    return {
        "name": "flash_attention",
        "shape": f"B={B} S={S} KV={KV} G={G} hd={hd} window={window} causal bf16",
        "inputs": f"one set ({nbytes / 1e6:.0f} MB), not rotated",
        "kernel_ms": time_ms(lambda: fk.flash_attention(q, k, v, window=window)),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, window=window)),
        "library_ms": time_ms(sdpa), "library": library,
        **attn_bound("flash_attention", card, B=B, T=S, KV=KV, G=G, hd=hd, itemsize=2,
                     pairs=visible_pairs(S, window))}


def time_decode(dev, gen, card, B: int, C: int, KV: int, G: int, hd: int) -> tuple[dict, list]:
    """decode_attention's device time at one bf16 shape with every slot
    valid, beside its plain version, SDPA with the mask and its bound. The
    inputs rotate (``cold_sets``): a decode step reads each layer's cache
    once. Returns the timing and the input sets."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    bf16 = torch.bfloat16

    def make():
        q = torch.randn(B, KV, G, hd, device=dev, generator=gen).to(bf16)
        k, v = (torch.randn(B, C, KV, hd, device=dev, generator=gen).to(bf16) for _ in range(2))
        valid = torch.ones(C, dtype=torch.bool, device=dev)
        return (q, k, v, valid, *sdpa_inputs(q[:, None], k, v))
    sets = cold_sets(make, 2 * B * C * KV * hd * 2)
    return {
        "name": "decode_attention",
        "shape": f"B={B} C={C} KV={KV} G={G} hd={hd} bf16, all slots valid",
        "inputs": f"{len(sets)} sets rotated (cold L2)",
        "n_split": dk.split_count(B, KV, C, dk.sm_count(dev)),
        "kernel_ms": time_ms(lambda q, k, v, valid, *_: dk.decode_attention(q, k, v, valid), sets),
        "plain_ms": time_ms(lambda q, k, v, valid, *_: decode_attention_ref(q, k, v, valid), sets),
        "library_ms": time_ms(lambda q, k, v, valid, qh, kh, vh, gqa: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=valid[None, None, None], **gqa), sets),
        "library": "F.scaled_dot_product_attention(attn_mask=valid)",
        **attn_bound("decode_attention", card, B=B, T=C, KV=KV, G=G, hd=hd, itemsize=2,
                     pairs=C)}, sets


def time_attention(dev, gen, card) -> list:
    """Device times of each attention kernel, its plain version and SDPA,
    beside the bound, at the serving path's shapes (bf16): granite's prefill
    and decode (at C = 576 and 32,768, with the decode split sweep), then
    the attention layers of ``serving_zoo``'s models (ZOO_ATTENTION)."""
    from repro_torch.kernels.decode_attention import kernel as dk

    B, S, KV, G, hd = SERVE_B, SERVE_S, 8, 4, 64
    timings = [time_flash(dev, gen, card, B, S, KV, G, hd)]
    for C in (SERVE_S + SERVE_NEW, 32768):
        timing, sets = time_decode(dev, gen, card, B, C, KV, G, hd)
        timing["by_n_split"] = split_sweep(dk, sets, B, KV, G, hd)
        timings.append(timing)
        del sets
    for arch, S, KV, G, hd, window, C in ZOO_ATTENTION:
        timings.append({"model": arch, **time_flash(dev, gen, card, ZOO_B, S, KV, G, hd, window)})
        timing, sets = time_decode(dev, gen, card, ZOO_B, C, KV, G, hd)
        timings.append({"model": arch, **timing})
        del sets
    return timings


def split_sweep(dk, sets, B, KV, G, hd) -> list:
    """decode_attention's device time for each n_split the kernel takes, with
    the clusters of that size the card holds at once beside the B*KV the
    grid needs: the evidence for ``split_count``'s rule."""
    return [{"n_split": n, "kernel_ms": time_ms(
                lambda q, k, v, valid, *_: dk._launch(q, k, v, valid, n_split=n), sets),
             "clusters_resident": dk.cluster_capacity(hd, G, torch.bfloat16, n),
             "clusters_needed": B * KV}
            for n in range(1, dk.MAX_SPLIT + 1)]


def sass_report(lib_path, mma_prefix: str | None = None) -> dict:
    """What the compiler made of one built library, read with ``cuobjdump``
    (from the toolkit; a cached build reads the same): each kernel
    instance's registers, stack frame (where spills go) and static shared
    memory (``-res-usage``), and in its SASS the local-memory stores
    (``STL``, spill stores) and the tensor-core instructions (HMMA/HGMMA).
    With ``mma_prefix``, raises if an instance whose name starts with it has
    no tensor-core instruction: those are meant to run on the tensor cores."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    def demangle_short(mangled: str) -> str:
        m = re.search(r"((?:flash|decode|ssd)_[a-z]+_kernel)I((?:Li\d+E|f|13__nv_bfloat16)+)E",
                      mangled)
        if not m:
            return mangled
        args = ["f32" if f else "bf16" if b else n
                for n, f, b in re.findall(r"Li(\d+)E|(f)|(13__nv_bfloat16)", m.group(2))]
        return f"{m.group(1)}<{','.join(args)}>"

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"

    def dump(flag: str) -> str:
        return subprocess.run([str(cuobjdump), flag, str(lib_path)],
                              capture_output=True, text=True, check=True).stdout

    instances, current = {}, None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function "):
            current = demangle_short(line.strip()[len("Function "):].rstrip(":"))
        elif current and "REG:" in line:
            usage = dict(re.findall(r"(\w+):(\d+)", line))
            instances[current] = {"registers": int(usage["REG"]),
                                  "stack_bytes": int(usage["STACK"]),
                                  "static_smem_bytes": int(usage["SHARED"]),
                                  "local_bytes": int(usage["LOCAL"])}
            current = None
    counts, current = {}, None
    for line in dump("-sass").splitlines():
        if "Function : " in line:
            current = demangle_short(line.split("Function : ")[1].strip())
            counts[current] = {"hmma": 0, "stl": 0}
        elif current and re.search(r"\bH(G)?MMA\b", line):
            counts[current]["hmma"] += 1
        elif current and re.search(r"\bSTL(\.\w+)*\b", line):
            counts[current]["stl"] += 1
    if not instances or set(instances) != set(counts):
        raise AssertionError(f"{lib_path}: cuobjdump's resource usage and SASS list different "
                             f"functions: {sorted(instances)} vs {sorted(counts)}")
    for fn, c in counts.items():
        instances[fn]["local_store_instructions"] = c["stl"]
        instances[fn]["sass_hmma_count"] = c["hmma"]
    mma = {f: c["hmma"] for f, c in counts.items() if mma_prefix and f.startswith(mma_prefix)}
    if mma_prefix and (not mma or min(mma.values()) == 0):
        raise AssertionError(f"{mma_prefix} has no tensor-core instruction: {mma}")
    return {"instances": instances}


def attn_build_report(lib_paths: dict) -> dict:
    """``sass_report`` of the attention libraries (the bf16 flash kernel must
    run on the tensor cores), beside the dynamic shared memory of a block."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk

    report = {"flash_attention": sass_report(lib_paths["flash_attention"], "flash_mma_kernel"),
              "decode_attention": sass_report(lib_paths["decode_attention"])}
    report["flash_attention"]["dynamic_smem_bytes"] = {
        f"hd={hd} {str(dt)[6:]}": fk.smem_bytes(hd, dt)
        for hd in fk.HEAD_DIMS for dt in fk.DTYPES}
    n_split = dk.split_count(SERVE_B, 8, SERVE_S + SERVE_NEW, dk.sm_count(torch.device("cuda")))
    report["decode_attention"].update(
        serving_n_split=n_split,
        dynamic_smem_bytes_serving=dk.smem_bytes(64, 4, torch.bfloat16, n_split),
        dynamic_smem_bytes_largest=dk.smem_bytes(256, dk.MAX_G, torch.bfloat16, dk.MAX_SPLIT),
        clusters_resident_serving=dk.cluster_capacity(64, 4, torch.bfloat16, n_split),
        clusters_needed_serving=SERVE_B * 8)
    # the instance each served zoo shape runs (bf16): flash is one instance
    # per hd; decode rounds G up to the group block GB of its instance (2, 4,
    # 8 or 16: csrc/decode_attention.cu's dispatch)
    served = []
    for arch, S, KV, G, hd, window, C in ZOO_ATTENTION:
        GB = next(gb for gb in (2, 4, 8, dk.MAX_G) if G <= gb)
        for kind, name in (("flash_attention", f"flash_mma_kernel<{hd}>"),
                           ("decode_attention", f"decode_split_kernel<bf16,{hd},{GB}>")):
            instances = report[kind]["instances"]
            served.append({"model": arch, "kernel": kind, "KV": KV, "G": G, "hd": hd,
                           "instance": name, **({"GB": GB} if kind == "decode_attention" else
                                                {"q_positions_per_tile": 64 // G}),
                           **instances.get(name, {"not_found_in": sorted(instances)})})
    report["served_instances"] = served
    return report


def ssd_build_report(lib_paths: dict) -> dict:
    """``sass_report`` of the SSD library (the bf16 cluster kernel must run on
    the tensor cores), beside each instance's dynamic shared memory."""
    from repro_torch.kernels.ssd_scan import kernel as sk

    report = sass_report(lib_paths["ssd_scan"], "ssd_mma_kernel")
    report["dynamic_smem_bytes"] = {f"P={P} N={N} {str(dt)[6:]}": sk.smem_bytes(P, N, dt)
                                    for P in sk.HEAD_DIMS for N in sk.STATE_DIMS
                                    for dt in sk.DTYPES}
    return report


def ssd_case(dev, gen, B, S, H, P, N, dtype):
    """Mamba2 SSD inputs as the model makes them: dt = softplus(N(0,1)),
    A = -(1..H) (the deterministic A_log = log(1..H)), x = xh·dt in ``dtype``,
    dA = dt·A in f32 (down to ~-17 per step in the last heads), B/C (B,S,N)
    shared by every head."""
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=dev, generator=gen))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    x = (torch.randn(B, S, H, P, device=dev, generator=gen) * 0.5).to(dtype) * dt[..., None].to(dtype)
    Bm, Cm = ((torch.randn(B, S, N, device=dev, generator=gen) * 0.5).to(dtype) for _ in range(2))
    return x, dt * A, Bm, Cm


def ssd_bound(card: str, *, B: int, S: int, H: int, P: int, N: int, chunk: int,
              itemsize: int) -> dict:
    """Least time for one SSD scan: x and y (B,S,H,P), dA (B,S,H) f32, B and C
    (B,S,N) once per batch row, the f32 state read and written once, over the
    memory rate; vs the flops of the visible (i, j <= i) pairs of each chunk
    (2N for C·B, 2P for the product with x) plus C·state and the state update
    (2·P·N per row each), over the peak rate for the inputs' type."""
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + B * S * H * 4 + 2 * B * H * P * N * 4
    flops = 0
    for c0 in range(0, S, chunk):
        rows = min(chunk, S - c0)
        flops += rows * (rows + 1) // 2 * 2 * (N + P) + 4 * rows * P * N
    flops *= B * H
    bw, _ = card_rate(_BANDWIDTH, card)
    peak, _ = card_rate(_BF16_FLOPS if itemsize == 2 else _F32_FLOPS, card)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "bandwidth_Bps": bw, "peak_flops": peak}


def check_ssd(dev, gen) -> tuple[list, float]:
    """ssd_scan against its plain version: the reference's four sweeps (f32,
    its dA, its 1e-4); then, with the model's dA, the serving shape and S =
    8192 in bf16 (2e-2, atol scaled by min(1, max|want|)), a ragged S = 1000 and a nonzero
    initial state (f32, 1e-4), a prompt of 12 tokens, shorter than one chunk,
    at mamba2-130m's widths in bf16 and at its reduced() widths in f32 (the
    examples phase's serve_demo), and each final state at 1e-4 relative. With
    the model's dA the running sum of dA reaches ~-5000 in a chunk, where f32
    prefix sums (the reference's arithmetic, and the plain version's in f32)
    lose ~5e-4 in each decay's exponent; so there the plain version runs in
    f64 on the same inputs, and the plain f32 version's own distance from it
    is recorded beside the kernel's. Raises on a miss."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref, ssd_scan_sequential

    checks, max_err = [], 0.0

    def hold(got, want, rtol, atol, note):
        nonlocal max_err
        err = float((got.double() - want.double()).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got.double(), want.double(),
                                                                rtol=rtol, atol=atol)
        checks.append({"kernel": "ssd_scan", "case": note, "max_abs_err": err, "rtol": rtol,
                       "atol": atol, "ok": ok})
        if not note.startswith("final state"):
            max_err = max(max_err, err)
        if not ok:
            raise AssertionError(f"ssd_scan {note}: max abs err {err} over rtol {rtol} / atol {atol}")

    for BH, S, P, N, chunk in SSD_SWEEPS:
        x = torch.randn(BH, S, P, device=dev, generator=gen) * 0.5
        dA = -torch.nn.functional.softplus(torch.randn(BH, S, device=dev, generator=gen))
        Bm, Cm = (torch.randn(BH, S, N, device=dev, generator=gen) * 0.5 for _ in range(2))
        got = sk.ssd_scan(x, dA, Bm, Cm, chunk=chunk)
        note = f"BH={BH} S={S} P={P} N={N} chunk={chunk} f32"
        hold(got, ssd_scan_ref(x, dA, Bm, Cm, chunk=chunk), SSD_TOL, SSD_TOL, note)
        hold(got, ssd_scan_sequential(x, dA, Bm, Cm), 1e-3, 1e-3, note + " vs sequential")
    cases = [  # B, S, H, P, N, chunk, dtype, initial state
        (SSM_B, SSM_S, 24, 64, 128, 256, torch.bfloat16, False),
        (1, 8192, 24, 64, 128, 256, torch.bfloat16, True),  # 32 chunks: 4 cluster rounds
        (2, 1000, 24, 64, 128, 256, torch.float32, False),
        (2, 1000, 4, 64, 128, 256, torch.float32, True),
        (1, 333, 3, 128, 64, 128, torch.float32, True),
        # the examples phase's serve_demo prefills: 4 prompts of 12 tokens, one
        # partial chunk (S < chunk) at mamba2-130m's published widths (bf16,
        # ssd_mma_kernel) and at its reduced() widths (f32, ssd_scan_kernel)
        (4, 12, 24, 64, 128, 256, torch.bfloat16, False),
        (4, 12, 8, 64, 32, 32, torch.float32, False)]
    for B, S, H, P, N, chunk, dtype, with_init in cases:
        x, dA, Bm, Cm = ssd_case(dev, gen, B, S, H, P, N, dtype)
        init = (torch.randn(B, H, P, N, device=dev, generator=gen) * 0.3 if with_init
                else torch.zeros(B, H, P, N, device=dev))
        wide = (B, S, H, N)
        plain = lambda *t: ssd_chunked(t[0], t[1], t[2][:, :, None].expand(wide),  # noqa: E731
                                       t[3][:, :, None].expand(wide), chunk, initial_state=t[4])
        want_y, want_state = plain(*(t.double() for t in (x, dA, Bm, Cm, init)))
        f32_y, f32_state = plain(x, dA, Bm, Cm, init)
        state = init.clone()
        got_y, got_state = sk.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=state, state_out=state)
        note = (f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} {str(dtype)[6:]}, B/C shared"
                + (", initial state" if with_init else "") + ", vs the plain version in f64")
        if dtype == torch.bfloat16:
            tol = ATTN_TOL[dtype]
            hold(got_y, want_y, tol, tol * min(1.0, float(want_y.abs().max())), note)
        else:
            hold(got_y, want_y, SSD_TOL, SSD_TOL, note)
        checks[-1]["plain_f32_max_abs_err"] = float((f32_y.double() - want_y).abs().max())
        hold(got_state, want_state, SSD_TOL, SSD_TOL * float(want_state.abs().max()),
             "final state, " + note)
        checks[-1]["plain_f32_max_abs_err"] = float((f32_state.double() - want_state).abs().max())
        del x, dA, Bm, Cm, want_y, got_y, f32_y
    torch.cuda.synchronize()
    return checks, max_err


SSD_TIME_SHAPES = [(SSM_B, SSM_S), (1, 16384)]  # B, S: the serving prefill, a single long prompt


def time_ssd(dev, gen, card) -> list:
    """Device times (``time_ms``) of ssd_scan and its plain version at the
    Mamba2 serving prefill's shape and at a single long prompt (mamba2-130m's
    widths, bf16, B/C shared, the state read from and written into a cache),
    beside the bound; at each, the cluster-size sweep. The inputs (123 MB at
    the serving shape) exceed the L2 alone, so one set. The plain version
    launches ~50 kernels a call, so it is timed over 5 calls (see
    ``time_ms``). No single PyTorch call computes the scan."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    H, P, N, chunk = 24, 64, 128, 256
    timings = []
    for B, S in SSD_TIME_SHAPES:
        x, dA, Bm, Cm = ssd_case(dev, gen, B, S, H, P, N, torch.bfloat16)
        state = torch.zeros(B, H, P, N, device=dev)
        wide = (B, S, H, N)
        nc = -(-S // chunk)
        timings.append({
            "name": "ssd_scan", "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} bf16, "
                                         "B/C shared by the heads, state in and out",
            "cluster": sk.plan_cluster(B, S, H, P, N, chunk), "chunks": nc,
            "kernel_ms": time_ms(lambda: sk.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=state,
                                                state_out=state)),
            "plain_ms": time_ms(lambda: ssd_chunked(x, dA, Bm[:, :, None].expand(wide),
                                                    Cm[:, :, None].expand(wide), chunk,
                                                    initial_state=state), reps=5),
            "library_ms": None, "library": "none (no single PyTorch call computes the scan)",
            "inputs": "one set",
            **ssd_bound(card, B=B, S=S, H=H, P=P, N=N, chunk=chunk, itemsize=2),
            "by_cluster": [{"cluster": n, "rounds": -(-nc // n),
                            "kernel_ms": time_ms(lambda: sk._launch(
                                x, dA, Bm, Cm, chunk=chunk, initial_state=state, state_out=state,
                                cluster=n)),
                            "clusters_resident": sk.cluster_capacity(P, N, n),
                            "clusters_needed": B * H}
                           for n in range(1, sk.MAX_CLUSTER + 1)]})
        del x, dA, Bm, Cm, state
    return timings


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors (their bit patterns as ordered integers; +0 and -0 are one value)."""
    def ordinal(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordinal(a) - ordinal(b)).abs().max())


def prefill_case(dev, gen, arch: str, B: int, S: int) -> tuple[dict, dict, int]:
    """One Mamba2 mixer's prefill inputs at ``arch``'s widths in bf16, drawn
    around the model's init: the x/B/C projections and raw dt N(0, 1), a
    seeded conv cache, conv_w/conv_b N(0, 0.1^2), dt_bias N(0, 0.5^2),
    A_log = log(1..H); then the scan's y and z N(0, 1), D 1 + N(0, 0.1^2) and
    the norm's scale 1 + N(0, 0.1^2). → (prefill_in's arguments,
    prefill_out's besides xh, head_dim)."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import _dims

    cfg = get_config(arch)
    d_inner, H, N = _dims(cfg)
    P, C = cfg.ssm_head_dim, d_inner + 2 * N

    def rand(*shape, s=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * s).to(torch.bfloat16)

    a = dict(xs=rand(B, S, d_inner), Bp=rand(B, S, N), Cp=rand(B, S, N), dt_raw=rand(B, S, H),
             conv_cache=rand(B, cfg.ssm_conv - 1, C), conv_w=rand(cfg.ssm_conv, C, s=0.1),
             conv_b=rand(C, s=0.1), dt_bias=torch.randn(H, device=dev, generator=gen) * 0.5,
             A_log=torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)))
    o = dict(y=rand(B, S, H, P), z=rand(B, S, d_inner),
             D=1 + 0.1 * torch.randn(H, device=dev, generator=gen),
             scale=(1 + 0.1 * torch.randn(d_inner, device=dev, generator=gen)).to(torch.bfloat16),
             eps=cfg.norm_eps)
    return a, o, P


def check_ssm_prefill(dev, gen) -> tuple[list, dict]:
    """ssm_prefill_in and ssm_prefill_out against their plain composition
    (``kernels/ssm_prefill/ref.py``, on the card) at PREFILL_SHAPES: xh, xdt,
    dA, B, C, the new conv cache and the out_proj input (from the kernel's
    own xh) equal bit for bit; each distance is recorded. Raises on a miss;
    → (checks, the largest abs error of each kernel)."""
    from repro_torch.kernels.ssm_prefill import kernel as pk
    from repro_torch.kernels.ssm_prefill import ref

    checks, max_err = [], {"ssm_prefill_in": 0.0, "ssm_prefill_out": 0.0}
    for arch, B, S in PREFILL_SHAPES:
        a, o, P = prefill_case(dev, gen, arch, B, S)
        want_cache = a["conv_cache"].clone()
        want = ref.prefill_in(**{**a, "conv_cache": want_cache}, head_dim=P)
        got = pk.prefill_in(**a, head_dim=P)
        got_out = pk.prefill_out(o["y"], got[0], o["z"], o["D"], o["scale"], o["eps"])
        want_out = ref.prefill_out(o["y"], got[0], o["z"], o["D"], o["scale"], o["eps"])
        torch.cuda.synchronize()
        pairs = [("ssm_prefill_in", n, g, w.contiguous())
                 for n, g, w in zip(("xh", "xdt", "dA", "Bm", "Cm"), got, want)]
        pairs += [("ssm_prefill_in", "conv_cache", a["conv_cache"], want_cache),
                  ("ssm_prefill_out", "out", got_out, want_out)]
        for kernel, name, g, w in pairs:
            err = float((g.float() - w.float()).abs().max())
            ok = bool(torch.equal(g, w)) and bool(torch.isfinite(g.float()).all())
            checks.append({"kernel": kernel, "output": name, "model": arch,
                           "shape": f"B={B} S={S}", "max_abs_err": err, "limit": "bit for bit",
                           **({"max_ulps": bf16_ulps(g, w)} if g.dtype == torch.bfloat16
                              else {}), "ok": ok})
            max_err[kernel] = max(max_err[kernel], err)
            if not ok:
                raise AssertionError(f"{kernel} {name} {arch} B={B} S={S}: not the plain "
                                     f"version's bits (max abs err {err})")
        del a, o, got, want, got_out, want_out, want_cache
    torch.cuda.synchronize()
    return checks, max_err


def prefill_bytes(B: int, S: int, d_inner: int, N: int, H: int, C: int, K: int) -> dict:
    """Least bytes of each kernel, bf16 activations (2 bytes), once each:
    prefill_in reads x/B/C, dt and the conv cache and writes xh, xdt, B, C,
    dA (f32) and the new cache; prefill_out reads y, xh and z and writes
    out_proj's input. The (C,)/(H,)/(d_inner,) parameters are left out
    (under 0.1%)."""
    T = B * S
    return {"ssm_prefill_in": 2 * (T * C + T * H + 2 * B * (K - 1) * C + 2 * T * d_inner
                                   + 2 * T * N) + 4 * T * H,
            "ssm_prefill_out": 2 * 4 * T * d_inner}


def time_ssm_prefill(dev, gen, card) -> list:
    """Device times (``time_ms``) of ssm_prefill_in and ssm_prefill_out and
    of their plain composition at PREFILL_SHAPES (bf16), beside the bytes
    bound (``prefill_bytes`` over the memory rate). The inputs (hundreds of
    MB) exceed the L2 alone, so one set; the plain versions launch ~20
    kernels a call and are timed over 5 calls. No single PyTorch call
    computes either."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_prefill import kernel as pk
    from repro_torch.kernels.ssm_prefill import ref
    from repro_torch.models.ssm import _dims

    bw, _ = card_rate(_BANDWIDTH, card)
    timings = []
    for arch, B, S in PREFILL_SHAPES:
        cfg = get_config(arch)
        d_inner, H, N = _dims(cfg)
        nbytes = prefill_bytes(B, S, d_inner, N, H, d_inner + 2 * N, cfg.ssm_conv)
        a, o, P = prefill_case(dev, gen, arch, B, S)
        xh = pk.prefill_in(**a, head_dim=P)[0]
        calls = {"ssm_prefill_in": (lambda: pk.prefill_in(**a, head_dim=P),
                                    lambda: ref.prefill_in(**a, head_dim=P)),
                 "ssm_prefill_out": (lambda: pk.prefill_out(o["y"], xh, o["z"], o["D"],
                                                            o["scale"], o["eps"]),
                                     lambda: ref.prefill_out(o["y"], xh, o["z"], o["D"],
                                                             o["scale"], o["eps"]))}
        for name, (kernel, plain) in calls.items():
            kernel_ms = time_ms(kernel)
            bound_ms = nbytes[name] / bw * 1e3
            timings.append({
                "name": name, "model": arch,
                "shape": f"B={B} S={S} d_inner={d_inner} N={N} H={H} bf16",
                "kernel_ms": kernel_ms, "plain_ms": time_ms(plain, reps=5),
                "library_ms": None, "library": "none (no single PyTorch call computes it)",
                "inputs": "one set", "bound_ms": bound_ms, "bound_by": "bytes",
                "bytes": nbytes[name], "bandwidth_Bps": bw,
                "bound_share_pct": 100 * bound_ms / kernel_ms})
        del a, o, xh
    return timings


def serving_consistency(dev, arch: str, batch: int, prompt: int, new_tokens: int,
                        prefill_kernel, logits_shape: tuple[int, int]) -> dict:
    """``arch`` at full width in f32, cut to CONSIST_LAYERS layers: the
    bulk-prefill path (``serve_batch``, which launches ``prefill_kernel``
    once per layer) and the decode-only path (``serve_batch_loop``, which never
    launches it) give the same greedy tokens, and the prefill's logits on the
    card (over the first ``logits_shape`` prompt tokens) agree with the plain
    versions' on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(dtype="float32", n_layers=CONSIST_LAYERS)
    model = build_model(cfg)
    params = model.init(1, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    (name, launches), = prefill_kernel.LAUNCHES.items()
    fast = serve_batch(cfg, params, prompts, new_tokens=new_tokens).cpu()
    prefill_launches = prefill_kernel.LAUNCHES[name] - launches
    slow = serve_batch_loop(cfg, params, prompts, new_tokens=new_tokens).cpu()
    if prefill_launches != cfg.n_layers or prefill_kernel.LAUNCHES[name] != launches + cfg.n_layers:
        raise AssertionError(f"{name}: {prefill_launches} launches in serve_batch (want "
                             f"{cfg.n_layers}), or launches in serve_batch_loop")
    if not torch.equal(fast, slow):
        raise AssertionError(f"serve_batch != serve_batch_loop on the card:\n{fast}\n{slow}")
    # the prefill's last-position logits, kernels on the card vs plain on the CPU
    B, S = logits_shape
    short = prompts[:B, :S]
    with torch.inference_mode():
        got, _ = model.prefill(params, short.to(dev), model.init_cache(B, S, device=dev))
        cpu_params = tree_map(lambda t: t.cpu(), params)
        want, _ = model.prefill(cpu_params, short, model.init_cache(B, S, device="cpu"))
    err = float((got.cpu() - want).abs().max())
    if not (torch.isfinite(got).all() and torch.allclose(got.cpu(), want, rtol=1e-3, atol=1e-3)):
        raise AssertionError(f"prefill logits, card vs CPU: max abs err {err}")
    return {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "batch": batch, "prompt": prompt, "new_tokens": new_tokens,
            "tokens_equal": True, "prefill_kernel": name, "prefill_launches": prefill_launches,
            "logits_shape": list(logits_shape), "prefill_logits_vs_cpu_max_abs_err": err,
            "logits_tol": 1e-3}


def host_memory(n_params: int) -> dict:
    """MemAvailable (/proc/meminfo) against what a hot swap at this size
    certainly holds at once: the node's two host f32 buffers, the store's
    blob and its decoded f32 flat. Raises, with the reading, if the host
    cannot hold that: the model is served at its published depth or not at
    all."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable:"))
    need = 4 * 4 * n_params
    if avail < need:
        raise MemoryError(f"MemAvailable {avail} bytes < {need} bytes: two host f32 buffers, "
                          f"the store's blob and its decoded flat of {n_params} parameters")
    return {"host_mem_available_bytes": avail, "host_mem_floor_bytes": need}


def serving(dev, arch: str, batch: int, prompt: int, new_tokens: int,
            kernels: dict, n_layers: int | None = None, mesh=None) -> tuple[dict, dict]:
    """The serving tier end to end, ``arch`` at full width in bf16 (at
    ``n_layers`` where given, else its published depth): publish → deploy →
    batches of ``batch`` prompts x ``prompt`` tokens, bulk prefill +
    ``new_tokens`` greedy tokens → a second push hot-swapped in under traffic
    → a batch on the new weights. ``kernels`` maps each kernel of the path to
    its wrapper module, whose launch count is set to 0 just before the traffic
    and read just after. With ``mesh`` the node places its weights there
    (``api.serve(mesh=)``). The store's blobs are deleted once the run has
    passed. Returns (phase record, launches)."""
    import gc
    import resource
    import threading

    import numpy as np

    from repro_torch.api import connect, serve
    from repro_torch.configs import get_config
    from repro_torch.core.serialize import NodeUpdate
    from repro_torch.core.store import make_folder
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.tree import LeafSpec, tree_map
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    published = get_config(arch)
    cfg = published.replace(n_layers=n_layers) if n_layers else published
    model = build_model(cfg)
    n_params = LeafSpec.of(model.abstract()).num_params
    host = host_memory(n_params)
    uri = f"memory://chip-smoke-serving-{arch}"

    def publish(params: dict, counter: int) -> dict:
        t0 = time.perf_counter()
        connect(uri).push(NodeUpdate(params, num_examples=1, node_id="publisher",
                                     counter=counter, timestamp=time.time()))
        return {"push_s": time.perf_counter() - t0}

    # Random weights at this depth mostly copy the last token forward, so two
    # seeds decode alike; the second weight set is the first negated (as the
    # reference's hot-swap test makes its), which flips the greedy choice.
    first_params = model.init(0, device=dev)
    second_params = tree_map(torch.neg, first_params)
    pushes = [publish(first_params, 0)]
    gc.collect()  # an earlier phase's node (a reference cycle through its thread)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the node's own spans time each prefill, decode step and swap
    tel = Telemetry("server-0", enabled=True, flush_every=10**9, ring_capacity=1 << 16)
    node = serve(uri, cfg, poll_interval=0.05, wait=900.0, node_id="server-0", mesh=mesh,
                 telemetry=tel)
    try:
        if not node.stats()["deployed"]:
            raise AssertionError("the serving node deployed nothing within 900 s")
        first_deploy_s = time.perf_counter() - t0
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt),
                                                    dtype=np.int32)
        node.generate(prompts[:, :16], new_tokens=2)  # warm-up: allocator, cuBLAS handles
        for wrapper in kernels.values():
            wrapper.reset_launches()
        tel.recorder.drain()
        first, meta = node.generate(prompts, new_tokens=new_tokens)
        batches = [(first, meta)]
        if meta["counter"] != 0:
            raise AssertionError(f"first batch served counter {meta['counter']}")
        # a second push lands while traffic runs
        errors: list[BaseException] = []

        def second_push():
            try:
                pushes.append(publish(second_params, 1))
            except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
                errors.append(e)

        pusher = threading.Thread(target=second_push)
        push_started = time.perf_counter()
        pusher.start()
        deadline = None
        while node.stats()["counter"] != 1:
            batches.append(node.generate(prompts, new_tokens=new_tokens))
            if errors:
                raise errors[0]
            if not pusher.is_alive():
                deadline = deadline or time.perf_counter() + 300.0
                if time.perf_counter() > deadline:
                    raise AssertionError("the second push was never deployed")
        pusher.join()
        last, last_meta = node.generate(prompts, new_tokens=new_tokens)
        batches.append((last, last_meta))
        torch.cuda.synchronize()
        launches = {name: wrapper.LAUNCHES[name] for name, wrapper in kernels.items()}
        stats = node.stats()
        spans = tel.recorder.drain_records()
        # where a batch's time goes: prefill alone, then prefill + 16 tokens
        # (not on a mesh: there DTensor's host dispatch leads, PERF.md §5)
        profiled = None if mesh is not None else {
            "prefill": profile_call(lambda: node.generate(prompts, new_tokens=1), "generate"),
            "prefill_and_16_tokens": profile_call(
                lambda: node.generate(prompts, new_tokens=17), "generate")}
    finally:
        node.stop()
    peak_mem = torch.cuda.max_memory_allocated()

    # the deployed weights serve what the pushed ones serve directly, before
    # and after the swap (same kernels, same card: equal tokens)
    for out, params, name in ((first, first_params, "first"), (last, second_params, "second")):
        want = serve_batch(cfg, params, prompts, new_tokens=new_tokens).cpu().numpy()
        if not np.array_equal(out, want):
            raise AssertionError(f"the node's tokens on the {name} weights differ from "
                                 "serve_batch's on the pushed weights")
    del first_params, second_params
    # no torn read: every batch that started on the first weights gave the
    # first batch's tokens; the batch after the swap runs on the new weights
    kept = [m["counter"] for _, m in batches[:-1]]
    if any(c == 0 and not np.array_equal(out, first) for (out, m), c in zip(batches, kept)):
        raise AssertionError("a batch on the first weights changed its tokens mid-swap")
    if last_meta["counter"] != 1 or np.array_equal(last, first):
        raise AssertionError(f"the batch after the swap ran counter {last_meta['counter']} "
                             "or gave the first weights' tokens")
    if last.shape != (batch, new_tokens) or not ((last >= 0) & (last < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens: shape {last.shape}")

    # per-token decode latency, from the node's spans: steady (no update in
    # flight), while the second update is pushed, pulled and decoded on the
    # host, and during its swap
    swap = [(r.t0, r.t0 + r.dur) for r in spans if r.name == "serve.swap"][-1]
    decodes = [(r.t0, r.t0 + r.dur) for r in spans if r.name == "serve.decode"]
    prefill_ms = [r.dur * 1e3 for r in spans if r.name == "serve.prefill"]
    steady, during_update, during = [], [], []
    for a, b in decodes:
        if a < swap[1] and b > swap[0]:
            during.append((b - a) * 1e3)
        elif push_started < b and a < swap[0]:
            during_update.append((b - a) * 1e3)
        else:
            steady.append((b - a) * 1e3)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    n_tokens = batch * new_tokens * len(batches)
    decode_s = sum(b - a for a, b in decodes)
    record = {
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "reduced": ({"n_layers": [published.n_layers, cfg.n_layers]}
                    if cfg.n_layers != published.n_layers else {}),
        "params": n_params, "batch": batch, "prompt": prompt,
        "new_tokens": new_tokens, "batches": len(batches),
        "mid_swap_batches_on_counter_0": sum(1 for c in kept if c == 0) - 1,
        "push_s": [p["push_s"] for p in pushes], "first_deploy_s": first_deploy_s,
        "prefill_ms_first": prefill_ms[0], "prefill_ms_p50": pct(prefill_ms, 50),
        "prefill_ms_p99": pct(prefill_ms, 99),
        "decode_ms_p50_steady": pct(steady, 50), "decode_ms_p99_steady": pct(steady, 99),
        "decode_ms_p50_during_push_pull": pct(during_update, 50),
        "decode_ms_p99_during_push_pull": pct(during_update, 99),
        "decode_ms_p50_during_swap": pct(during, 50), "decode_ms_p99_during_swap": pct(during, 99),
        "decode_tokens_during_swap": len(during),
        "decode_tokens_per_s": batch * len(steady) / (sum(steady) / 1e3) if steady else None,
        "tokens_per_s": stats["tokens_per_sec"], "tokens": n_tokens, "decode_s": decode_s,
        "swap_ms_p50": stats["swap_ms_p50"], "swap_ms_max": stats["swap_ms_max"],
        "swaps": stats["swaps"], "peak_device_memory_bytes": peak_mem,
        "device_memory_at_start_bytes": mem_at_start, **host,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "launches": launches, "profile": profiled,
        "mesh": None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))}
    folder = make_folder(uri)  # the process-wide named folder: free its blobs
    for key in list(folder.keys()):
        folder.delete(key)
    return record, launches


def profile_call(fn, what: str) -> dict:
    """One call of ``fn`` (``what`` names it) under ``torch.profiler``: wall
    time, the device's busy time (union of kernel intervals), kernel launches
    and top-level aten ops. The profiler's own host cost inflates the wall
    time, so the busy share it gives is a lower bound. Only a profiler that
    cannot start (no CUPTI) makes the breakdown "not measured"; any error of
    ``fn`` propagates, and a trace with no kernel on the card fails the
    phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"not_measured": f"torch.profiler did not start: {e!r}"}
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    events = prof.events()
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA)
    if not kernels:
        raise AssertionError(f"torch.profiler traced no kernel on the card during {what}")
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    ours = {name: [0, 0.0] for name in KERNEL_SYMBOLS}  # launches, device us
    for a, b, name in kernels:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a)
        for kernel, symbol in KERNEL_SYMBOLS.items():
            if symbol in name:
                ours[kernel][0] += 1
                ours[kernel][1] += b - a
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None
              and e.name.startswith("aten::"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3, "kernels": len(kernels),
            "aten_ops": ops, "top_kernels_ms": {k: v / 1e3 for k, v in top},
            "port_kernels": {k: {"launches": n, "device_ms": us / 1e3,
                                 "per_launch_ms": us / 1e3 / n}
                             for k, (n, us) in ours.items() if n}}


def timer_check(timings: list, profiles: dict) -> dict:
    """``time_ms`` at a serving phase's shape against that phase's profile:
    a kernel's device time summed over its launches in the trace, over their
    count. The two should agree within ~15%."""
    shapes = {"flash_attention": f"B={SERVE_B} S={SERVE_S}",
              "decode_attention": f"B={SERVE_B} C={SERVE_S + SERVE_NEW}",
              "ssd_scan": f"B={SSM_B} S={SSM_S} ", "ssm_prefill_in": f"B={SSM_B} S={SSM_S} ",
              "ssm_prefill_out": f"B={SSM_B} S={SSM_S} "}
    out = {}
    for name, profile in profiles.items():
        t = next(t for t in timings if t["name"] == name and t["shape"].startswith(shapes[name]))
        traced = profile.get("port_kernels", {}).get(name)
        if traced is None:
            out[name] = {"time_ms": t["kernel_ms"], "profile": "not measured"}
            continue
        out[name] = {"shape": t["shape"], "time_ms": t["kernel_ms"],
                     "profile_per_launch_ms": traced["per_launch_ms"],
                     "profile_launches": traced["launches"],
                     "time_ms_over_profile": t["kernel_ms"] / traced["per_launch_ms"]}
    return out


class EpochClock:
    """Trainer callback (the duck-typed ``repro_torch.core.Callback``): host
    seconds of each epoch, synchronised with the card."""

    def __init__(self):
        self.seconds: list[float] = []

    def on_train_begin(self, trainer):
        pass

    def on_train_end(self, trainer):
        pass

    def on_epoch_begin(self, trainer, epoch):
        torch.cuda.synchronize()
        self._t = time.perf_counter()

    def on_epoch_end(self, trainer, epoch, logs):
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - self._t)


def _span_means(tels, names) -> dict:
    """Mean ms of each named span over several nodes' telemetry."""
    out = {}
    for name in names:
        count = total = 0
        for tel in tels:
            st = tel.recorder.phase_stats().get(name)
            if st:
                count += st["count"]
                total += st["total_s"]
        out[f"{name}_ms_mean"] = total / count * 1e3 if count else None
        out[f"{name}_count"] = count
    return out


def federation_gossip(dev, root: str, model, init, shards, fk, fed_agg_ref) -> tuple[dict, dict]:
    """The federation plane on the card: four clients train ResNet-18 on a
    ``shard2+`` gossip store (group 0 ``delta(chain=4)``, group 1
    ``topk(adaptive)``; a FedAvg and a FedAdam client in each group), then a
    publisher pushes frozen-backbone fine-tune steps through
    ``delta(chain=4)``. Raises unless (a) every client aggregated, (b)
    ``fed_agg`` and ``fed_opt`` launched, (c) a fresh reader of each group sees
    the other group's summary, (d) every deposit reads back as its writer
    shipped it, (e) each summary is the example-weighted mean of its group's
    latest flats, (f) ``fed_agg`` over each group's pulled stack matches its
    plain version, and every publisher push is rebuilt bit for bit through a
    chain of depth 4 and a re-anchor. Returns (phase record, launches)."""
    import numpy as np

    from repro_torch.api import connect
    from repro_torch.core import (AsyncFederatedNode, FederatedCallback, NodeUpdate, Telemetry,
                                  balanced_groups, run_threaded)
    from repro_torch.core.serialize import deserialize_update_flat, peek_meta, serialize_update
    from repro_torch.core.strategies import FedAdam, FedAvg
    from repro_torch.core.tree import LeafSpec
    from repro_torch.data import batch_iterator
    from repro_torch.optim import adam
    from repro_torch.training import Trainer

    uri = f"shard2+{root}/fleet"
    names = [f"client{i}" for i in range(FED_CLIENTS)]
    groups = balanced_groups(names, 2)
    members = {g: sorted(n for n in names if groups[n] == g) for g in (0, 1)}
    if sorted(map(len, members.values())) != [2, 2]:
        raise AssertionError(f"balanced_groups gave {members}")
    spec = LeafSpec.of(init)
    full_blob = len(serialize_update(NodeUpdate(init, 1, "x")))
    trails: dict[str, list] = {}

    def client(name: str):
        g = groups[name]
        tel = Telemetry(enabled=True)
        store = connect(uri, transport=GOSSIP_TRANSPORTS[g], keep_history=True, group_of=groups,
                        telemetry=tel)
        strategy = FedAvg() if members[g].index(name) == 0 else FedAdam(server_lr=1e-3, tau=1e-3)
        pushes = trails[name] = []

        def on_step(node, _aggregated):  # the size of each deposit, and whether it rebased
            blob = store.folders.group_folder(g).get(f"latest/{name}")
            pushes.append({"bytes": len(blob), "delta": "delta_of" in peek_meta(blob),
                           "rebases": store._store(g).pipeline.stats.rebases})

        node = AsyncFederatedNode(strategy=strategy, store=store, node_id=name, telemetry=tel,
                                  on_step=on_step)
        i = names.index(name)
        trainer = Trainer(loss_fn=lambda prm, b, r: model.loss(prm, b), optimizer=adam(1e-3),
                          init_params=init, seed=i, name=name, telemetry=tel)
        clock = EpochClock()
        x, y = shards[i]
        trainer.fit(lambda e: batch_iterator(x, y, batch_size=FED_BATCH, seed=i, epoch=e),
                    epochs=FED_EPOCHS, steps_per_epoch=FED_STEPS,
                    callbacks=[clock, FederatedCallback(node, num_examples_per_epoch=FED_STEPS * FED_BATCH)])
        return node, trainer, clock, tel

    fk.reset_launches()
    t0 = time.perf_counter()
    results = run_threaded([lambda n=n: client(n) for n in names], names=names)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    for r in results:
        if r.error is not None:
            raise RuntimeError(f"{r.node_id} failed:\n{r.traceback}")
    nodes = {r.node_id: r.result for r in results}
    for name, (node, trainer, _clock, _tel) in nodes.items():  # (a)
        losses = [log["loss"] for log in trainer.log]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if node.num_aggregations < 1:
            raise AssertionError(f"{name} never aggregated")
    for name in ("fed_agg", "fed_opt"):  # (b)
        if launches[name] < 1:
            raise AssertionError(f"the sharded federation never launched {name}: {launches}")

    per_group, checks = {}, {}
    for g in (0, 1):
        transport = GOSSIP_TRANSPORTS[g]
        # (c) a fresh reader (new store, cold caches) of the group's folder
        reader = connect(uri, group_of=groups)
        puller = members[g][0]
        peers = reader.pull(exclude=puller)
        ids = [u.node_id for u in peers]
        if f"group:{1 - g}" not in ids:
            raise AssertionError(f"group {g} does not see group {1 - g}'s summary: {ids}")
        folder = reader.folders.group_folder(g)
        latest, wire, residual_norms = {}, {}, {}
        for name in members[g]:  # (d) every deposit reads back as its writer shipped it
            node, _trainer, _clock, _tel = nodes[name]
            got = connect(uri, group_of=groups).pull_node(name)
            latest[name] = got
            if transport.startswith("delta"):
                want = deserialize_update_flat(folder.get(f"history/{name}/{got.counter:06d}"), {}).flat
            else:
                # the writer's error-feedback state: (base hash, spec, base, acc, age)
                want = node.store._store(g).pipeline.policy._state[name][3]
                residual_norms[name] = node.store._store(g).pipeline.stats.residual_norm
            if got.spec.key != spec.key or not np.array_equal(got.flat, want):
                raise AssertionError(f"{name}'s {transport} deposit does not read back as shipped")
            stats = node.store._store(g).transport_stats()
            wire[name] = {"pushes": trails[name], "rebases": stats["rebases"],
                          "chain_depth": stats["chain_depth"], "reanchors": stats["reanchors"],
                          "topk_k": stats["topk_k"],
                          "topk_fraction_effective": stats["topk_fraction_effective"]}
        # (e) the group summary is the example-weighted mean of the latest flats
        summary = reader.load_summary(g, g)
        weights = np.array([max(1, latest[n].num_examples) for n in members[g]], np.float64)
        mean = sum(w * latest[n].flat.astype(np.float64) for w, n in zip(weights, members[g]))
        mean /= weights.sum()
        got = LeafSpec.of(summary.params).flatten(summary.params)
        summary_err = float(np.abs(got - mean).max())
        if (summary.version_vector != {n: latest[n].counter for n in members[g]}
                or not np.allclose(got, mean, rtol=1e-6, atol=1e-6)):
            raise AssertionError(f"group {g} summary: max abs err {summary_err}, "
                                 f"version vector {summary.version_vector}")
        # (f) fed_agg over the group's pulled stack (own latest, peer, summary)
        pulled = [latest[puller]] + peers
        stack = torch.stack([torch.from_numpy(u.flat) for u in pulled]).to(dev)
        coeffs = torch.tensor([float(u.num_examples) for u in pulled], device=dev)
        coeffs /= coeffs.sum()
        out, want = fk.fed_agg(stack, coeffs), fed_agg_ref(stack, coeffs)
        agg_err = float((out - want).abs().max())
        if not (torch.isfinite(out).all() and torch.allclose(out, want, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"fed_agg over group {g}'s pulled stack: max abs err {agg_err}")
        del stack
        tels = [nodes[n][3] for n in members[g]]
        deltas = [p["bytes"] for n in members[g] for p in trails[n] if p["delta"]]
        per_group[transport] = {
            "group": g, "clients": members[g], "wire": wire,
            "delta_pushes": len(deltas),
            "full_pushes": sum(len(trails[n]) for n in members[g]) - len(deltas),
            "delta_bytes_per_push_mean": sum(deltas) / len(deltas) if deltas else None,
            "delta_bytes_per_push_over_full_blob":
                sum(deltas) / len(deltas) / full_blob if deltas else None,
            "residual_norm": residual_norms,
            **_span_means(tels, ("push", "encode", "decode", "gossip", "gossip.l0.refresh",
                                 "gossip.l0.forward", "pull", "aggregate")),
        }
        checks[g] = {"pulled": ids, "summary_max_abs_err": summary_err,
                     "summary_version_vector": summary.version_vector,
                     "pulled_fed_agg_max_abs_err": agg_err}

    per_client = []
    for name, (node, trainer, clock, tel) in nodes.items():
        phases = tel.recorder.phase_stats()
        agg = phases.get("aggregate", {}).get("mean_s", 0.0) * 1e3
        # the whole federation step: push (encode + gossip), pull, aggregate
        step = sum(phases.get(p, {}).get("total_s", 0.0) for p in ("push", "pull", "aggregate"))
        step_ms = step / len(clock.seconds) * 1e3
        epoch_ms = sum(clock.seconds) / len(clock.seconds) * 1e3
        per_client.append({"node": name, "group": groups[name], "strategy": node.strategy.name,
                           "transport": GOSSIP_TRANSPORTS[groups[name]],
                           "aggregations": node.num_aggregations,
                           "losses": [log["loss"] for log in trainer.log], "epoch_s": clock.seconds,
                           "aggregate_host_ms_mean": agg,
                           "aggregate_share_of_mean_epoch": agg / epoch_ms,
                           "federation_step_ms_mean": step_ms,
                           "federation_step_share_of_mean_epoch": step_ms / epoch_ms})

    # The publisher: a frozen-backbone fine-tune (head + GN affines) through
    # delta(chain=4); a fresh reader rebuilds each push bit for bit.
    ptel = Telemetry(enabled=True)
    pub = connect(f"{root}/publish", transport="delta(chain=4)", telemetry=ptel)
    rng = np.random.default_rng(0)
    flat = spec.flatten(init)
    idx = spec.family_view(PUBLISH_FAMILY).indices
    depths, push_bytes, reader_pull_ms = [], [], []
    for step in range(PUBLISH_PUSHES):
        if step:
            flat[idx] += (1e-3 * rng.standard_normal(idx.size)).astype(np.float32)
        params = spec.unflatten(torch.from_numpy(flat).to(dev))  # the trainer's tree
        pub.push(NodeUpdate(params, FED_STEPS * FED_BATCH, "publisher", counter=step))
        push_bytes.append(len(pub.folder.get("latest/publisher")))
        depths.append(pub.pipeline.stats.chain_depth)
        reader = connect(f"{root}/publish")
        t1 = time.perf_counter()
        got = reader.pull_node("publisher")
        reader_pull_ms.append((time.perf_counter() - t1) * 1e3)
        if got is None or got.counter != step or not np.array_equal(got.flat, flat):
            raise AssertionError(f"publisher push {step} (chain depth {depths[-1]}) "
                                 "was not rebuilt bit for bit")
    pstats = pub.transport_stats()
    if 4 not in depths or depths[depths.index(4) + 1] != 1 or pstats["reanchors"] < 1:
        raise AssertionError(f"publisher chain depths {depths}: no depth 4 then re-anchor")
    deltas = push_bytes[1:]
    per_group["publisher delta(chain=4)"] = {
        "pushes": PUBLISH_PUSHES, "changed_entries": int(idx.size), "chain_depths": depths,
        "bytes_per_push": push_bytes, "delta_bytes_per_push_mean": sum(deltas) / len(deltas),
        "delta_bytes_per_push_over_full_blob": sum(deltas) / len(deltas) / full_blob,
        "rebases": pstats["rebases"], "reanchors": pstats["reanchors"],
        "max_chain_depth": pstats["max_chain_depth"],
        "fresh_reader_pull_ms": reader_pull_ms,
        **_span_means([ptel], ("encode",)),
    }
    return ({"model": "ResNet-18 GN", "params": spec.num_params, "uri": "shard2+<tmpdir>/fleet",
             "groups": members, "full_blob_bytes": full_blob, "wall_s": wall, "launches": launches,
             "clients": per_client, "transports": per_group, "checks": checks}, launches)


# -- federation_processes / fleet_soak / obs: the control plane on the card ------
#
# Children of the process phases start under ``spawn``: each one re-imports
# this file (its ``main()`` stays behind the ``__main__`` guard) and opens its
# own CUDA context. Their kernel launches are counted in the children and come
# back through their results and the store's telemetry counters.

PROC_VICTIM, PROC_PARK_AFTER = 3, 2  # client3 (FedAdam) parks after its 2nd push
SOAK_NODES, SOAK_ROUNDS, SOAK_WORKERS, SOAK_KILL_GRACE = 8, 6, 2, 90.0


class _EpochEnd:
    """Trainer callback acting at epoch ends only (the duck-typed
    ``repro_torch.core.Callback``)."""

    def on_train_begin(self, trainer):
        pass

    def on_train_end(self, trainer):
        pass

    def on_epoch_begin(self, trainer, epoch):
        pass


class _Checkpoints(_EpochEnd):
    """A checkpoint of the trainer's params at every epoch end, saved before
    the federation push, under the push's counter."""

    def __init__(self, directory: str, node):
        self.directory, self.node = directory, node

    def on_epoch_end(self, trainer, epoch, logs):
        from repro_torch.checkpoint import save_checkpoint

        save_checkpoint(self.directory, self.node.counter, trainer.params, keep=2)


class _Park(_EpochEnd):
    """The crash victim's callback: after its ``after``-th push it writes
    ``marker`` and holds still until the parent's SIGKILL lands."""

    def __init__(self, node, after: int, marker: str):
        self.node, self.after, self.marker = node, after, marker

    def on_epoch_end(self, trainer, epoch, logs):
        if self.node.num_pushes >= self.after:
            open(self.marker, "w").close()
            while True:
                time.sleep(0.05)


def _process_client(i: int, folder: str, root: str, spawn_unix: float,
                    park_after: int | None = None) -> dict:
    """One client of ``federation_processes`` in its own OS process: the
    ``federation`` phase's ResNet-18 client, resuming from its own deposits
    when it finds them (counter, params and, for FedAdam, m/v)."""
    from repro_torch.api import connect
    from repro_torch.core import AsyncFederatedNode, FederatedCallback, Telemetry
    from repro_torch.core.partition import partition_dataset
    from repro_torch.core.strategies import FedAdam, FedAvg
    from repro_torch.data import batch_iterator, make_synthetic_cifar
    from repro_torch.models.cnn import ResNet
    from repro_torch.optim import adam
    from repro_torch.training import Trainer

    name = f"client{i}"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's threaded clients
    torch.backends.cudnn.allow_tf32 = False
    data = make_synthetic_cifar(num_train=FED_CLIENTS * 2048, num_test=1024, seed=0)
    x, y = partition_dataset(data.x_train, data.y_train, num_nodes=FED_CLIENTS, skew=0.5)[i]
    model = ResNet()
    fedadam = i >= FED_CLIENTS // 2
    strategy = FedAdam(server_lr=1e-3, tau=1e-3, device=dev) if fedadam else FedAvg(device=dev)
    tel = Telemetry(enabled=True, flush_every=1)
    node = AsyncFederatedNode(strategy=strategy, store=connect(folder), node_id=name,
                              telemetry=tel, persist_strategy_state=fedadam)
    start = node.counter
    state = strategy.state_dict()
    restored = None if state is None else {
        k: float(torch.linalg.vector_norm(v)) for k, v in state.items()}
    init = node.resumed.params if node.resumed is not None else model.init(0, device=dev)
    resume_unix = time.time()
    trainer = Trainer(loss_fn=lambda prm, b, r: model.loss(prm, b), optimizer=adam(1e-3),
                      init_params=init, seed=i, name=name, telemetry=tel, device=dev)
    clock = EpochClock()
    callbacks = [clock, _Checkpoints(os.path.join(root, "ckpt", name), node),
                 FederatedCallback(node, num_examples_per_epoch=FED_STEPS * FED_BATCH)]
    if park_after is not None:
        callbacks.append(_Park(node, park_after, os.path.join(root, f"{name}.parked")))
    fit_unix = time.time()
    trainer.fit(lambda e: batch_iterator(x, y, batch_size=FED_BATCH, seed=i, epoch=start + e),
                epochs=FED_EPOCHS - start, steps_per_epoch=FED_STEPS, callbacks=callbacks)
    torch.cuda.synchronize()
    phases = tel.recorder.phase_stats()
    return {"node": name, "strategy": strategy.name, "resumed": node.resumed is not None,
            "start_counter": start, "final_counter": node.counter,
            "restored_state_norms": restored, "aggregations": node.num_aggregations,
            "losses": [log["loss"] for log in trainer.log], "epoch_s": clock.seconds,
            "startup_s": fit_unix - spawn_unix, "resume_unix": resume_unix,
            "aggregate_host_ms_mean": phases.get("aggregate", {}).get("mean_s", 0.0) * 1e3,
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}


def check_deposits(dev, pulled, fk, fed_agg_ref, fed_opt_ref, seed: int) -> dict:
    """``fed_agg`` and ``fed_opt`` (adam, at ``OPT_HP``) over the stack of a
    store's pulled deposits in the strategies' layout (rows padded to 32
    floats), weighted by their example counts, each held against its plain
    version at rtol = atol = 1e-5. The optimizer state is seeded: x is the
    first deposit plus noise, m and v as in ``kernel_check``. Raises on a
    disagreement or a non-finite value; returns the shape and the errors."""
    k, n = len(pulled), pulled[0].flat.size
    ld = -(-n // 32) * 32
    stack = torch.empty(k, ld, device=dev)[:, :n]
    for row, u in zip(stack, pulled):
        row.copy_(torch.from_numpy(u.flat))
    w = torch.tensor([max(1, u.num_examples) for u in pulled], dtype=torch.float32, device=dev)
    w /= w.sum()
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = stack[0] + 0.01 * torch.randn(n, device=dev, generator=gen)
    m = torch.randn(n, device=dev, generator=gen) * 0.1
    v = torch.rand(n, device=dev, generator=gen) * 0.01
    errs = {}
    for name, got, want in (
            ("fed_agg", [fk.fed_agg(stack, w)], [fed_agg_ref(stack, w)]),
            ("fed_opt", fk.fed_opt(stack, w, x, m, v, variant="adam", **OPT_HP),
             fed_opt_ref(stack, w, x, m, v, variant="adam", **OPT_HP))):
        errs[name] = max(float((g - r).abs().max()) for g, r in zip(got, want))
        if not all(torch.isfinite(g).all() and torch.allclose(g, r, rtol=1e-5, atol=1e-5)
                   for g, r in zip(got, want)):
            raise AssertionError(f"{name} over the {k} pulled deposits: max abs err "
                                 f"{errs[name]} over rtol = atol = 1e-5")
    return {"K": k, "N": n, "ld": ld, "max_abs_err": errs}


def _obs_launches(store_uri: str) -> dict:
    """The ``fed_agg`` and ``fed_opt`` launches that the nodes of a store made
    in their own processes (``kernel_launches`` over their obs snapshots)."""
    from repro_torch.core import collect_obs, kernel_launches

    counts = kernel_launches(collect_obs(store_uri))
    return {k: counts.get(k, 0) for k in ("fed_agg", "fed_opt")}


def federation_processes(dev, root: str, fk, fed_agg_ref, fed_opt_ref) -> tuple[dict, dict]:
    """The paper's robustness claim on real processes: the ``federation``
    phase's four clients as spawned OS processes under a
    ``ProcessSupervisor`` on one ``DiskFolder``. client3 (FedAdam) parks after
    its 2nd push, is SIGKILLed on the parked marker and respawned; its new
    incarnation must resume (counter > 0, params, FedAdam m/v). Raises unless
    every client finished with finite losses and aggregated, the victim
    resumed with its state, ``fed_agg`` and ``fed_opt`` launched in the
    children, client0's newest checkpoint equals its final deposit bit for
    bit, two checkpoints remain per client, and ``fed_agg`` and ``fed_opt``
    over the four pulled deposits match their plain versions. Returns
    (record, launches)."""
    import numpy as np

    from repro_torch.api import connect
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.core import ProcessCrashed, ProcessSupervisor
    from repro_torch.core.tree import as_numpy, tree_leaves

    folder = os.path.join(root, "store")
    names = [f"client{i}" for i in range(FED_CLIENTS)]
    victim = names[PROC_VICTIM]
    marker = os.path.join(root, f"{victim}.parked")
    sup = ProcessSupervisor()
    t0 = time.perf_counter()
    kill_unix = None
    try:
        for i, name in enumerate(names):
            sup.spawn(name, _process_client, (i, folder, root, time.time()),
                      {"park_after": PROC_PARK_AFTER if i == PROC_VICTIM else None})
        deadline = time.monotonic() + 600.0
        while sup.unsettled():
            if time.monotonic() > deadline:
                raise TimeoutError(f"clients still running after 600 s: {sup.unsettled()}")
            if kill_unix is None and os.path.exists(marker):
                sup.kill(victim)  # mid-training, parked on its marker
                kill_unix = time.time()
            for name in sup.poll():
                if name == victim and sup.incarnation(victim) == 0 and kill_unix is not None:
                    sup.spawn(victim, _process_client,
                              (PROC_VICTIM, folder, root, time.time()))  # no park: resume
            time.sleep(0.05)
    finally:
        sup.shutdown()
    wall = time.perf_counter() - t0
    first = sup.history(victim)
    if kill_unix is None or len(first) != 1 or not isinstance(first[0].error, ProcessCrashed) \
            or first[0].exitcode != -9:
        raise AssertionError(f"{victim} was not SIGKILLed once: history {first}")
    results = {}
    for name in names:
        r = sup.result(name)
        if r.error is not None:
            raise RuntimeError(f"{name} failed:\n{r.traceback or r.error}")
        results[name] = r.result
    for name, res in results.items():
        if not all(math.isfinite(v) for v in res["losses"]):
            raise AssertionError(f"{name}: non-finite loss {res['losses']}")
        if res["aggregations"] < 1 or res["final_counter"] != FED_EPOCHS:
            raise AssertionError(f"{name}: {res['aggregations']} aggregations, "
                                 f"counter {res['final_counter']}")
    launches = _obs_launches(folder)
    reborn = results[victim]
    if not (reborn["resumed"] and reborn["start_counter"] == PROC_PARK_AFTER
            and reborn["restored_state_norms"]
            and all(math.isfinite(v) and v > 0 for v in reborn["restored_state_norms"].values())):
        raise AssertionError(f"{victim} did not resume with its FedAdam state: {reborn}")
    for name in ("fed_agg", "fed_opt"):
        if launches[name] < 1:
            raise AssertionError(f"the children never launched {name}: {launches}")

    # Checkpoints: two remain per client; client0's newest is its final deposit.
    store = connect(folder)
    for name in names:
        kept = sorted(os.listdir(os.path.join(root, "ckpt", name)))
        if len(kept) != 2:
            raise AssertionError(f"{name}: checkpoints {kept}, want the newest 2")
    ckpt, meta = load_checkpoint(os.path.join(root, "ckpt", "client0"))
    deposit = store.pull_node("client0")
    if meta["step"] != deposit.counter or latest_step(os.path.join(root, "ckpt", "client0")) \
            != FED_EPOCHS - 1:
        raise AssertionError(f"client0's newest checkpoint is step {meta['step']}, "
                             f"its final deposit counter {deposit.counter}")
    for a, b in zip(tree_leaves(ckpt), tree_leaves(deposit.params)):
        if not np.array_equal(as_numpy(a), as_numpy(b)):
            raise AssertionError("client0's newest checkpoint differs from its final deposit")

    pulled = store.pull()
    if sorted(u.node_id for u in pulled) != names:
        raise AssertionError(f"store holds {[u.node_id for u in pulled]}, want {names}")
    pulled_check = check_deposits(dev, pulled, fk, fed_agg_ref, fed_opt_ref, seed=1)
    clients = [{k: v for k, v in res.items() if k != "resume_unix"} for res in results.values()]
    return ({"model": "ResNet-18 GN", "params": N_RESNET18, "processes": FED_CLIENTS,
             "start_method": "spawn", "victim": victim, "park_after_pushes": PROC_PARK_AFTER,
             "kill_to_resume_s": reborn["resume_unix"] - kill_unix,
             "victim_first_incarnation_exitcode": first[0].exitcode,
             "checkpoints_kept": 2, "checkpoint_equals_final_deposit": True,
             "pulled_check": pulled_check, "wall_s": wall, "launches": launches,
             "clients": clients}, launches)


def fleet_soak(dev, root: str, fk, fed_agg_ref, fed_opt_ref) -> tuple[dict, dict]:
    """The elastic fleet on the card, through ``run_fleet_local``: 8 soak
    nodes at ResNet-18's parameter count (each push the 44.7 MB blob of the
    paper's CIFAR experiment), FedAdam on the card in every node process, two
    workers, seeded chaos: one node SIGKILLed on its parked heartbeat and
    restarted, one stalled, one whole worker killed so the survivor adopts
    its lapsed leases. ``run_fleet_local`` starts the second worker once the
    first holds its leases, so the seeded victims land the same way in every
    run. Raises unless the report passes with one crash, one restart, the
    victim resumed, >= 1 adoption by the survivor, one fleet hash (the
    survivor's, equal to this process's own reading of the quiesced store),
    ``fed_opt`` launched in the children, and ``fed_agg`` and ``fed_opt``
    over the stack of all 8 deposits (a node's own + 7 peers, the widest
    aggregate of the soak) agreeing with their plain versions. Returns
    (record, launches)."""
    from repro_torch.core import ChaosSpec, FleetSpec, run_fleet_local
    from repro_torch.core.fleet import fleet_state_hash

    spec = FleetSpec(store_uri=os.path.join(root, "soak"), name="fleet_soak",
                     num_nodes=SOAK_NODES, rounds=SOAK_ROUNDS, strategy="fedadam",
                     runner="process", param_size=N_RESNET18,
                     chaos=ChaosSpec(seed=0, kills=1, stalls=1, kill_workers=1,
                                     kill_grace=SOAK_KILL_GRACE))
    t0 = time.perf_counter()
    report = run_fleet_local(spec, num_workers=SOAK_WORKERS, timeout=600.0, device="cuda")
    wall = time.perf_counter() - t0
    survivors = sorted(report.workers)
    own_hash = fleet_state_hash(spec)
    adopters = {w: sorted(p.get("adoptions") or {}) for w, p in report.workers.items()
                if p.get("adoptions")}
    if not (report.passed and report.crashes_injected == 1 and report.restarts == 1
            and all(report.resumed.get(v) for v in report.victims)
            and len(report.workers_lost) == 1 and report.stranded
            and sum(map(len, adopters.values())) >= 1 and set(adopters) <= set(survivors)
            and set(report.fleet_hashes.values()) == {own_hash}
            and set(report.fleet_hashes) == set(survivors)):
        raise AssertionError(f"fleet soak failed acceptance:\n{report.summary()}\n"
                             f"adopters {adopters}, survivors {survivors}, own hash {own_hash}")
    pulled = sorted(spec.connect().pull(), key=lambda u: u.node_id)
    if [u.node_id for u in pulled] != spec.node_ids():
        raise AssertionError(f"soak store holds {[u.node_id for u in pulled]}")
    pulled_check = check_deposits(dev, pulled, fk, fed_agg_ref, fed_opt_ref, seed=2)
    del pulled
    launches = _obs_launches(spec.store_uri)
    if launches["fed_opt"] < 1:
        raise AssertionError(f"the soak's children never launched fed_opt: {launches}")
    pushes = report.total_pushes
    return ({"nodes": SOAK_NODES, "rounds": SOAK_ROUNDS, "workers": SOAK_WORKERS,
             "strategy": spec.strategy, "runner": spec.runner, "param_size": spec.param_size,
             "lease_ttl": spec.lease_ttl, "chaos": spec.chaos.to_dict(),
             "victims": report.victims, "stalled": report.stalled,
             "crashes_injected": report.crashes_injected, "restarts": report.restarts,
             "resumed": report.resumed, "workers_lost": report.workers_lost,
             "stranded": report.stranded, "adopted": report.adopted, "adopters": adopters,
             "recovery_latency_s": report.recovery_latency,
             "adoption_latency_s": report.adoption_latency,
             "fleet_state_hash": own_hash, "total_pushes": pushes,
             "bytes_per_push": report.pipeline_stats.get("bytes_written", 0) / max(1, pushes),
             "rounds_per_sec": report.rounds_per_sec, "report_wall_s": report.wall_seconds,
             "pulled_check": pulled_check, "wall_s": wall, "launches": launches,
             "summary": report.summary()},
            launches)


def obs_phase(store_uri: str) -> dict:
    """``repro_torch.obs`` over the soak's store: the dashboard and the merged
    Chrome trace. Raises unless every soak node appears with all its rounds
    and the trace has spans from every node."""
    from repro_torch.core import chrome_trace, collect_obs
    from repro_torch.obs import render_dashboard

    obs = collect_obs(store_uri)
    lines: list[str] = []
    rollups = render_dashboard(obs, printer=lines.append)
    nodes = rollups["nodes"]
    short = {n: v["rounds"] for n, v in nodes.items() if v["rounds"] < SOAK_ROUNDS}
    if len(nodes) != SOAK_NODES or short:
        raise AssertionError(f"obs sees {sorted(nodes)}; rounds short of {SOAK_ROUNDS}: {short}")
    trace = chrome_trace(obs)
    names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    spans: dict[str, int] = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans[names[e["pid"]]] = spans.get(names[e["pid"]], 0) + 1
    if sorted(spans) != sorted(nodes):
        raise AssertionError(f"trace spans from {sorted(spans)}, want every node {sorted(nodes)}")
    return {"dashboard": lines, "rollups": rollups, "trace_spans": spans}


def federation_lm(dev, root: str, fk, fed_agg_ref, fed_opt_ref) -> tuple[dict, dict]:
    """The paper's §4.4 through the launcher a user runs: ``main(["--simulate",
    "3", "--mode", "async", "--strategy", <s>, ...])`` of
    ``repro_torch.launch.train`` for FedAvg, then FedAdam, on disk stores
    under ``root``, with telemetry on (``REPRO_OBS``) so each silo reports its
    epoch and aggregate spans. Raises unless main exits 0, every silo
    aggregated, every loss is finite, the FedAvg run's mean loss fell from
    the first epoch to the last, and ``fed_agg``/``fed_opt`` over each
    store's pulled (K, N) stack agree with the plain versions at 1e-5.
    Returns the record and the kernel launches the two runs made."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.store import DiskFolder, WeightStore
    from repro_torch.core.tree import LeafSpec
    from repro_torch.data import make_synthetic_wikitext
    from repro_torch.launch import train as lm_train
    from repro_torch.models import build_model

    cfg = get_config(LM_ARCH).replace(vocab_size=512)  # what main makes of --vocab 512
    n_params = LeafSpec.of(build_model(cfg).abstract()).num_params
    runs, launches = {}, {"fed_agg": 0, "fed_opt": 0}
    saved = os.environ.get("REPRO_OBS")
    os.environ["REPRO_OBS"] = "1"
    try:
        for strategy in ("fedavg", "fedadam"):
            store = os.path.join(root, strategy)
            argv = ["--arch", LM_ARCH, "--simulate", str(LM_CLIENTS), "--mode", "async",
                    "--strategy", strategy, "--store", store, "--epochs", str(LM_EPOCHS),
                    "--steps-per-epoch", str(LM_STEPS), "--batch-size", str(LM_BATCH),
                    "--seq-len", str(LM_SEQ), "--lr", LM_LR, "--device", dev.type]
            fk.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = lm_train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = dict(fk.LAUNCHES)
            if rc != 0:
                raise RuntimeError(f"launch.train.main {argv} exited {rc}:\n{out.getvalue()}")
            results = [json.loads(line) for line in out.getvalue().splitlines()
                       if line.startswith("{")]
            if len(results) != LM_CLIENTS:
                raise AssertionError(f"{strategy}: {len(results)} silo results:\n{out.getvalue()}")
            clients = []
            for r in results:
                losses = r["train_loss"] + [r["eval_loss"], r["eval_accuracy"]]
                if not all(math.isfinite(v) for v in losses) or r["aggregations"] < 1:
                    raise AssertionError(f"{strategy} {r['node']}: {r}")
                train, agg = r["spans"]["train"], r["spans"]["aggregate"]
                clients.append({
                    "node": r["node"], "pushes": r["pushes"], "aggregations": r["aggregations"],
                    "train_loss": r["train_loss"], "eval_loss": r["eval_loss"],
                    "eval_accuracy": r["eval_accuracy"],
                    "epoch_s": {k: train[k] for k in ("min_s", "mean_s", "max_s")},
                    "aggregate_host_ms_mean": agg["mean_s"] * 1e3})
            first = sum(c["train_loss"][0] for c in clients) / len(clients)
            last = sum(c["train_loss"][-1] for c in clients) / len(clients)
            name = "fed_agg" if strategy == "fedavg" else "fed_opt"
            if run_launches[name] < 1:
                raise AssertionError(f"the {strategy} run never launched {name}: {run_launches}")
            if strategy == "fedavg" and not last < first:
                raise AssertionError(f"FedAvg mean loss did not fall: {first} -> {last}")
            folder = DiskFolder(store)
            blobs = [len(folder.get(k)) for k in folder.keys() if k.startswith("latest/")]
            pulled = WeightStore(folder).pull()
            runs[strategy] = {
                "wall_s": wall, "launches": run_launches, "clients": clients,
                "mean_train_loss_first_epoch": first, "mean_train_loss_last_epoch": last,
                "bytes_per_push": blobs,
                "pulled_check": check_deposits(dev, pulled, fk, fed_agg_ref, fed_opt_ref, 18)}
            if runs[strategy]["pulled_check"]["N"] != n_params:
                raise AssertionError(f"pulled N {runs[strategy]['pulled_check']['N']} != {n_params}")
            for k in launches:
                launches[k] += run_launches[k]
    finally:
        if saved is None:
            os.environ.pop("REPRO_OBS", None)
        else:
            os.environ["REPRO_OBS"] = saved
    # one silo's train step alone (no other thread), as the launcher builds it
    data = make_synthetic_wikitext(vocab_size=cfg.vocab_size, seed=0)
    trainer, data_fn = lm_train.make_lm_trainer(cfg, data.train_tokens, seq_len=LM_SEQ,
                                                batch_size=LM_BATCH, seed=0, lr=float(LM_LR),
                                                device=dev)
    trainer.run_epoch(data_fn(0), steps=3)
    profiled = profile_call(lambda: trainer.run_epoch(data_fn(1), steps=1), "a pythia train step")
    return {"arch": LM_ARCH, "dtype": cfg.dtype, "params": n_params,
            "reduced": {"vocab_size": [get_config(LM_ARCH).vocab_size, cfg.vocab_size]},
            "clients": LM_CLIENTS, "epochs": LM_EPOCHS, "steps_per_epoch": LM_STEPS,
            "batch": LM_BATCH, "seq_len": LM_SEQ, "lr": float(LM_LR), "runs": runs,
            "profile_one_step_alone": profiled}, launches


def train_ssm(dev) -> dict:
    """mamba2-130m at full width (24 layers, d_model 768, bf16 weights, f32
    adamw moments) through ``launch.steps.make_train_step`` (remat on):
    TRAIN_SSM_STEPS steps on one repeated batch. Raises unless every loss is
    finite, the last is below the first, and no forward-only kernel was
    launched. Then one step at TRAIN_SSM_CHECK_LAYERS layers in f32, on the
    card and on the CPU from the same weights and batch, held at
    TRAIN_SSM_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    forward_only = {"ssd_scan": ssd_kernel, "flash_attention": flash_kernel}

    def kernel_launches():
        return {name: mod.LAUNCHES[name] for name, mod in forward_only.items()}

    cfg = get_config(TRAIN_SSM_ARCH)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_SSM_B, TRAIN_SSM_S + 1), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    params = build_model(cfg).init(0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = adamw(TRAIN_SSM_LR)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    before = kernel_launches()
    torch.cuda.synchronize()
    mem_at_start = torch.cuda.memory_allocated()  # this phase's weights and moments included
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_SSM_STEPS):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    profiled = profile_call(lambda: step(params, opt_state, batch), "a mamba2 train step")
    if kernel_launches() != before:
        raise AssertionError(f"training launched a forward-only kernel: {before} -> "
                             f"{kernel_launches()}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"mamba2 training loss did not fall: {losses}")
    del params, opt_state

    # one f32 step at reduced depth, card vs CPU
    ccfg = cfg.replace(dtype="float32", n_layers=TRAIN_SSM_CHECK_LAYERS)
    cpu_params = build_model(ccfg).init(3, device="cpu")
    results = {}
    for where in (dev.type, "cpu"):
        p = tree_map(lambda t: t.to(where, copy=True), cpu_params)
        o = adamw(TRAIN_SSM_LR)
        s = o.init(p)
        t0 = time.perf_counter()
        p, s, m = make_train_step(ccfg, o)(p, s, {k: v.to(where) for k, v in batch.items()})
        loss = float(m["loss"])
        results[where] = (loss, tree_map(lambda t: t.cpu(), p), tree_map(lambda t: t.cpu(), s["m"]),
                          time.perf_counter() - t0)
    (gl, gp, gm, g_s), (cl, cp, cm, c_s) = results[dev.type], results["cpu"]
    loss_rel = abs(gl - cl) / abs(cl)
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(gm), tree_leaves(cm)))
    param_abs = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(gp), tree_leaves(cp)))
    check = {"n_layers": ccfg.n_layers, "dtype": ccfg.dtype, "loss_card": gl, "loss_cpu": cl,
             "loss_rel_err": loss_rel, "grad_rel_err": grad_rel, "param_max_abs_err": param_abs,
             "tol": TRAIN_SSM_TOL, "step_s_card": g_s, "step_s_cpu": c_s}
    if not (loss_rel <= TRAIN_SSM_TOL["loss_rel"] and grad_rel <= TRAIN_SSM_TOL["grad_rel"]
            and param_abs <= TRAIN_SSM_TOL["param_abs"]):
        raise AssertionError(f"mamba2 train step, card vs CPU, over the tolerance: {check}")
    return {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": n_params, "batch": TRAIN_SSM_B,
            "seq_len": TRAIN_SSM_S, "optimizer": f"adamw({TRAIN_SSM_LR}), f32 m/v",
            "remat": True, "losses": losses, "step_ms": step_ms,
            "peak_device_memory_bytes": peak, "device_memory_at_start_bytes": mem_at_start,
            "forward_only_kernel_launches": 0,
            "profile_step": profiled, "card_vs_cpu": check}


def attention_layers(cfg) -> int:
    """Layers of ``cfg`` that run GQA attention (the kernels' path): ``attn``
    and ``moe_attn`` blocks unless the model's attention is MLA. Layers take
    the pattern in order, group after group, then its head as a tail."""
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    return sum(k in ("attn", "moe_attn") and not (k == "attn" and cfg.attention == "mla")
               for k in kinds)


def zoo_checks(dev, arch: str, kernels: dict) -> dict:
    """The two correctness checks of one `serving_zoo` model. On the card, f32
    at full width and one pattern group: the bulk prefill + decode
    (``serve_batch``) gives the greedy tokens of the token-at-a-time loop
    (``serve_batch_loop``), the prefill launching ``flash_attention`` once per
    attention layer and the loop never. Then the card against the port on the
    CPU at ``reduced()`` in f32, from the same weights: equal greedy tokens,
    and the prefill's logits within ZOO_CPU_TOL of their largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model

    published = get_config(arch)
    cfg = published.replace(dtype="float32", n_layers=len(published.pattern))
    cut = {"dtype": "float32", "n_layers": [published.n_layers, cfg.n_layers]}
    if cfg.sliding_window:
        cut["sliding_window"] = [cfg.sliding_window, ZOO_LOOP_WINDOW]
        cfg = cfg.replace(sliding_window=ZOO_LOOP_WINDOW)
    params = build_model(cfg).init(1, device=dev)
    S = ZOO_LOOP_S[arch]
    prompts = torch.randint(0, cfg.vocab_size, (ZOO_LOOP_B, S), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    attn_layers = attention_layers(cfg)
    flash = kernels["flash_attention"]
    before = flash.LAUNCHES["flash_attention"]
    fast = serve_batch(cfg, params, prompts, new_tokens=ZOO_LOOP_NEW).cpu()
    bulk_launches = flash.LAUNCHES["flash_attention"] - before
    slow = serve_batch_loop(cfg, params, prompts, new_tokens=ZOO_LOOP_NEW).cpu()
    loop_launches = flash.LAUNCHES["flash_attention"] - before - bulk_launches
    if bulk_launches != attn_layers or loop_launches:
        raise AssertionError(f"{arch}: flash_attention launched {bulk_launches} times in the "
                             f"bulk prefill (want {attn_layers}), {loop_launches} in the loop")
    if not torch.equal(fast, slow):
        raise AssertionError(f"{arch}: serve_batch != serve_batch_loop on the card:\n{fast}\n{slow}")
    del params
    loop = {"cut": cut, "batch": ZOO_LOOP_B, "prompt": S, "new_tokens": ZOO_LOOP_NEW,
            "tokens_equal": True, "flash_launches_bulk": bulk_launches}
    return {"bulk_vs_loop": loop, "card_vs_cpu": card_vs_cpu(dev, arch)}


def modal_inputs(cfg, batch: int, seed: int, device) -> dict:
    """``serve_batch``'s other inputs, drawn from ``seed``: an enc-dec's stub
    frames (``frontend_tokens`` of them), a VLM's stub patch embeddings, or
    none."""
    from repro_torch.models.frontends import stub_audio_frames, stub_patch_embeddings

    if cfg.is_encdec:
        return {"frames": stub_audio_frames(seed, cfg, batch, device=device)}
    if cfg.frontend == "vision":
        return {"embeds": stub_patch_embeddings(seed, cfg, batch, device=device)}
    return {}


def modal_prefill(model, cfg, params, prompts, extra: dict, dev) -> torch.Tensor:
    """The bulk prefill's last-position logits over ``prompts`` and the
    model's frames or prefix (``modal_inputs``), from a fresh cache on
    ``dev``."""
    B, S = prompts.shape
    with torch.inference_mode():
        if cfg.is_encdec:
            cache = model.init_cache(params, extra["frames"].to(dev), capacity=S)
            return model.prefill(params, prompts.to(dev), cache)[0]
        embeds = extra["embeds"].to(dev) if "embeds" in extra else None
        P = 0 if embeds is None else embeds.shape[1]
        return model.prefill(params, prompts.to(dev), model.init_cache(B, P + S, device=dev),
                             embeds)[0]


def card_vs_cpu(dev, arch: str) -> dict:
    """``arch`` at ``reduced()`` in f32 on the card against the port on the
    CPU, from the same weights and inputs (``modal_inputs``): equal greedy
    tokens, and the prefill's logits within ZOO_CPU_TOL of their largest
    magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    rcfg = get_config(arch).reduced()
    model = build_model(rcfg)
    cpu_params = model.init(2, device="cpu")
    params = tree_map(lambda t: t.to(dev), cpu_params)
    prompts = torch.randint(0, rcfg.vocab_size, (ZOO_CPU_B, ZOO_CPU_S), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    extra_cpu = modal_inputs(rcfg, ZOO_CPU_B, 2, "cpu")
    extra = {k: v.to(dev) for k, v in extra_cpu.items()}
    got = modal_prefill(model, rcfg, params, prompts, extra, dev)
    want = modal_prefill(model, rcfg, cpu_params, prompts, extra_cpu, "cpu")
    scale = float(want.abs().max())
    rel = float((got.cpu() - want).abs().max()) / scale
    toks_card = serve_batch(rcfg, params, prompts, new_tokens=ZOO_CPU_NEW, **extra).cpu()
    toks_cpu = serve_batch(rcfg, cpu_params, prompts, new_tokens=ZOO_CPU_NEW, **extra_cpu)
    if not (torch.isfinite(got).all() and rel <= ZOO_CPU_TOL):
        raise AssertionError(f"{arch} reduced: prefill logits card vs CPU {rel} of max {scale}")
    if not torch.equal(toks_card, toks_cpu):
        raise AssertionError(f"{arch} reduced: greedy tokens card vs CPU:\n{toks_card}\n{toks_cpu}")
    return {"config": rcfg.name, "dtype": rcfg.dtype, "batch": ZOO_CPU_B,
            "inputs": {k: list(v.shape) for k, v in extra.items()}, "prompt": ZOO_CPU_S,
            "new_tokens": ZOO_CPU_NEW, "tokens_equal": True, "logits_max_rel_err": rel,
            "logits_max_abs": scale, "tol": ZOO_CPU_TOL}


def serving_zoo(dev, kernels: dict) -> tuple[dict, dict]:
    """The rest of the decoder zoo through `serving`'s path (publish →
    ``api.serve`` → traffic → a hot swap), one record per model of ZOO, each
    with its two ``zoo_checks``; the launches of ``flash_attention`` (one per
    attention layer per prefill) and ``decode_attention`` (one per attention
    layer per decoded token) asserted per model (none for MLA, which runs
    plain attention). grok-1, the zoo's other MoE model, has its own phase
    (`serving_grok`). Returns (records, launches)."""
    from repro_torch.configs import get_config

    records, launches = [], {name: 0 for name in kernels}
    for arch, n_layers, prompt in ZOO:
        record, got = serving(dev, arch, ZOO_B, prompt, ZOO_NEW, kernels, n_layers=n_layers)
        attn_layers = attention_layers(get_config(arch).replace(n_layers=n_layers))
        want = {"flash_attention": attn_layers * record["batches"],
                "decode_attention": attn_layers * (ZOO_NEW - 1) * record["batches"]}
        if got != want:
            raise AssertionError(f"{arch}: launched {got}, want one flash_attention per "
                                 f"attention layer per prefill and one decode_attention per "
                                 f"attention layer per token: {want}")
        record["attention_layers"] = attn_layers
        record["checks"] = zoo_checks(dev, arch, kernels)
        records.append(record)
        for name in launches:
            launches[name] += got[name]
    return {"card": torch.cuda.get_device_name(0), "models": records}, launches


def modal_checks(dev, arch: str, kernels: dict) -> dict:
    """The two correctness checks of `serving_encdec` / `serving_prefix`.
    (a) On the card, f32 at full width with the depth cut to
    MODAL_CHECK_LAYERS: the enc-dec's bulk prefill + decode (``serve_batch``,
    one ``flash_attention`` a decoder layer) gives the greedy tokens of its
    token-at-a-time loop (``serve_batch_loop``, which launches none); the
    VLM's prefill over its 256 patches + PREFIX_S tokens (flash) gives the
    last text position's logits of the plain ``apply`` within ZOO_CPU_TOL of
    their largest. (b) The card against the port on the CPU at ``reduced()``
    in f32 from the same weights and inputs: equal greedy tokens, the
    prefill's logits within ZOO_CPU_TOL of their largest."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model

    published = get_config(arch)
    cfg = published.replace(dtype="float32", n_layers=MODAL_CHECK_LAYERS)
    cut = {"dtype": "float32", "n_layers": [published.n_layers, MODAL_CHECK_LAYERS]}
    if cfg.is_encdec:
        cut["encoder_layers"] = [published.encoder_layers, MODAL_CHECK_LAYERS]
        cfg = cfg.replace(encoder_layers=MODAL_CHECK_LAYERS)
    model = build_model(cfg)
    params = model.init(1, device=dev)
    S = ENCDEC_S if cfg.is_encdec else PREFIX_S
    prompts = torch.randint(0, cfg.vocab_size, (MODAL_B, S), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    extra = modal_inputs(cfg, MODAL_B, 1, dev)
    flash = kernels["flash_attention"]
    before = flash.LAUNCHES["flash_attention"]
    first = {"cut": cut, "batch": MODAL_B, "inputs": {k: list(v.shape) for k, v in extra.items()},
             "prompt": S}
    if cfg.is_encdec:
        fast = serve_batch(cfg, params, prompts, new_tokens=MODAL_NEW, **extra).cpu()
        bulk = flash.LAUNCHES["flash_attention"] - before
        slow = serve_batch_loop(cfg, params, prompts, new_tokens=MODAL_NEW, **extra).cpu()
        loop = flash.LAUNCHES["flash_attention"] - before - bulk
        if bulk != cfg.n_layers or loop:
            raise AssertionError(f"{arch}: flash_attention launched {bulk} times in the bulk "
                                 f"prefill (want {cfg.n_layers}), {loop} in the loop")
        if not torch.equal(fast, slow):
            raise AssertionError(f"{arch}: serve_batch != serve_batch_loop on the card:\n"
                                 f"{fast}\n{slow}")
        first.update(new_tokens=MODAL_NEW, tokens_equal=True, flash_launches_bulk=bulk)
    else:
        got = modal_prefill(model, cfg, params, prompts, extra, dev)
        bulk = flash.LAUNCHES["flash_attention"] - before
        with torch.inference_mode():
            want = model.apply(params, prompts.to(dev), extra["embeds"])[0][:, -1]
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        if bulk != cfg.n_layers or not (torch.isfinite(got).all() and rel <= ZOO_CPU_TOL):
            raise AssertionError(f"{arch}: prefill ({bulk} flash launches) vs apply: {rel} of "
                                 f"max {scale}")
        first.update(flash_launches_prefill=bulk, prefill_vs_apply_max_rel_err=rel,
                     logits_max_abs=scale, tol=ZOO_CPU_TOL)
    del params
    return {"bulk_vs_loop" if cfg.is_encdec else "prefill_vs_apply": first,
            "card_vs_cpu": card_vs_cpu(dev, arch)}


def serving_modal(dev, arch: str, kernels: dict) -> tuple[dict, dict]:
    """`serving_encdec` / `serving_prefix`: ``arch`` at its published config
    (full width and depth, bf16, weights from a seed) through ``serve_batch``:
    MODAL_BATCHES batches of MODAL_B prompts with their stub frames or patch
    embeddings, MODAL_NEW greedy tokens each. For the run, the serve
    module's step builders and ``EncDecLM.init_cache`` are wrapped so that
    the bulk prefill, each decode step and the encode are timed on the host
    clock between two synchronisations. Asserts one ``flash_attention`` a
    decoder layer a batch and one ``decode_attention`` a layer a token, and
    equal tokens from every batch; profiles one batch; holds the served
    tokens against the plain f32 model on the card (``check_served_tokens``,
    after the launches are read); then ``modal_checks``. Returns (record,
    launches)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import LeafSpec, tree_map
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import EncDecLM, build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    n_params = LeafSpec.of(model.abstract()).num_params
    params = model.init(0, device=dev)
    S = ENCDEC_S if cfg.is_encdec else PREFIX_S
    prompts = torch.randint(0, cfg.vocab_size, (MODAL_B, S), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(0)).to(dev)
    extra = modal_inputs(cfg, MODAL_B, 0, dev)
    spans: dict[str, list] = {"encode": [], "prefill": [], "decode": []}

    def timed(fn, bucket: str):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[bucket].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    originals = serve_mod.make_bulk_prefill_step, serve_mod.make_serve_step, EncDecLM.init_cache
    serve_mod.make_bulk_prefill_step = lambda c, **kw: timed(originals[0](c, **kw), "prefill")
    serve_mod.make_serve_step = lambda c, **kw: timed(originals[1](c, **kw), "decode")
    EncDecLM.init_cache = timed(originals[2], "encode")
    try:
        serve_mod.serve_batch(cfg, params, prompts[:, :16], new_tokens=2, **extra)  # warm-up
        for bucket in spans.values():
            bucket.clear()
        for wrapper in kernels.values():
            wrapper.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        outs, walls = [], []
        for _ in range(MODAL_BATCHES):
            t0 = time.perf_counter()
            outs.append(serve_mod.serve_batch(cfg, params, prompts, new_tokens=MODAL_NEW, **extra))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = {name: wrapper.LAUNCHES[name] for name, wrapper in kernels.items()}
    finally:
        serve_mod.make_bulk_prefill_step, serve_mod.make_serve_step, EncDecLM.init_cache = originals
    peak_mem = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.n_layers * MODAL_BATCHES,
            "decode_attention": cfg.n_layers * (MODAL_NEW - 1) * MODAL_BATCHES}
    if launches != want:
        raise AssertionError(f"{arch}: launched {launches}, want one flash_attention per decoder "
                             f"layer per batch and one decode_attention per layer per token: {want}")
    out = outs[0]
    if out.shape != (MODAL_B, MODAL_NEW) or not ((out >= 0) & (out < cfg.vocab_size)).all() \
            or any(not torch.equal(o, out) for o in outs):
        raise AssertionError(f"{arch}: bad or unequal tokens over the batches: {outs}")
    profiled = profile_call(lambda: serve_mod.serve_batch(cfg, params, prompts,
                                                          new_tokens=MODAL_NEW, **extra),
                            "serve_batch")
    f32 = tree_map(lambda t: t.to(torch.float32), params)
    del params
    served = check_served_tokens(cfg, {0: (prompts, out, f32, tuple(extra.values()))})
    del f32
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    record = {
        "arch": cfg.name, "source": cfg.source, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model, "params": n_params,
        "batch": MODAL_B, "inputs": {k: list(v.shape) for k, v in extra.items()}, "prompt": S,
        "new_tokens": MODAL_NEW, "batches": MODAL_BATCHES, "batch_wall_ms": walls,
        "encode_ms": spans["encode"] or None, "prefill_ms": spans["prefill"],
        "prefill_ms_p50": pct(spans["prefill"], 50),
        "decode_ms_p50": pct(spans["decode"], 50), "decode_ms_p99": pct(spans["decode"], 99),
        "decode_tokens": len(spans["decode"]),
        "tokens_per_s": MODAL_B * MODAL_NEW / (pct(walls, 50) / 1e3),
        "peak_device_memory_bytes": peak_mem, "launches": launches, "profile": profiled,
        "device_busy_share": (profiled["device_busy_ms"] / profiled["wall_ms"]
                              if "wall_ms" in profiled else None),
        "served_token_checks": served, "checks": modal_checks(dev, arch, kernels)}
    return record, launches


def federated_llm_phase(dev, fk, fed_agg_ref, fed_opt_ref) -> tuple[dict, dict]:
    """``repro_torch.examples.federated_llm.main`` at the example's full
    widths (fedlm-95m: 12 layers, d_model 512, vocab 50,304, f32, LoRA rank
    8), 3 nodes x FED_LLM_EPOCHS epochs x 30 steps, once with the default
    ``delta(chain=4)`` and once ``--adapters-only``, each on a named memory://
    store. Asserts, per run: every node finite, the nodes aggregated,
    ``fed_agg`` launched, and ``fed_agg`` over the store's pulled deposits
    equal to its plain version (``check_deposits``); adapters-only: each push
    after the anchor writes ≤ FED_LLM_ADAPTER_SHARE of a full run's push,
    and at every aggregate each node's non-adapter leaves come back bit for
    bit (checked inside its FederatedCallback). Returns (record, launches)."""
    import contextlib
    import io

    from repro_torch.core import callback as callback_mod
    from repro_torch.core.store import WeightStore, make_folder
    from repro_torch.core.tree import LeafSpec, tree_leaves
    from repro_torch.examples import federated_llm
    from repro_torch.models import build_model

    runs, launches = {}, 0
    personal = {"leaves": 0, "aggregates": 0}
    original = callback_mod.FederatedCallback.on_epoch_end

    def checked(self, trainer, epoch, logs):
        spec = LeafSpec.of(trainer.params)
        keep = [fam is None for fam in spec.family_view(("adapters",)).leaf_names]
        before = [t.clone() for t, k in zip(tree_leaves(trainer.params), keep) if k]
        n = self.node.num_aggregations
        original(self, trainer, epoch, logs)
        if self.node.num_aggregations > n:
            after = [t for t, k in zip(tree_leaves(trainer.params), keep) if k]
            if not all(torch.equal(a, b) for a, b in zip(after, before)):
                raise AssertionError(f"{self.node.node_id}: a non-adapter leaf changed in an "
                                     "adapters-only aggregate")
            personal["leaves"] = len(before)
            personal["aggregates"] += 1

    for mode in ("delta", "adapters_only"):
        uri = f"memory://chip-smoke-federated-llm-{mode}"
        argv = ["--epochs", str(FED_LLM_EPOCHS), "--device", dev.type, "--store", uri]
        if mode == "adapters_only":
            argv.append("--adapters-only")
            callback_mod.FederatedCallback.on_epoch_end = checked
        fk.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                records = federated_llm.main(argv)
        finally:
            callback_mod.FederatedCallback.on_epoch_end = original
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = fk.LAUNCHES["fed_agg"]
        if run_launches < 1 or sum(r["aggregations"] for r in records) < 1:
            raise AssertionError(f"{mode}: fed_agg launched {run_launches} times, "
                                 f"aggregations {[r['aggregations'] for r in records]}")
        for r in records:
            if not all(math.isfinite(v) for v in [r["eval_loss"], *r["train_loss"]]):
                raise AssertionError(f"{mode} {r['node']}: {r}")
        folder = make_folder(uri)
        pulled = WeightStore(folder).pull()
        runs[mode] = {
            "wall_s": wall, "fed_agg_launches": run_launches,
            "nodes": [{"node": r["node"], "eval_loss": r["eval_loss"],
                       "next_token_acc": r["next_token_acc"], "aggregations": r["aggregations"],
                       "mb_written": r["mb_written"], "mb_read": r["mb_read"],
                       "push_bytes": r["push_bytes"], "train_loss": r["train_loss"],
                       "epoch_s": {k: r["spans"]["train"][k] for k in ("min_s", "mean_s", "max_s")},
                       "aggregate_host_ms_mean": (r["spans"]["aggregate"]["mean_s"] * 1e3
                                                  if "aggregate" in r["spans"] else None)}
                      for r in records],
            "pulled_check": check_deposits(dev, pulled, fk, fed_agg_ref, fed_opt_ref, 19)}
        for key in list(folder.keys()):  # the process-wide named folder: free its blobs
            folder.delete(key)
        launches += run_launches
    full = [b for n in runs["delta"]["nodes"] for b in n["push_bytes"]]
    adapters = [b for n in runs["adapters_only"]["nodes"] for b in n["push_bytes"][1:]]
    share = max(adapters) / (sum(full) / len(full))
    if share > FED_LLM_ADAPTER_SHARE or personal["aggregates"] < 1:
        raise AssertionError(f"adapters-only push {max(adapters)} B = {share} of a full push; "
                             f"personal-leaf checks {personal}")
    n_params = LeafSpec.of(build_model(federated_llm.CFG).abstract()).num_params
    return {"config": federated_llm.CFG.name, "params": n_params, "dtype": federated_llm.CFG.dtype,
            "nodes": 3, "epochs": FED_LLM_EPOCHS, "steps_per_epoch": 30,
            "reduced": {"epochs": [10, FED_LLM_EPOCHS]}, "runs": runs,
            "adapter_push_over_full_push": share, "personal_leaf_checks": personal}, \
        {"fed_agg": launches}


def check_served_tokens(cfg, samples: dict) -> list[dict]:
    """Each kept batch (prompts, served tokens, an f32 copy of the weights it
    was served on, and the model's other inputs: an enc-dec's frames or a
    VLM's prefix, or none) against the plain f32 model on those weights, on
    the card, teacher-forced on the served tokens: every token's logit is
    within SERVED_TOL (of the position's largest logit magnitude) of the
    best. The plain forward (``use_flash`` off) launches no kernel."""
    from repro_torch.models import build_model

    model = build_model(cfg.replace(dtype="float32"))
    checks = []
    for counter, (prompts, tokens, params, extra) in samples.items():
        S = prompts.shape[1]
        seq = torch.cat([prompts, tokens[:, :-1]], dim=1)
        with torch.inference_mode():
            logits, _ = model.apply(params, seq, *extra)
        ref = logits[:, S - 1:, :cfg.vocab_size]
        best = ref.amax(dim=-1)
        got = ref.gather(-1, tokens.long()[..., None])[..., 0]
        gap = float(((best - got) / ref.abs().amax(dim=-1)).max())
        checks.append({"counter": counter, "tokens": list(tokens.shape),
                       "argmax_equal": float((ref.argmax(dim=-1) == tokens).float().mean()),
                       "max_gap_over_largest": gap, "tol": SERVED_TOL})
        if not (torch.isfinite(ref).all() and gap <= SERVED_TOL):
            raise AssertionError(f"served tokens at counter {counter}: a token's logit is "
                                 f"{gap} of the largest below the plain f32 model's best")
    return checks


def federated_serving_phase(dev, kernels: dict) -> tuple[dict, dict]:
    """``repro_torch.examples.federated_serving.main`` whole, on the card:
    two trainers federate pythia-14m (full config, bf16) while a ServingNode
    deploys and hot-swaps their aggregates under greedy traffic. Asserts ≥ 1
    swap, the first deploy within the example's 120 s, one
    ``flash_attention`` per layer per batch and one ``decode_attention`` per
    layer per decoded token, and the served tokens of the first batch on
    each of the first SERVED_SAMPLES weight sets against the plain f32 model
    (``check_served_tokens``, after the launches are read). ``kernels`` holds
    the wrappers whose launches are counted (the trainers' FedAvg launches
    ``fed_agg``). Returns (record, launches)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.examples import federated_serving
    from repro_torch.serving.node import ServingNode

    samples = {}  # counter -> (prompts, tokens, f32 weights), both on the card
    original = ServingNode._generate_on

    def kept(self, dep, prompts, new_tokens, on_token):
        out, meta = original(self, dep, prompts, new_tokens, on_token)
        if dep.counter not in samples and len(samples) < SERVED_SAMPLES:
            # a copy: a later swap rewrites this weight set's leaves in place
            samples[dep.counter] = (
                torch.as_tensor(prompts, device=dev), torch.as_tensor(out, device=dev),
                tree_map(lambda t: t.to(torch.float32, copy=True), dep.params), ())
        return out, meta

    for wrapper in kernels.values():
        wrapper.reset_launches()
    out = io.StringIO()
    ServingNode._generate_on = kept
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = federated_serving.main(["--device", dev.type])
    finally:
        ServingNode._generate_on = original
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrapper.LAUNCHES[name] for name, wrapper in kernels.items()}
    stats, batches = result["stats"], result["batches"]
    cfg = get_config("pythia-14m")
    want = {"flash_attention": cfg.n_layers * len(batches),
            "decode_attention": cfg.n_layers * (federated_serving.NEW_TOKENS - 1) * len(batches)}
    if stats["swaps"] < 1 or result["first_deploy_s"] > federated_serving.FIRST_DEPLOY_S:
        raise AssertionError(f"swaps {stats['swaps']}, first deploy {result['first_deploy_s']} s")
    if {k: launches[k] for k in want} != want or launches.get("fed_agg", 0) < 1:
        raise AssertionError(f"federated_serving launched {launches}, want {want} and fed_agg")
    served = check_served_tokens(cfg, samples)
    return {"arch": "pythia-14m", "wall_s": wall, "first_deploy_s": result["first_deploy_s"],
            "batches": len(batches), "tokens_per_s_per_batch": [b["tokens_per_s"] for b in batches],
            "counters_served": [b["counter"] for b in batches], "swaps": stats["swaps"],
            "staleness_mean": stats["staleness_mean"], "staleness_max": stats["staleness_max"],
            "swap_ms_p50": stats["swap_ms_p50"], "swap_ms_p99": stats["swap_ms_p99"],
            "served_token_checks": served, "trainers": result["trainers"],
            "launches": launches}, launches


def examples_phase(dev, root: str, fk, fed_agg_ref, fed_opt_ref) -> tuple[dict, dict]:
    """The nine remaining example twins (``repro_torch.examples``) on the
    card, each through ``main([..., "--device", "cuda"])`` at the reference's
    defaults (stdout kept, its tail recorded); ``multiprocess_federation``
    also with ``--crash``, ``observed_fleet`` also at ``--size`` N_RESNET18.
    Each run is timed and must exit 0 with ``fed_agg`` launched: counted by
    the wrapper in this process, by the strategies in the children for
    ``multiprocess_federation``, and reported by the strategies (or their
    nodes' obs counters) too. Then, per twin: the FedAvgM momentum restored
    bit for bit; ``serve_and_strategies``' reduced mamba2 launching
    ``ssd_scan`` once per layer in its prefill (S 12 < chunk 32), its tokens
    equal to ``serve_batch_loop``'s (the decode path alone) on the same
    weights and to the CPU's; ``serve_demo`` at mamba2-130m's published
    config (``serve_full``); every multiprocess survivor finished; the
    gossip coverage exact (asserted inside the twin); observed_fleet's
    rollup holding 4 nodes x 6 rounds; both soaks passed; and ``fed_agg`` and
    ``fed_opt`` over the pulled deposits of the multiprocess and fleet-soak
    stores equal to their plain versions (``check_deposits``). Returns
    (record, launches)."""
    import contextlib
    import importlib
    import io

    from repro_torch.api import connect
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.examples import serve_and_strategies
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch.serve import serve_batch_loop
    from repro_torch.models import build_model

    runs, checks = {}, {}
    launches = {"fed_agg": 0, "ssd_scan": 0}

    def drive(label: str, name: str, argv: list, *, children: bool = False, **kw) -> dict:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        fk.reset_launches()
        sk.reset_launches()
        rec, out = {}, io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = module.main([*argv, "--device", dev.type], record=rec, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"argv": argv, "exit_code": code, "wall_s": wall,
               "launches": {"fed_agg": (rec["launches"]["fed_agg"] if children
                                        else fk.LAUNCHES["fed_agg"]),
                            "ssd_scan": sk.LAUNCHES["ssd_scan"]},
               "strategies_report": rec["launches"],
               "stdout_tail": out.getvalue().splitlines()[-EXAMPLE_TAIL_LINES:]}
        if code != 0 or run["launches"]["fed_agg"] < 1 or rec["launches"]["fed_agg"] < 1:
            raise AssertionError(f"{label}: exit code {code}, fed_agg launches "
                                 f"{run['launches']} (the strategies report {rec['launches']})"
                                 f":\n{out.getvalue()[-3000:]}")
        for k in launches:
            launches[k] += run["launches"][k]
        runs[label] = run
        return rec

    rec = drive("transport_pipelines", "transport_pipelines", [])
    recovery = rec["recovery"]
    if not (recovery["bit_equal"] and recovery["restored"] == recovery["momentum"] > 0):
        raise AssertionError(f"transport_pipelines: FedAvgM momentum not restored: {recovery}")
    runs["transport_pipelines"].update(envelope=rec["pipelines"]["envelope"],
                                       pipelines=rec["pipelines"]["pipelines"],
                                       prefetch=rec["prefetch"], recovery=recovery)

    rec = drive("serve_and_strategies", "serve_and_strategies", [])
    cfg = get_config("mamba2-130m").reduced()
    served = rec["serve"]
    params = build_model(cfg).init(0, device=dev)  # the twin's weights: its seed, its device
    loop = serve_batch_loop(cfg, params, served["prompts"], new_tokens=served["tokens"].shape[1])
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = serve_and_strategies.serve_demo(device="cpu",
                                              params=tree_map(lambda t: t.cpu(), params))
    n_ssd = runs["serve_and_strategies"]["launches"]["ssd_scan"]
    if n_ssd != cfg.n_layers or not torch.equal(loop, served["tokens"]) \
            or not torch.equal(cpu["tokens"], served["tokens"].cpu()):
        raise AssertionError(f"serve_and_strategies ({cfg.name}): ssd_scan launched {n_ssd} "
                             f"times for {cfg.n_layers} layers; tokens {served['tokens'].tolist()}"
                             f", decode loop {loop.tolist()}, CPU {cpu['tokens'].tolist()}")
    runs["serve_and_strategies"].update(
        config=cfg.name, n_layers=cfg.n_layers, prompt=list(served["prompts"].shape),
        chunk=cfg.ssm_chunk, tokens_equal_decode_loop=True, tokens_equal_cpu=True,
        strategy_rounds=rec["strategies"]["rounds"])
    serve_full = examples_serve_full(dev, sk, serve_and_strategies, serve_batch_loop)
    launches["ssd_scan"] += sum(r["ssd_scan_launches"] for r in serve_full)

    rec = drive("straggler_speedup", "straggler_speedup", [])
    runs["straggler_speedup"].update(
        speedups=rec["virtual_clock"]["speedups"],
        crash_walls=[rec["virtual_clock"]["crash_sync_wall"],
                     rec["virtual_clock"]["crash_async_wall"]],
        sync_wall_s=rec["threads"]["sync"]["wall_s"], async_wall_s=rec["threads"]["async"]["wall_s"],
        sync_over_async=rec["threads"]["ratio"])

    for label, extra, survivors in (("multiprocess_federation", [], 3),
                                    ("multiprocess_federation_crash", ["--crash"], 2)):
        store = os.path.join(root, label)
        rec = drive(label, "multiprocess_federation", ["--store", store, *extra], children=True)
        victim = [c for c in rec["clients"] if "error" in c]
        if rec["finished"] != survivors or any(c["aggregations"] < 1 for c in rec["clients"]
                                               if "error" not in c) \
                or (extra and not (len(victim) == 1 and victim[0]["sigkilled"])):
            raise AssertionError(f"{label}: {rec['clients']}")
        runs[label].update(clients=rec["clients"], startup_s=rec["startup_s"])
        checks[label] = check_deposits(dev, connect(store).pull(), fk, fed_agg_ref,
                                       fed_opt_ref, seed=23)

    rec = drive("sharded_federation", "sharded_federation", [], fleets=EXAMPLE_SCAN_FLEETS)
    nodes = rec["threads"]["nodes"]
    if any(n["aggregations"] < 1 for n in nodes.values()):
        raise AssertionError(f"sharded_federation: a node never aggregated: {nodes}")
    runs["sharded_federation"].update(
        spread=rec["threads"]["spread"], scan_cost=rec["scan_cost"]["fleets"],
        saw_every_other_group=all(
            {f"group:{g}" for g in range(3) if g != n["group"]} <= set(n["gossip_peers"])
            for n in nodes.values()))

    rec = drive("hierarchical_gossip", "hierarchical_gossip", [])  # asserts the coverage
    runs["hierarchical_gossip"].update(coverage=rec["coverage"], spread=rec["spread"],
                                       super_folds=rec["super_folds"], spans=rec["spans"])

    for label, extra in (("observed_fleet", []),
                         ("observed_fleet_resnet18", ["--size", str(N_RESNET18)])):
        store = os.path.join(root, label)
        rec = drive(label, "observed_fleet", ["--store", store, *extra])
        if (rec["fleet"]["nodes_reporting"], rec["fleet"]["rounds_total"]) != (4, 24):
            raise AssertionError(f"{label}: rollup {rec['fleet']}")
        runs[label].update(size=rec["size"], fleet=rec["fleet"])
        shutil.rmtree(store, ignore_errors=True)

    store = os.path.join(root, "fleet_soak")
    rec = drive("fleet_soak", "fleet_soak", ["--store", store])
    if not rec["passed"]:
        raise AssertionError(f"fleet_soak failed:\n{rec['summary']}")
    report = rec["report"]
    runs["fleet_soak"].update(passed=True, crashes_injected=report["crashes_injected"],
                              restarts=report["restarts"],
                              recovery_latency_s=report["recovery_latency"],
                              rounds_per_sec=report["rounds_per_sec"])
    checks["fleet_soak"] = check_deposits(dev, connect(store).pull(), fk, fed_agg_ref,
                                          fed_opt_ref, seed=24)

    rec = drive("elastic_fleet", "elastic_fleet", ["--store", os.path.join(root, "elastic")])
    if not rec["passed"]:
        raise AssertionError(f"elastic_fleet failed:\n{rec['summary']}")
    runs["elastic_fleet"].update(passed=True, workers_lost=rec["report"]["workers_lost"],
                                 stranded=rec["report"]["stranded"],
                                 rescuer_adopted=rec["rescuer_adopted"],
                                 adoption_latency_s=rec["adoption_latency_s"])
    return {"runs": runs, "serve_full": serve_full, "deposit_checks": checks,
            "wall_s": sum(r["wall_s"] for r in runs.values()), "launches": launches}, launches


def examples_serve_full(dev, sk, serve_and_strategies, serve_batch_loop) -> list[dict]:
    """``serve_demo`` (4 prompts of 12 tokens, 12 new) at mamba2-130m's
    published config, bf16: a prompt shorter than one chunk of 256, so the
    prefill's ``ssd_mma_kernel`` scans one partial chunk in each of the 24
    layers; then the same widths in f32 (``ssd_scan_kernel``). Each must
    launch ``ssd_scan`` once per layer. In f32 the tokens must equal
    ``serve_batch_loop``'s (the decode path alone) on the same weights. In
    bf16 the two paths round differently (on the CPU's plain path too), so
    a near-tie can take another token and the sequences part: there the
    agreement is recorded, and the served tokens are held near-argmax to
    the plain f32 model on the same weights, teacher-forced
    (``check_served_tokens``). Also times the prefill alone (``serve_batch``
    with one new token, host wall, synchronised)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    records = []
    published = get_config("mamba2-130m")
    for cfg in (published, published.replace(dtype="float32")):
        sk.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = serve_and_strategies.serve_demo(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_ssd = sk.LAUNCHES["ssd_scan"]
        tokens = rec["tokens"]
        params = build_model(cfg).init(0, device=dev)
        loop = serve_batch_loop(cfg, params, rec["prompts"], new_tokens=tokens.shape[1])
        same = (loop == tokens).all(dim=0)
        first_split = int(same.logical_not().nonzero()[0]) if not bool(same.all()) else None
        record = {"config": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "chunk": cfg.ssm_chunk,
                  "prompts": list(rec["prompts"].shape), "new_tokens": tokens.shape[1],
                  "ssd_scan_launches": n_ssd, "wall_s": wall,
                  "tokens_equal_decode_loop": first_split is None,
                  "first_position_apart": first_split,
                  "agreement": float((loop == tokens).float().mean())}
        if n_ssd != cfg.n_layers:
            raise AssertionError(f"serve_demo {cfg.name} {cfg.dtype}: ssd_scan launched {n_ssd} "
                                 f"times for {cfg.n_layers} layers")
        if cfg.dtype == "float32" and first_split is not None:
            raise AssertionError(f"serve_demo {cfg.name} f32: tokens {tokens.tolist()} != the "
                                 f"decode loop's {loop.tolist()}")
        if cfg.dtype != "float32":
            prompts = torch.as_tensor(rec["prompts"], device=dev)
            f32 = tree_map(lambda t: t.to(torch.float32, copy=True), params)
            record["served_token_checks"] = check_served_tokens(
                cfg, {0: (prompts, tokens, f32, ())})
            del f32
        times = []
        for _ in range(EXAMPLE_PREFILL_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve_batch(cfg, params, rec["prompts"], new_tokens=1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        record["prefill_ms"] = sorted(times[1:])[len(times[1:]) // 2]  # median after a warm call
        records.append(record)
        del params, loop
    return records


def serving_grok(dev, kernels: dict) -> dict:
    """grok-1 on the card. Its logit softcap takes the capped plain attention
    on every device, as the reference routes it, so neither attention kernel
    may launch. First the card against the CPU at ``reduced()`` in f32
    (``card_vs_cpu``), then full width in bf16 at GROK_LAYERS layers, weights
    drawn on the card, through ``serve_batch``: GROK_B x GROK_S prompts,
    GROK_NEW greedy tokens, timed; the tokens must lie in the vocab and the
    prefill's logits be finite."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.tree import LeafSpec
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    for wrapper in kernels.values():
        wrapper.reset_launches()
    check = card_vs_cpu(dev, GROK_ARCH)
    published = get_config(GROK_ARCH)
    cfg = published.replace(n_layers=GROK_LAYERS)
    model = build_model(cfg)
    n_params = LeafSpec.of(model.abstract()).num_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (GROK_B, GROK_S),
                                                dtype=np.int32)
    serve_batch(cfg, params, prompts[:, :16], new_tokens=2)  # warm-up
    timings = []
    for new in (1, GROK_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_batch(cfg, params, prompts, new_tokens=new).cpu().numpy()
        timings.append(time.perf_counter() - t0)
    with torch.inference_mode():
        logits = model.prefill(params, torch.from_numpy(prompts).to(dev),
                               model.init_cache(GROK_B, GROK_S, device=dev))[0]
    torch.cuda.synchronize()
    launches = {name: wrapper.LAUNCHES[name] for name, wrapper in kernels.items()}
    if any(launches.values()):
        raise AssertionError(f"grok-1 (softcap) launched an attention kernel: {launches}")
    if not (torch.isfinite(logits).all() and out.shape == (GROK_B, GROK_NEW)
            and ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"grok-1: bad output (tokens {out.shape}, finite logits "
                             f"{bool(torch.isfinite(logits).all())})")
    peak = torch.cuda.max_memory_allocated()
    del params, logits
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "reduced": {"n_layers": [published.n_layers, cfg.n_layers]}, "params": n_params,
            "attn_logit_softcap": cfg.attn_logit_softcap, "batch": GROK_B, "prompt": GROK_S,
            "new_tokens": GROK_NEW, "init_on_card_s": init_s, "prefill_ms": timings[0] * 1e3,
            "decode_ms_per_token": (timings[1] - timings[0]) / (GROK_NEW - 1) * 1e3,
            "peak_device_memory_bytes": peak, "launches": launches, "card_vs_cpu": check}


def mesh_serving_child(root: str, out: str) -> None:
    """The `mesh_serving` phase's child process: a world-1 NCCL group (a
    FileStore under ``root``) and its (1, 1) host mesh; `serving`'s path with
    ``mesh=`` for each of MESH_SERVING (tokens equal to serve_batch's on the
    pushed weights without a mesh, launches read around the traffic), then the
    prefill logits on DTensor weights against the mesh-less path's. Writes
    its records to ``out``; any failure raises (a non-zero exit)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import data_axes, make_host_mesh, start_group
    from repro_torch.launch.sharding import distribute, param_shardings, serve_cache_shardings
    from repro_torch.models import build_model
    from repro_torch.models.sharded import serving_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    start_group(os.path.join(root, "pg"), rank=0, world_size=1, device="cuda")
    try:
        mesh = make_host_mesh()
        kernels = {"flash_attention": flash_kernel, "decode_attention": dec_kernel,
                   "ssd_scan": ssd_kernel}
        records = []
        for arch, n_layers, batch, prompt, new in MESH_SERVING:
            record, launches = serving(dev, arch, batch, prompt, new, kernels,
                                       n_layers=n_layers, mesh=mesh)
            L, nb = record["n_layers"], record["batches"]
            want = ({"flash_attention": 0, "decode_attention": 0, "ssd_scan": L * nb}
                    if arch == SSM_ARCH else
                    {"flash_attention": L * nb, "decode_attention": L * (new - 1) * nb,
                     "ssd_scan": 0})
            if launches != want:
                raise AssertionError(f"{arch} on the mesh launched {launches}, want {want}")
            # prefill logits, f32: DTensor weights against the same weights plain
            cfg = get_config(arch).replace(dtype="float32",
                                           n_layers=n_layers or get_config(arch).n_layers)
            model = build_model(cfg)
            params = model.init(3, device=dev)
            dparams = distribute(params, param_shardings(params, mesh))
            prompts = torch.randint(0, cfg.vocab_size, (MESH_CHECK_B, MESH_CHECK_S),
                                    generator=torch.Generator().manual_seed(3),
                                    dtype=torch.int32).to(dev)
            with torch.inference_mode():
                cache = model.init_cache(MESH_CHECK_B, MESH_CHECK_S, device=dev)
                logits = [model.prefill(params, prompts, cache)[0]]
            cache = model.init_cache(MESH_CHECK_B, MESH_CHECK_S, device=dev)
            cache = distribute(cache, serve_cache_shardings(cache, mesh))
            tokens = shard_batch({"t": prompts}, mesh, batch_axes=data_axes(mesh))["t"]
            with serving_mode(dparams):
                logits.append(model.prefill(dparams, tokens, cache)[0].full_tensor())
            scale = float(logits[0].abs().max())
            rel = float((logits[1] - logits[0]).abs().max()) / scale
            if not (torch.isfinite(logits[1]).all() and rel <= MESH_LOGITS_TOL):
                raise AssertionError(f"{arch}: mesh prefill logits {rel} of max {scale}")
            del params, dparams, logits
            record["logits_vs_meshless"] = {"dtype": "float32", "batch": MESH_CHECK_B,
                                            "prompt": MESH_CHECK_S, "max_rel_err": rel,
                                            "tol": MESH_LOGITS_TOL}
            record["want_launches"] = want
            records.append(record)
        with open(out, "w") as f:
            json.dump(records, f)
    finally:
        dist.destroy_process_group()


def mesh_serving(root: str) -> tuple[list, dict]:
    """`mesh_serving_child` in a spawned process (its NCCL group stays out of
    this one); its failure fails this phase. → (records, launches)."""
    import multiprocessing

    out = os.path.join(root, "mesh_serving.json")
    proc = multiprocessing.get_context("spawn").Process(target=mesh_serving_child,
                                                        args=(root, out))
    proc.start()
    proc.join(MESH_CHILD_TIMEOUT_S)
    if proc.is_alive():
        proc.kill()
        proc.join(10)
        raise AssertionError(f"mesh_serving's child still ran after {MESH_CHILD_TIMEOUT_S} s")
    if proc.exitcode != 0:
        raise AssertionError(f"mesh_serving's child exited with {proc.exitcode}")
    with open(out) as f:
        records = json.load(f)
    launches = {}
    for r in records:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return records, launches


def step_costs_phase(serve_rec: dict, ssm_rec: dict) -> dict:
    """``launch.costs.step_costs`` of the serving phases' steps on meta
    tensors (no device time): flops, bytes and ``roofline_terms(chips=1)``
    of granite's bulk prefill and one decode step and mamba2's, beside the
    p50s those phases measured in this call, and their ratio: the measured
    time's share of the step's bound."""
    from repro_torch.configs import get_config
    from repro_torch.launch import costs as C
    from repro_torch.launch.steps import make_bulk_prefill_step, make_serve_step
    from repro_torch.models import build_model

    steps = []
    for rec, (arch, B, S, new) in ((serve_rec, (SERVE_ARCH, SERVE_B, SERVE_S, SERVE_NEW)),
                                   (ssm_rec, (SSM_ARCH, SSM_B, SSM_S, SSM_NEW))):
        cfg = get_config(arch)
        model = build_model(cfg)
        params = model.abstract()
        tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
        for kind, measured_ms in (("bulk_prefill", rec["prefill_ms_p50"]),
                                  ("decode_step", rec["decode_ms_p50_steady"])):
            cache = model.init_cache(B, S + new, device="meta")
            if kind == "bulk_prefill":
                sc, _ = C.step_costs(make_bulk_prefill_step(cfg), params, tokens, cache)
            else:
                sc, _ = C.step_costs(make_serve_step(cfg), params, tokens[:, 0], cache, S)
            terms = C.roofline_terms(total_flops=sc.flops, total_bytes=sc.bytes,
                                     coll_bytes=0.0, chips=1)
            bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
            steps.append({"arch": arch, "n_layers": cfg.n_layers, "step": kind, "batch": B,
                          "tokens": S if kind == "bulk_prefill" else 1, "ring": S + new,
                          "flops": sc.flops, "bytes": sc.bytes, **terms, "bound_ms": bound_ms,
                          "measured_p50_ms": measured_ms,
                          "roofline_share": bound_ms / measured_ms if measured_ms else None})
    return {"peaks": {"bf16_flops_per_s": C.PEAK_FLOPS_BF16, "hbm_bytes_per_s": C.HBM_BW,
                      "nvlink_bytes_per_s": C.NVLINK_BW, "source": "H100 SXM5 datasheet, 700 W"},
            "steps": steps}


def dryrun_start(root: str):
    """Run DRYRUN's combinations one after another in a background thread, on
    the CPU (no card visible), each a ``python -m repro_torch.launch.dryrun``
    process capped at DRYRUN_TIMEOUT_S. → (thread, results list)."""
    import threading

    results: list = []
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}

    def run():
        for arch, shape in DRYRUN:
            out = os.path.join(root, f"dryrun_{arch}_{shape}.jsonl")
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                                       "--arch", arch, "--shape", shape, "--out", out],
                                      env=env, capture_output=True, text=True,
                                      timeout=DRYRUN_TIMEOUT_S)
                rc, tail = proc.returncode, proc.stderr[-2000:]
            except subprocess.TimeoutExpired:
                rc, tail = None, f"cut at {DRYRUN_TIMEOUT_S} s"
            recs = []
            if os.path.exists(out):
                with open(out) as f:
                    recs = [json.loads(line) for line in f]
            results.append({"arch": arch, "shape": shape, "rc": rc,
                            "wall_s": time.perf_counter() - t0, "records": recs,
                            "stderr_tail": tail if rc else ""})

    thread = threading.Thread(target=run, name="dryrun", daemon=True)
    thread.start()
    return thread, results


def dryrun_join(thread, results: list) -> dict:
    """Wait for `dryrun_start`'s runs; every combination must exit 0 with ok
    records."""
    thread.join(len(DRYRUN) * (DRYRUN_TIMEOUT_S + 30))
    if thread.is_alive() or len(results) != len(DRYRUN):
        raise AssertionError(f"the dry run did not finish: {len(results)} of {len(DRYRUN)}")
    for r in results:
        if r["rc"] != 0 or not r["records"] or not all(rec["ok"] for rec in r["records"]):
            raise AssertionError(f"dry run {r['arch']} {r['shape']} failed: rc {r['rc']}\n"
                                 f"{r['stderr_tail']}")
    return {"mesh": "16x16 (fake process group, one CPU process)", "runs": results}


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit(f"chip_smoke: the port's sources (src/repro_torch) are not beside {__file__}; "
                 "run it from a checkout of the repository")
    from repro_torch.kernels import _build
    from repro_torch.kernels.fed_agg import kernel as fk
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref, fed_opt_ref

    # The oracles run in full f32 (no TF32 in matmuls or convolutions).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    # -- 1. device --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=card, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    # per source, in order: each kernel instance's name, then its registers and spills
    ptxas = {name: [line.split("ptxas info    : ")[-1].strip() for line in log.splitlines()
                    if "Compiling entry function" in line or "registers" in line or "spill" in line]
             for name, log in _build.build_logs.items()}
    emit("build", seconds=time.perf_counter() - t0, libraries=[str(p) for p in libs.values()],
         ptxas=ptxas)

    # -- 3. kernel_check --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {"fed_agg": 0.0, "fed_opt": 0.0}
    checks = []
    timings = []

    def check(name, got, want, k, shape_note):
        rtol = 1e-5 if k <= 64 else 1e-4
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(torch.allclose(g, w, rtol=rtol, atol=1e-5) for g, w in zip(got, want))
        checks.append({"kernel": name, "shape": shape_note, "max_abs_err": err, "rtol": rtol,
                       "atol": 1e-5, "ok": ok})
        max_err[name] = max(max_err[name], err)
        if not ok:
            raise AssertionError(f"{name} {shape_note}: max abs err {err} over rtol {rtol}/atol 1e-5")

    for k, n in CHECK_SHAPES:
        # the ResNet-18 shape also runs with the strategies' padded row stride
        for ld in ([n, -(-n // 32) * 32] if n == N_RESNET18 else [n]):
            x = torch.randn(k, ld, device=dev, generator=gen)[:, :n]
            w = torch.rand(k, device=dev, generator=gen)
            w /= w.sum()
            note = f"K={k} N={n} ld={ld}"
            check("fed_agg", [fk.fed_agg(x, w)], [fed_agg_ref(x, w)], k, note)
            p = torch.randn(n, device=dev, generator=gen)
            m = torch.randn(n, device=dev, generator=gen) * 0.1
            v = torch.rand(n, device=dev, generator=gen) * 0.01
            for variant in ("adam", "yogi", "adagrad"):
                check("fed_opt", fk.fed_opt(x, w, p, m, v, variant=variant, **OPT_HP),
                      fed_opt_ref(x, w, p, m, v, variant=variant, **OPT_HP), k,
                      f"{note} {variant}")
            del x, p, m, v
    torch.cuda.synchronize()
    emit("kernel_check", checks=checks)

    # -- 4. kernels: time beside bound, plain version and library call ----------
    for k, n in TIME_SHAPES:
        ld = -(-n // 32) * 32  # the strategies' stack layout

        def make():
            x = torch.randn(k, ld, device=dev, generator=gen)[:, :n]
            w = torch.full((k,), 1.0 / k, device=dev)
            p, m, v = (torch.randn(n, device=dev, generator=gen) for _ in range(3))
            return x, w, p, m, v.abs()
        sets = cold_sets(make, (k + 6) * n * 4)  # the inputs alone exceed the L2: one set
        timings.append({
            "name": "fed_agg", "K": k, "N": n, "inputs": f"{len(sets)} set(s)",
            "kernel_ms": time_ms(lambda x, w, *_: fk.fed_agg(x, w), sets),
            "plain_ms": time_ms(lambda x, w, *_: fed_agg_ref(x, w), sets),
            "library_ms": time_ms(lambda x, w, *_: torch.mv(x.t(), w), sets),
            **bound("fed_agg", k, n, card)})
        timings.append({
            "name": "fed_opt", "variant": "adam", "K": k, "N": n, "inputs": f"{len(sets)} set(s)",
            "kernel_ms": time_ms(lambda *a: fk.fed_opt(*a, variant="adam", **OPT_HP), sets),
            "plain_ms": time_ms(lambda *a: fed_opt_ref(*a, variant="adam", **OPT_HP), sets),
            "library_ms": None,
            **bound("fed_opt", k, n, card)})
        del sets
    emit("kernels", card=card, nvidia_smi=smi, timings=timings)

    # -- 5. attn_kernel_check / 6. attn_kernels ----------------------------------
    attn_checks, max_err_attn = check_attention(dev, gen)
    max_err.update(max_err_attn)
    emit("attn_kernel_check", checks=attn_checks)
    attn_timings = time_attention(dev, gen, card)
    timings += attn_timings
    emit("attn_kernels", card=card, nvidia_smi=smi, timings=attn_timings,
         compiled=attn_build_report(libs))

    # -- 7. ssd_kernel_check / 8. ssd_kernels --------------------------------------
    ssd_checks, max_err["ssd_scan"] = check_ssd(dev, gen)
    emit("ssd_kernel_check", checks=ssd_checks)
    ssd_timings = time_ssd(dev, gen, card)
    timings += ssd_timings
    emit("ssd_kernels", card=card, nvidia_smi=smi, timings=ssd_timings,
         compiled=ssd_build_report(libs))

    # -- 8b. ssm_prefill_kernel_check / ssm_prefill_kernels --------------------
    prefill_checks, prefill_err = check_ssm_prefill(dev, gen)
    max_err.update(prefill_err)
    emit("ssm_prefill_kernel_check", checks=prefill_checks)
    prefill_timings = time_ssm_prefill(dev, gen, card)
    timings += prefill_timings
    emit("ssm_prefill_kernels", card=card, nvidia_smi=smi, timings=prefill_timings)

    # -- 9. federation: the port's first main path, end to end -------------------
    from repro_torch.api import connect
    from repro_torch.core import AsyncFederatedNode, FederatedCallback, run_threaded
    from repro_torch.core.partition import partition_dataset
    from repro_torch.core.strategies import FedAdam, FedAvg
    from repro_torch.data import batch_iterator, make_synthetic_cifar
    from repro_torch.models.cnn import ResNet
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import adam
    from repro_torch.training import Trainer

    data = make_synthetic_cifar(num_train=FED_CLIENTS * 2048, num_test=1024, seed=0)
    shards = partition_dataset(data.x_train, data.y_train, num_nodes=FED_CLIENTS, skew=0.5)
    model = ResNet()
    init = model.init(0, device=dev)  # one common init, copied by each trainer
    n_params = sum(t.numel() for t in tree_leaves(init))
    assert n_params == N_RESNET18, n_params

    with tempfile.TemporaryDirectory(prefix="repro_torch_smoke_") as folder:
        def client(i: int):
            strategy = FedAvg() if i < 2 else FedAdam(server_lr=1e-3, tau=1e-3)
            node = AsyncFederatedNode(strategy=strategy, store=connect(folder),
                                      node_id=f"client{i}", telemetry=True)
            trainer = Trainer(loss_fn=lambda prm, b, r: model.loss(prm, b), optimizer=adam(1e-3),
                              init_params=init, seed=i, name=f"client{i}",
                              telemetry=node.telemetry)
            clock = EpochClock()
            x, y = shards[i]
            trainer.fit(lambda e: batch_iterator(x, y, batch_size=FED_BATCH, seed=i, epoch=e),
                        epochs=FED_EPOCHS, steps_per_epoch=FED_STEPS,
                        callbacks=[clock, FederatedCallback(node, num_examples_per_epoch=FED_STEPS * FED_BATCH)])
            return node, trainer, clock

        fk.reset_launches()
        t0 = time.perf_counter()
        results = run_threaded([lambda i=i: client(i) for i in range(FED_CLIENTS)],
                               names=[f"client{i}" for i in range(FED_CLIENTS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        for r in results:
            if r.error is not None:
                raise RuntimeError(f"{r.node_id} failed:\n{r.traceback}")
        per_client = []
        for r in results:
            node, trainer, clock = r.result
            losses = [log["loss"] for log in trainer.log]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{r.node_id}: non-finite loss {losses}")
            if node.num_aggregations < 1:
                raise AssertionError(f"{r.node_id} never aggregated")
            with torch.no_grad():
                logits = torch.cat([model.apply(trainer.params, torch.from_numpy(
                    data.x_test[j:j + 256]).to(dev)) for j in range(0, len(data.x_test), 256)])
            acc = float((logits.argmax(-1).cpu().numpy() == data.y_test).mean())
            phases = node.telemetry.recorder.phase_stats()
            per_client.append({
                "node": r.node_id, "strategy": node.strategy.name,
                "aggregations": node.num_aggregations, "losses": losses,
                "epoch_s": clock.seconds, "test_accuracy": acc,
                "aggregate_host_ms_mean": phases.get("aggregate", {}).get("mean_s", 0.0) * 1e3})
        for name in ("fed_agg", "fed_opt"):
            if launches[name] < 1:
                raise AssertionError(f"the federation run never launched {name}: {launches}")

        # What came out agrees with the plain version: stack every client's
        # latest deposit on the card and hold fed_agg against fed_agg_ref.
        pulled = connect(folder).pull()
        if len(pulled) != FED_CLIENTS:
            raise AssertionError(f"store holds {len(pulled)} clients, want {FED_CLIENTS}")
        stack = torch.stack([torch.from_numpy(u.flat) for u in pulled]).to(dev)
        coeffs = torch.full((FED_CLIENTS,), 1.0 / FED_CLIENTS, device=dev)
        got, want = fk.fed_agg(stack, coeffs), fed_agg_ref(stack, coeffs)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"fed_agg over the pulled deposits: max abs err {err}")
    emit("federation", model="ResNet-18 GN", params=n_params, clients=per_client,
         wall_s=wall, launches=launches, pulled_fed_agg_max_abs_err=err)

    # -- 10. federation_gossip: the federation plane (sharded gossip, delta and
    #        top-k transports) on the same model and data ----------------------
    with tempfile.TemporaryDirectory(prefix="repro_torch_gossip_") as root:
        record, gossip_launches = federation_gossip(dev, root, model, init, shards, fk,
                                                    fed_agg_ref)
    emit("federation_gossip", card=card, nvidia_smi=smi, **record)
    launches = {name: launches[name] + gossip_launches[name] for name in launches}

    # -- 11. federation_processes: the same clients as OS processes, one of
    #        them SIGKILLed mid-training and respawned --------------------------
    with tempfile.TemporaryDirectory(prefix="repro_torch_procs_") as root:
        record, proc_launches = federation_processes(dev, root, fk, fed_agg_ref, fed_opt_ref)
    emit("federation_processes", card=card, nvidia_smi=smi, **record)
    deposit_errs = [record["pulled_check"]["max_abs_err"]]

    # -- 12. fleet_soak / 13. obs: the elastic fleet with chaos, then the
    #        observability reader over its store -----------------------------
    with tempfile.TemporaryDirectory(prefix="repro_torch_soak_") as root:
        record, soak_launches = fleet_soak(dev, root, fk, fed_agg_ref, fed_opt_ref)
        emit("fleet_soak", card=card, nvidia_smi=smi, **record)
        deposit_errs.append(record["pulled_check"]["max_abs_err"])
        emit("obs", **obs_phase(os.path.join(root, "soak")))
    launches = {name: launches[name] + proc_launches[name] + soak_launches[name]
                for name in launches}

    # -- 14. federation_lm / 15. train_ssm: federated LM training (paper §4.4)
    #        through the launcher, then Mamba2 training --------------------------
    with tempfile.TemporaryDirectory(prefix="repro_torch_lm_") as root:
        record, lm_launches = federation_lm(dev, root, fk, fed_agg_ref, fed_opt_ref)
    emit("federation_lm", card=card, nvidia_smi=smi, **record)
    deposit_errs += [run["pulled_check"]["max_abs_err"] for run in record["runs"].values()]
    launches = {name: launches[name] + lm_launches[name] for name in launches}
    for name in ("fed_agg", "fed_opt"):
        max_err[name] = max(max_err[name], *(e[name] for e in deposit_errs))
    emit("train_ssm", card=card, nvidia_smi=smi, **train_ssm(dev))

    # -- 16. federated_llm / 17. federated_serving: the two LM examples --------
    record, llm_launches = federated_llm_phase(dev, fk, fed_agg_ref, fed_opt_ref)
    emit("federated_llm", card=card, nvidia_smi=smi, **record)
    max_err["fed_agg"] = max(max_err["fed_agg"], *(
        run["pulled_check"]["max_abs_err"]["fed_agg"] for run in record["runs"].values()))
    launches["fed_agg"] += llm_launches["fed_agg"]
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    record, fs_launches = federated_serving_phase(
        dev, {"flash_attention": flash_kernel, "decode_attention": dec_kernel, "fed_agg": fk})
    emit("federated_serving", card=card, nvidia_smi=smi, **record)
    launches["fed_agg"] += fs_launches["fed_agg"]

    # -- 18. examples: the nine remaining example twins, through their mains
    with tempfile.TemporaryDirectory(prefix="repro_torch_examples_") as root:
        record, ex_launches = examples_phase(dev, root, fk, fed_agg_ref, fed_opt_ref)
    emit("examples", card=card, nvidia_smi=smi, **record)
    launches["fed_agg"] += ex_launches["fed_agg"]
    max_err["fed_agg"] = max(max_err["fed_agg"], *(
        c["max_abs_err"]["fed_agg"] for c in record["deposit_checks"].values()))

    # -- 19. serving_consistency / 20. serving: the port's second main path -----
    emit("serving_consistency", **serving_consistency(
        dev, SERVE_ARCH, CONSIST_B, CONSIST_S, CONSIST_NEW, flash_kernel, (2, 64)))
    record, serving_launches = serving(dev, SERVE_ARCH, SERVE_B, SERVE_S, SERVE_NEW,
                                       {"flash_attention": flash_kernel,
                                        "decode_attention": dec_kernel})
    want = {"flash_attention": record["n_layers"] * record["batches"],
            "decode_attention": record["n_layers"] * (SERVE_NEW - 1) * record["batches"]}
    if serving_launches != want:
        raise AssertionError(f"serving launched {serving_launches}, want one flash_attention per "
                             f"layer per prefill and one decode_attention per layer per token: {want}")
    emit("serving", **record)
    serve_record = record
    for name in serving_launches:
        launches[name] = fs_launches[name] + serving_launches[name]
    profiles = {"flash_attention": record["profile"]["prefill"],
                "decode_attention": record["profile"]["prefill_and_16_tokens"]}

    # -- 21. serving_ssm_consistency / 22. serving_ssm: Mamba2, the reference's
    #        serving default, through the same entry points -------------------------
    emit("serving_ssm_consistency", **serving_consistency(
        dev, SSM_ARCH, SSM_CONSIST_B, SSM_CONSIST_S, SSM_CONSIST_NEW, ssd_kernel,
        (SSM_CONSIST_B, SSM_CONSIST_S)))
    from repro_torch.kernels.ssm_prefill import kernel as prefill_kernel

    record, ssm_launches = serving(dev, SSM_ARCH, SSM_B, SSM_S, SSM_NEW,
                                   {"ssd_scan": ssd_kernel, "ssm_prefill_in": prefill_kernel,
                                    "ssm_prefill_out": prefill_kernel})
    for name, n in ssm_launches.items():  # one of each a layer a prefill
        if n != record["n_layers"] * record["batches"]:
            raise AssertionError(f"{name} launched {n} times for {record['batches']} prefills "
                                 f"of {record['n_layers']} layers")
    emit("serving_ssm", **record)
    ssm_record = record
    launches["ssd_scan"] = ssm_launches["ssd_scan"] + ex_launches["ssd_scan"]
    for name in ("ssm_prefill_in", "ssm_prefill_out"):
        launches[name] = ssm_launches[name]
    for name in ("ssd_scan", "ssm_prefill_in", "ssm_prefill_out"):
        profiles[name] = record["profile"]["prefill"]

    # the dry run is CPU work on fake tensors, one core: it runs beside the zoo
    # (the longest phase after the main paths, whose host times it would perturb)
    work = tempfile.mkdtemp(prefix="repro_torch_launch_")
    dryrun = dryrun_start(work)

    # -- 23. serving_zoo: MoE, RG-LRU and MLA decoders through the same path ----
    attn_kernels = {"flash_attention": flash_kernel, "decode_attention": dec_kernel}
    record, zoo_launches = serving_zoo(dev, attn_kernels)
    emit("serving_zoo", nvidia_smi=smi, **record)
    for name in zoo_launches:
        launches[name] += zoo_launches[name]

    # -- 24. serving_encdec / 25. serving_prefix: the enc-dec and the VLM prefix
    for phase, arch in (("serving_encdec", ENCDEC_ARCH), ("serving_prefix", PREFIX_ARCH)):
        record, modal_launches = serving_modal(dev, arch, attn_kernels)
        emit(phase, nvidia_smi=smi, **record)
        for name in modal_launches:
            launches[name] += modal_launches[name]

    # -- 26. serving_grok: grok-1's softcap on the card (plain capped attention)
    emit("serving_grok", nvidia_smi=smi, **serving_grok(dev, attn_kernels))

    # -- 27. mesh_serving: api.serve(mesh=) on a world-1 NCCL mesh, in a child
    mesh_records, mesh_launches = mesh_serving(work)
    emit("mesh_serving", nvidia_smi=smi, models=mesh_records)
    for name, n in mesh_launches.items():
        launches[name] += n

    # -- 28. step_costs: each served step's flops and bytes beside its p50
    emit("step_costs", nvidia_smi=smi, **step_costs_phase(serve_record, ssm_record))

    # -- 29. dryrun: python -m repro_torch.launch.dryrun on the fake 16x16 mesh
    emit("dryrun", **dryrun_join(*dryrun))
    shutil.rmtree(work, ignore_errors=True)
    emit("timer_check", **timer_check(timings, profiles))

    # -- summary ----------------------------------------------------------------
    main_shape = {t["name"]: t for t in timings
                  if t.get("K") == 4 or t.get("shape", "").startswith(f"B={SERVE_B} S={SERVE_S}")
                  or t.get("shape", "").startswith(f"B={SERVE_B} C={SERVE_S + SERVE_NEW}")
                  or t.get("shape", "").startswith(f"B={SSM_B} S={SSM_S} ")}
    sources = {"fed_agg": ("src/repro_torch/csrc/fed_agg.cu", "src/repro/kernels/fed_agg/kernel.py:62"),
               "fed_opt": ("src/repro_torch/csrc/fed_agg.cu", "src/repro/kernels/fed_agg/kernel.py:144"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:77"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:61"),
               "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan/kernel.py:64"),
               # no TPU kernel: the reference's prefill leaves this work to XLA
               "ssm_prefill_in": ("src/repro_torch/csrc/ssm_prefill.cu",
                                  "src/repro/models/ssm.py:234"),
               "ssm_prefill_out": ("src/repro_torch/csrc/ssm_prefill.cu",
                                   "src/repro/models/ssm.py:247")}
    # each attention kernel also at the zoo's served shapes (time_attention)
    at_shapes = {name: [{"model": t["model"], "shape": t["shape"], "ms": t["kernel_ms"],
                         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
                        for t in timings if t["name"] == name and "model" in t]
                 for name in sources}
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": main_shape[name]["kernel_ms"], "plain_ms": main_shape[name]["plain_ms"],
        "bound_ms": main_shape[name]["bound_ms"], "bound_by": main_shape[name]["bound_by"],
        "library_ms": main_shape[name]["library_ms"],
        **({"at_served_shapes": at_shapes[name]} if at_shapes[name] else {}),
    } for name, (source, replaces) in sources.items()]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"the main path never launched {k['name']}")
    emit("wall", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
