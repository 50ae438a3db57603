"""A read-only serving replica of a hybrid model (Granite 4.0-H: Mamba2 and
NoPE attention layers, each with an MLP) on one card, fed by the fleet's
store: ``api.serve(connect("memory://..."), model)`` and one closed-loop
caller that sends a batch of prompts to ``ServingNode.generate`` and waits
for it. It runs as ``drivers/serving.py`` does (set-up, window, metrics and
the check on sampled batches), with the hybrid's plain reference and counts.

The program's registry holds the published depth; the configuration file's
``sizes`` states the depth the cell serves (``CUT``), and every other size
must equal the program's. The program's configuration is resolved before any
weight is drawn, so a program without the model fails at once.

Beyond ``serving.py``'s records, a traced run keeps the window's growth of
the program's counters (``counters``: the decode caches' ring and state
bytes) and the shapes of its three kernels' calls (``ssd_shape``,
``flash_shape``, ``decode_shape``; the decode's ring holds, at the least, the
prompt and the first token).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import harness
from portbench.counts import granite_hybrid as counts
from portbench.drivers.serving import (
    PUBLISHER,
    SETUP_SETS,
    _Closed,
    _seed,
    first_swap,
    sample_batches,
    served_from,
)
from portbench.reference import granite_hybrid as ref
from portbench.reference import wire
from portbench.traffic import requests

CUT = ("n_layers",)  # sizes the benchmark serves cut from the program's published model


def program_config(cfg: dict):
    """The program's configuration of ``cfg['arch']`` at the cell's depth;
    raises where the program has no such model or one of the other sizes the
    benchmark states differs from it."""
    from repro_torch.configs import get_config

    model_cfg = get_config(cfg["arch"])
    for key, value in cfg["sizes"].items():
        if key in CUT:
            continue
        have = getattr(model_cfg, key)
        have = list(have) if isinstance(have, tuple) else have
        if have != value:
            raise RuntimeError(f"{cfg['arch']}: the program has {key}={have!r}, "
                               f"the benchmark states {value!r}")
    return model_cfg.replace(**{k: cfg["sizes"][k] for k in CUT})


def reference_config(cfg: dict) -> dict:
    """The sizes and the assumed weight draw, as the reference takes them."""
    return {**cfg["sizes"], **cfg["weight_draw"]}


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", patch=None, control: bool = False) -> dict:
    """One run of the cell (``patch(objects)`` may replace parts of the
    program; ``control`` also reads the fp8 control on the same sample)."""
    from repro_torch.api import connect, serve
    from repro_torch.core import Telemetry

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model_cfg = program_config(cfg)
    sizes = reference_config(cfg)

    # -- inputs, made from the seed ------------------------------------------------------
    weights = [ref.make_weights(sizes, (int(seed) * 1000003 + i) % 2**63, dev)
               for i in range(mix["weight_sets"])]
    narrow = {p: d for p, _, d in ref.layout(sizes) if d != "float32"}
    bodies = [wire.write_leaves({p: t.float().cpu().numpy() for p, t in w.items()})
              for w in weights]
    setup = publishes = min(SETUP_SETS, len(weights))
    if mix["publish_every_s"]:
        publishes += int(seconds // mix["publish_every_s"]) + 1
    blobs = [wire.with_meta(bodies[k % len(bodies)], node_id=PUBLISHER, counter=k,
                            num_examples=1, dtypes=narrow)
             for k in range(publishes)]
    del bodies
    rng = np.random.default_rng(_seed(seed, 3))
    batch = mix["batch"]

    # -- the system under test -------------------------------------------------------------
    store = connect("memory://portbench-serving")
    folder = store.folder
    for key in list(folder.keys()):
        folder.delete(key)
    tel = Telemetry("server", enabled=trace, flush_every=10**9, ring_capacity=1 << 16)
    folder.put(f"latest/{PUBLISHER}", blobs[0])
    node = serve(store, model_cfg, node_id="server", poll_interval=mix["poll_interval_s"],
                 telemetry=tel, wait=600.0, device=dev)
    try:
        if not node.wait_until_deployed(0):
            raise RuntimeError("the serving node deployed nothing within 600 s")
        for i in range(1, setup):  # fill both device buffers
            folder.put(f"latest/{PUBLISHER}", blobs[i])
            deadline = time.perf_counter() + 600
            while node.stats()["counter"] != i:
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"weight set {i} was never deployed")
                time.sleep(0.01)
        if patch is not None:
            patch({"node": node})
        for length in requests.prompt_lengths(mix):  # every prompt length, once
            node.generate(requests.prompt_ids(rng, batch, length, sizes["vocab_size"]),
                          new_tokens=2)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = _window(node, folder, blobs, mix, sizes, seed, seconds, trace)
    finally:
        node.stop()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    done = out.pop("batches")
    del node, store
    for key in list(folder.keys()):
        folder.delete(key)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------------------
    published = out.pop("published")
    valid = [served_from(b, published, setup) for b in done]
    fresh = [i for i, b in enumerate(done) if valid[i] and b["counter"] >= setup]
    sample = sample_batches(done, mix["check_batches"], seed, prefer=fresh)
    out["readings"] = check(sizes, weights, sample, dev, control=control)
    if not all(valid):  # a batch names a weight set that was not published
        out["readings"]["token_gap"] = None
    if mix["publish_every_s"]:
        out["readings"]["first_swap_s"] = first_swap(published, done, valid, setup,
                                                     out["close"])
    out["limits"] = mix["limits"]
    return out


def _window(node, folder, blobs, mix, sizes, seed, seconds, trace) -> dict:
    batch = mix["batch"]
    rng = np.random.default_rng(_seed(seed, 4))
    schedule = requests.schedule(mix, seed)
    stop = threading.Event()
    published: list[tuple[float, int]] = []  # (time, index) of each publish in the window

    def publish():
        k = min(SETUP_SETS, len(blobs))
        while k < len(blobs) and not stop.wait(mix["publish_every_s"]):
            folder.put(f"latest/{PUBLISHER}", blobs[k])
            published.append((time.perf_counter(), k))
            k += 1

    publisher = threading.Thread(target=publish, name="portbench-fleet", daemon=True)
    profiler = harness.Profiled() if trace else None
    batches: list[dict] = []
    node.telemetry.recorder.drain()
    counters0 = node.telemetry.counters()
    setup_s = harness.process_age_s()
    t0 = time.perf_counter()
    close = t0 + seconds
    prof_at = t0 + mix["profile_from_s"]

    def on_token(_):
        now = time.perf_counter()
        times.append(now)
        if profiler is not None:
            if profiler.t0 is None and now >= prof_at:
                profiler.start()
            elif not profiler.done and profiler.t0 is not None and now >= prof_at + mix["profile_s"]:
                profiler.stop()
        if now >= close and (profiler is None or profiler.done):
            raise _Closed

    if mix["publish_every_s"]:
        publisher.start()
    failed = 0
    try:
        while time.perf_counter() < close or (profiler is not None and not profiler.done):
            length, new = next(schedule)
            prompts = requests.prompt_ids(rng, batch, length, sizes["vocab_size"])
            times: list[float] = []
            entry = {"S": length, "T": new, "t_call": time.perf_counter(), "times": times}
            batches.append(entry)
            try:
                tokens, meta = node.generate(prompts, new_tokens=new, on_token=on_token)
            except _Closed:
                break
            except Exception:  # a failed batch counts, and ends the run
                failed += 1
                break
            entry.update(prompts=prompts, tokens=tokens, counter=meta["counter"])
    finally:
        stop.set()
        if publisher.is_alive():
            publisher.join(timeout=60)
    spans = [(n, s, d) for n, s, d in node.telemetry.recorder.drain() if s >= t0]
    counters1 = node.telemetry.counters()
    begun = [b for b in batches if b["t_call"] < close]
    token_times = [t for b in begun for t in b["times"] if t <= close]
    ttft = [(b["times"][0] - b["t_call"]) * 1e3 for b in begun if b["times"]]
    flop_events = []
    for b in begun:
        served = [t for t in b["times"] if t <= close]
        if served:
            flop_events.append((served[0], counts.prefill_flops(sizes, batch, b["S"])))
            flop_events += [(t, counts.decode_flops(sizes, batch, b["S"] + i))
                            for i, t in enumerate(served[1:], start=1)]
    metrics = {"serve_tokens_per_s": harness.rate(batch * len(token_times), seconds)}
    if ttft:
        metrics["ttft_ms_p90"] = harness.percentile(ttft, 90)
    lengths = {b["S"] for b in batches}
    S = lengths.pop() if len(lengths) == 1 else None
    m = ref.dims(sizes)
    attn = {"KV": sizes["n_kv_heads"], "G": sizes["n_heads"] // sizes["n_kv_heads"],
            "hd": sizes["head_dim"], "itemsize": 2}
    return {
        "setup_s": setup_s,
        "attempted": len(begun),
        "failed": failed,
        "metrics": metrics,
        "batches": [b for b in batches if "tokens" in b],
        "published": [(t, k) for t, k in published if t < close],
        "close": close,
        "records": {
            "window_s": seconds, "flop_events": flop_events, "spans": spans,
            "counters": {k: v - counters0.get(k, 0) for k, v in counters1.items()},
            "ssd_shape": ({"B": batch, "S": S, "H": m["H"], "P": m["P"], "N": m["N"],
                           "chunk": sizes["ssm_chunk"], "itemsize": 2} if S else None),
            "flash_shape": {"B": batch, "S": S, **attn} if S else None,
            "decode_shape": {"B": batch, "C": S + 1, **attn} if S else None,
            "trace": profiler.result() if profiler else None,
        },
    }


def check(sizes: dict, weights: list, sample: list[dict], dev, *, control: bool = False) -> dict:
    """token_gap: over every served token of the sample, the widest gap by
    which its logit lies below the reference's best, on the weight set that
    served it (publish k serves set k % len(weights); logit units, after the
    logits' scaling). With ``control`` also control_gap: the same for the
    tokens an fp8 forward puts first."""
    if not sample:
        return {"token_gap": None}
    torch.backends.cuda.matmul.allow_tf32 = False
    widest, widest_control = 0.0, 0.0
    for b in sample:
        tokens = torch.from_numpy(np.asarray(b["tokens"])).to(dev)
        if tokens.shape != (len(b["prompts"]), b["T"]) or int(tokens.min()) < 0 \
                or int(tokens.max()) >= sizes["vocab_size"] or b["counter"] < 0:
            return {"token_gap": None}
        prompts = torch.from_numpy(b["prompts"]).to(dev)
        with torch.no_grad():
            served = weights[b["counter"] % len(weights)]
            gaps = ref.served_gaps(served, sizes, prompts, tokens)
            widest = max(widest, float(gaps.max()))
            if control:
                gaps = ref.served_gaps(served, sizes, prompts, tokens, control=True)
                widest_control = max(widest_control, float(gaps.max()))
    out = {"token_gap": widest}
    if control:
        out["control_gap"] = widest_control
    return out
