"""A read-only serving replica on one card, fed by the fleet's store:
``api.serve(connect("memory://..."), arch)`` and one closed-loop caller that
sends a batch of prompts to ``ServingNode.generate`` and waits for it.

Set-up draws ``weight_sets`` weight sets on the card from the seed, in the
served type, and serializes the leaves of each once (float32 on the wire, as
the fleet ships bf16 leaves). Publish k is set k % ``weight_sets`` under
counter k: one blob for each publish the window can make, each the leaves
of its set with its own metadata. Set-up deploys publishes 0 and 1 in turn,
so that both of the node's device buffers exist, and runs one batch of
every prompt length the mix can send. During the window a thread writes the
next publish into the store every ``publish_every_s`` (none when null), and
the node's watcher swaps it in under the traffic.

Every token is timed by ``generate``'s ``on_token``. The first token at or
past the window's end ends the run: the batch in flight is dropped.
``serve_tokens_per_s`` counts every token up to the end, ``token_gap_ms_p99``
every gap between consecutive tokens of a batch, ``ttft_ms_p90`` every batch
begun in the window, from the call to its first token. The check runs the
plain reference over a seed-drawn sample of the finished batches, the
longest among them and, where the fleet published in the window, one served
from a set published there, on the weight set each batch reports it was
served by. It also times every publish and every batch's call, and reads
``first_swap_s``: from the window's first publish to the call of the first
batch served from a set published in the window. A replica that swaps late
or never reads it high, though every batch it serves is right for the set
it names. (The worst such wait over all of the window's publishes also
spans the in-flight batch of each swap behind a swap; on an H100 it
reached 31 s on sound runs against 46 s with the watcher blocked: too
close to part them.)
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import harness
from portbench.counts import mamba2 as counts
from portbench.reference import mamba2 as ref
from portbench.reference import wire
from portbench.traffic import requests

PUBLISHER = "fleet"
SETUP_SETS = 2  # deployed in set-up: one for each of the node's device buffers


class _Closed(Exception):
    """Raised from ``on_token`` at the first token past the window's end."""


def _seed(seed: int, *k: int) -> list[int]:
    return [int(seed) % 2**64, *k]


def program_config(cfg: dict):
    """The program's configuration of ``cfg['arch']``; raises where one of the
    sizes the benchmark states differs from it."""
    from repro_torch.configs import get_config

    model_cfg = get_config(cfg["arch"])
    for key, value in cfg["sizes"].items():
        have = getattr(model_cfg, key)
        have = list(have) if isinstance(have, tuple) else have
        if have != value:
            raise RuntimeError(f"{cfg['arch']}: the program has {key}={have!r}, "
                               f"the benchmark states {value!r}")
    return model_cfg


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", patch=None, control: bool = False) -> dict:
    """One run of the cell (``patch(objects)`` may replace parts of the
    program; ``control`` also reads the fp8 control on the same sample)."""
    from repro_torch.api import connect, serve
    from repro_torch.core import Telemetry

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sizes = cfg["sizes"]
    model_cfg = program_config(cfg)

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
    begun = [b for b in batches if b["t_call"] < close]
    token_times = [t for b in begun for t in b["times"] if t <= close]
    gaps = [(b2 - b1) * 1e3 for b in begun for b1, b2 in zip(b["times"], b["times"][1:])
            if b2 <= close]
    ttft = [(b["times"][0] - b["t_call"]) * 1e3 for b in begun if b["times"]]
    flop_events = []
    for b in begun:
        served = [t for t in b["times"] if t <= close]
        if served:
            flop_events.append((served[0], counts.prefill_flops(sizes, batch, b["S"])))
            flop_events += [(t, counts.decode_flops(sizes, batch)) for t in served[1:]]
    metrics = {"serve_tokens_per_s": harness.rate(batch * len(token_times), seconds)}
    if gaps:
        metrics["token_gap_ms_p99"] = harness.percentile(gaps, 99)
    if ttft:
        metrics["ttft_ms_p90"] = harness.percentile(ttft, 90)
    lengths = {b["S"] for b in batches}
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
            "ssd_shape": ({"B": batch, "S": lengths.pop(), "H": ref.dims(sizes)["H"],
                           "P": sizes["ssm_head_dim"], "N": sizes["ssm_state"],
                           "chunk": sizes["ssm_chunk"], "itemsize": 2}
                          if len(lengths) == 1 else None),
            "trace": profiler.result() if profiler else None,
        },
    }


def served_from(batch: dict, published: list[tuple[float, int]], setup: int) -> bool:
    """Whether a finished batch names a publish that was in the store by its
    call: one of the ``setup`` that set-up deployed, or one the window made
    before it."""
    c = batch["counter"]
    return 0 <= c < setup or any(k == c and t <= batch["t_call"] for t, k in published)


def first_swap(published: list[tuple[float, int]], done: list[dict], valid: list[bool],
               setup: int, close: float) -> float | None:
    """Seconds from the window's first publish to the call of the first
    finished batch served from a set published in the window (to the
    window's close where none came). None where a batch names a publish that
    was not in the store by its call; 0 where the window saw no publish."""
    if not all(valid):
        return None
    if not published:
        return 0.0
    calls = [b["t_call"] for b in done if b["counter"] >= setup]
    return min(min(calls, default=close), close) - published[0][0]


def sample_batches(done: list[dict], n: int, seed: int, prefer=()) -> list[dict]:
    """The finished batch with the most served tokens, and ``n - 1`` others
    drawn from the seed: from the batches ``prefer`` names (those served
    from a set published in the window) where any is left, else from all."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (done[i]["T"], done[i]["S"]))
    rest = [i for i in prefer if i != longest] or [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(_seed(seed, 5))
    picks = rng.choice(rest, size=min(n - 1, len(rest)), replace=False) if rest else []
    return [done[i] for i in [longest, *sorted(int(i) for i in picks)]]


def check(sizes: dict, weights: list, sample: list[dict], dev, *, control: bool = False) -> dict:
    """token_gap: over every served token of the sample, the widest gap by
    which its logit lies below the reference's best, on the weight set that
    served it (publish k serves set k % len(weights); logit units). With ``control`` also control_gap: the same for
    the tokens an fp8 forward puts first."""
    if not sample:
        return {"token_gap": None}
    torch.backends.cuda.matmul.allow_tf32 = False
    widest, widest_control = 0.0, 0.0
    for b in sample:
        tokens = torch.from_numpy(np.asarray(b["tokens"])).to(dev)
        if tokens.shape != (len(b["prompts"]), b["T"]) or int(tokens.min()) < 0 \
                or int(tokens.max()) >= sizes["vocab_size"] \
                or b["counter"] < 0:
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
