"""The port's span tree (``repro_torch.core.telemetry``) and the spans its
federation round, training step and serving node record.

A span records its thread, its own id, its parent's id and a trace id; the
store's spans land under the caller's open span in the caller's Telemetry;
the trainer, the callback and the serving node record their child spans; a
disabled Telemetry records nothing and opens no thread-local state;
``chrome_trace`` puts each thread on its own track. Everything runs on the
CPU and imports no JAX.
"""
from __future__ import annotations

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import AsyncFederatedNode, FederatedCallback
from repro_torch.core import telemetry as ttel
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.store import InMemoryFolder, WeightStore
from repro_torch.core.strategies import FedAvg
from repro_torch.core.telemetry import SpanRecorder, Telemetry, child_span, chrome_trace
from repro_torch.models import build_model
from repro_torch.optim import adam
from repro_torch.serving import ServingNode
from repro_torch.training import Trainer

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# the span names the benchmark's accepted per-layer metrics read
METRIC_SPANS = {"train", "push", "pull", "aggregate", "serve.poll", "serve.swap",
                "serve.prefill", "serve.decode"}
NEW_SPANS = {"host_copy", "aggregate.stack", "aggregate.combine", "train.step", "train.input",
             "train.grad", "train.update", "serve.swap.wait", "serve.swap.stage",
             "serve.swap.write", "serve.prefill.issue", "serve.decode.issue", "state_hash"}
STORE_SPANS = {"put", "get", "encode", "decode", "state_hash"}


def _by_id(records):
    return {r.span_id: r for r in records}


def _children(records, parent):
    return [r for r in records if r.parent == parent.span_id]


# --- the span tree ------------------------------------------------------------------


def test_spans_nest_on_a_thread_and_stay_apart_across_threads():
    tel = Telemetry("n", enabled=True)
    inner_started = threading.Event()
    release = threading.Event()

    def other():
        with tel.span("other.root", trace=7):
            with tel.span("other.child"):
                inner_started.set()
                release.wait(10)

    worker = threading.Thread(target=other)
    with tel.span("root", trace=3):
        worker.start()
        assert inner_started.wait(10)
        with tel.span("child"):
            with tel.span("grandchild"):
                pass
        release.set()
        worker.join(10)
    assert not worker.is_alive()
    with tel.span("lone"):
        pass

    records = tel.recorder.drain_records()
    got = {r.name: r for r in records}
    assert set(got) == {"root", "child", "grandchild", "other.root", "other.child", "lone"}
    assert len({r.span_id for r in records}) == len(records)
    main, side = threading.get_ident(), worker.ident
    assert {got[n].thread for n in ("root", "child", "grandchild", "lone")} == {main}
    assert {got[n].thread for n in ("other.root", "other.child")} == {side}
    # parents: the innermost open span of the same thread, never the other's
    assert got["root"].parent == 0 and got["other.root"].parent == 0
    assert got["child"].parent == got["root"].span_id
    assert got["grandchild"].parent == got["child"].span_id
    assert got["other.child"].parent == got["other.root"].span_id
    # traces: named on a root, inherited below it; a root naming none takes its id
    assert {got[n].trace for n in ("root", "child", "grandchild")} == {3}
    assert {got[n].trace for n in ("other.root", "other.child")} == {7}
    assert got["lone"].trace == got["lone"].span_id
    # a child lies inside its parent
    for r in records:
        if r.parent:
            p = _by_id(records)[r.parent]
            assert p.t0 <= r.t0 and r.t0 + r.dur <= p.t0 + p.dur


def test_two_telemetries_on_one_thread_keep_their_own_parents():
    a, b = Telemetry("a", enabled=True), Telemetry("b", enabled=True)
    with a.span("a.root"):
        with b.span("b.root"):
            with a.span("a.child"):
                with child_span("store.op"):  # the innermost open span's recorder
                    pass
    ra, rb = a.recorder.drain_records(), b.recorder.drain_records()
    got = {r.name: r for r in ra}
    assert got["a.child"].parent == got["a.root"].span_id
    assert got["store.op"].parent == got["a.child"].span_id
    assert [r.name for r in rb] == ["b.root"] and rb[0].parent == 0


def test_drain_returns_triples_and_drain_records_the_full_records():
    rec = SpanRecorder()
    with rec.span("x", trace=5):
        with rec.span("y"):
            pass
    rec.record("z", 1.0, 0.5)  # a caller-timed root keeps its signature
    full = rec.drain_records()
    assert [r.name for r in full] == ["y", "x", "z"]
    assert full[0].parent == full[1].span_id and full[0].trace == 5
    assert full[2][:3] == ("z", 1.0, 0.5) and full[2].thread == threading.get_ident()
    with rec.span("w"):
        pass
    triples = rec.drain()
    assert len(triples) == 1 and len(triples[0]) == 3
    name, t0, dur = triples[0]
    assert name == "w" and dur >= 0
    assert rec.drain() == [] and rec.drain_records() == []
    assert rec.phase_stats()["x"]["count"] == 1


def test_disabled_telemetry_records_nothing_and_opens_no_thread_state():
    tel = Telemetry("off", enabled=False)
    seen = {}

    def run():
        for name in ("push", "pull", "train.step"):
            span = tel.span(name, trace=1)
            assert span is ttel._NULL_SPAN
            with span:
                with child_span("get", tel):  # a disabled attached Telemetry
                    pass
        seen["stack"] = ttel._open.stack

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(10)
    assert not worker.is_alive()
    assert seen == {"stack": None}
    assert len(tel.recorder) == 0 and tel.recorder.phase_stats() == {}
    assert child_span("get") is ttel._NULL_SPAN


def test_chrome_trace_gives_each_thread_its_own_tid():
    tel = Telemetry("node", enabled=True)

    def work(name):
        with tel.span(name, trace=2):
            with tel.span(name + ".child"):
                pass

    work("main")
    worker = threading.Thread(target=work, args=("side",))
    worker.start()
    worker.join(10)
    doc = chrome_trace({"node": [tel.snapshot()],
                        "old": [{"spans": [["legacy", 10, 5]]}]})
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["main"]["tid"] == spans["main.child"]["tid"] == 0
    assert spans["side"]["tid"] == spans["side.child"]["tid"] == 1
    assert spans["main.child"]["args"]["parent"] == spans["main"]["args"]["span"]
    assert {spans[n]["args"]["trace"] for n in ("main", "side.child")} == {2}
    assert spans["legacy"]["tid"] == 0 and "args" not in spans["legacy"]
    assert spans["legacy"]["pid"] != spans["main"]["pid"]


# --- the store's spans under the caller's ----------------------------------------------


def _round(node, value, n=3):
    return node.update_parameters({"w": torch.full((4, 4), float(value))}, num_examples=n)


def test_nodes_sharing_a_store_each_get_their_own_store_spans():
    store = WeightStore(InMemoryFolder())
    tels = {nid: Telemetry(nid, enabled=True) for nid in ("a", "b")}
    nodes = {nid: AsyncFederatedNode(strategy=FedAvg(device="cpu"), store=store, node_id=nid,
                                     telemetry=tels[nid], device="cpu", resume=False)
             for nid in tels}
    assert store._ctx.telemetry is None  # a node attaches only to a store it built
    rounds = 3
    barrier = threading.Barrier(2)

    def client(nid):
        for r in range(rounds):
            barrier.wait(10)
            _round(nodes[nid], r + (nid == "b"))

    workers = [threading.Thread(target=client, args=(nid,)) for nid in nodes]
    for w in workers:
        w.start()
    for w in workers:
        w.join(30)
    assert not any(w.is_alive() for w in workers)

    for nid, tel in tels.items():
        records = tel.recorder.drain_records()
        ids = _by_id(records)
        threads = {r.thread for r in records}  # the node's own client thread
        assert len(threads) == 1 and threads <= {w.ident for w in workers}
        pushes = [r for r in records if r.name == "push"]
        pulls = [r for r in records if r.name == "pull"]
        assert [r.trace for r in pushes] == list(range(rounds))
        assert [r.trace for r in pulls] == list(range(rounds))
        store_spans = [r for r in records if r.name in STORE_SPANS]
        assert {r.name for r in store_spans} == STORE_SPANS
        for r in store_spans:
            # under this node's push or pull (put and get may sit in encode or decode)
            root = r
            while root.parent:
                root = ids[root.parent]
            assert root.name in ("push", "pull"), (nid, r.name)
            assert r.trace == root.trace
        assert sum(r.name == "encode" for r in records) == rounds
        assert sum(r.name == "state_hash" for r in records) == rounds
        for agg in (r for r in records if r.name == "aggregate"):
            kids = sorted(c.name for c in _children(records, agg))
            assert kids == ["aggregate.combine", "aggregate.stack"]
            assert agg.trace in range(rounds)


def test_an_attached_telemetry_takes_only_store_spans_with_no_span_open():
    store = WeightStore(InMemoryFolder())
    attached = Telemetry("store", enabled=True)
    store.attach_telemetry(attached)
    tel = Telemetry("node", enabled=True)
    node = AsyncFederatedNode(strategy=FedAvg(device="cpu"), store=store, node_id="n",
                              telemetry=tel, device="cpu", resume=False)
    _round(node, 1.0)
    assert attached.recorder.drain_records() == []
    assert {"encode", "put", "state_hash"} <= {r.name for r in tel.recorder.drain_records()}
    # with no span open, the store's own work goes to the attached Telemetry
    store.push(NodeUpdate(params={"w": np.ones((2,), np.float32)}, num_examples=1,
                          node_id="peer", counter=0, timestamp=time.time()))
    store.pull(exclude="n")
    store.state_hash(exclude_node="n")
    records = attached.recorder.drain_records()
    assert {"encode", "put", "get", "decode", "state_hash"} <= {r.name for r in records}
    assert all(r.parent in (0, *(q.span_id for q in records)) for r in records)
    assert tel.recorder.drain_records() == []


# --- the trainer and the callback -------------------------------------------------------


def _trainer(tel):
    def loss(p, b, r):
        return ((torch.as_tensor(b["x"]) @ p["w"]) ** 2).mean(), {}

    return Trainer(loss_fn=loss, optimizer=adam(1e-3), init_params={"w": torch.ones(4, 3)},
                   telemetry=tel, device="cpu")


def test_trainer_records_a_step_tree_inside_an_unchanged_train_span():
    tel = Telemetry("t", enabled=True)
    trainer = _trainer(tel)
    marks = {}

    def batches():
        marks["first"] = time.perf_counter()
        for _ in range(3):
            yield {"x": np.ones((2, 4), np.float32)}
        marks["last"] = time.perf_counter()

    trainer.run_epoch(batches())
    records = tel.recorder.drain_records()
    (train,) = [r for r in records if r.name == "train"]
    steps = _children(records, train)
    assert [r.name for r in steps] == ["train.step"] * 3
    for step in steps:
        assert [c.name for c in _children(records, step)] == [
            "train.input", "train.grad", "train.update"]
    # train opens before the first batch is drawn and closes after the epoch's
    # host sync, which follows the last step; note_train takes its duration
    assert train.t0 <= marks["first"] and train.t0 + train.dur >= marks["last"]
    assert train.t0 + train.dur >= max(s.t0 + s.dur for s in steps)
    assert tel._train_steps == 3 and tel._train_seconds == pytest.approx(train.dur)
    assert len(records) == 1 + 3 * 4


def test_trainer_without_telemetry_records_nothing():
    trainer = _trainer(None)
    logs = trainer.run_epoch([{"x": np.ones((2, 4), np.float32)}] * 2)
    assert trainer.step == 2 and np.isfinite(logs["loss"])
    off = Telemetry("off", enabled=False)
    _trainer(off).run_epoch([{"x": np.ones((2, 4), np.float32)}])
    assert len(off.recorder) == 0


def test_federated_callback_records_host_copy():
    tel = Telemetry("c", enabled=True)
    node = AsyncFederatedNode(strategy=FedAvg(device="cpu"), store=WeightStore(InMemoryFolder()),
                              node_id="c", telemetry=tel, device="cpu", resume=False)
    trainer = _trainer(tel)
    fed = FederatedCallback(node, num_examples_per_epoch=2)
    trainer.fit(lambda e: [{"x": np.ones((2, 4), np.float32)}], epochs=2, callbacks=[fed])
    records = tel.recorder.drain_records()
    names = [r.name for r in records if r.parent == 0]
    assert names == ["train", "host_copy", "push", "pull"] * 2
    copies = [r for r in records if r.name == "host_copy"]
    pushes = [r for r in records if r.name == "push"]
    assert all(c.t0 + c.dur <= p.t0 for c, p in zip(copies, pushes))


# --- the serving node ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def pythia():
    cfg = get_config("pythia-14m").reduced()
    return cfg, build_model(cfg).init(0, device="cpu")


def test_serving_node_records_swap_and_issue_children(pythia):
    cfg, params = pythia
    store = WeightStore(InMemoryFolder())
    store.push(NodeUpdate(params=params, num_examples=1, node_id="trainer", counter=4,
                          timestamp=time.time()))
    tel = Telemetry("server", enabled=True, flush_every=10**9)
    node = ServingNode(store, cfg, telemetry=tel, device="cpu")
    assert store._ctx.telemetry is None  # never attached to a store it did not build
    assert not hasattr(node, "swap_log")
    assert node.poll_once()
    prompts = np.arange(2 * 5, dtype=np.int32).reshape(2, 5) % cfg.vocab_size
    new_tokens = 4
    for _ in range(2):
        _, meta = node.generate(prompts, new_tokens=new_tokens)
    assert set(meta) == {"source", "counter"}
    records = tel.recorder.drain_records()

    (poll,) = [r for r in records if r.name == "serve.poll"]
    assert {c.name for c in _children(records, poll)} == {"get", "decode"}
    (swap,) = [r for r in records if r.name == "serve.swap"]
    assert swap.trace == 4  # the deployment's counter
    assert [c.name for c in _children(records, swap)] == [
        "serve.swap.stage", "serve.swap.wait", "serve.swap.write"]
    assert all(c.trace == 4 for c in _children(records, swap))

    prefills = [r for r in records if r.name == "serve.prefill"]
    decodes = [r for r in records if r.name == "serve.decode"]
    assert [r.trace for r in prefills] == [1, 2]  # the batch number
    assert [r.trace for r in decodes] == [1] * (new_tokens - 1) + [2] * (new_tokens - 1)
    for span in prefills + decodes:
        (issue,) = _children(records, span)
        assert issue.name == span.name + ".issue" and issue.trace == span.trace
        assert span.t0 <= issue.t0 and issue.t0 + issue.dur <= span.t0 + span.dur
    assert {r.thread for r in records} == {threading.get_ident()}


# --- the names and the ranges ---------------------------------------------------------------


def _span_names_in_source() -> set[str]:
    pattern = re.compile(r"""(?:\.span|child_span)\(\s*"([\w.]+)\"""")
    names = set()
    for path in SRC.rglob("*.py"):
        names.update(pattern.findall(path.read_text()))
    return names


def test_no_new_span_name_equals_a_metric_span():
    names = _span_names_in_source()
    assert METRIC_SPANS <= names  # every metric's span is still recorded
    assert NEW_SPANS <= names
    assert not NEW_SPANS & METRIC_SPANS
    assert STORE_SPANS - {"state_hash"} <= names


def test_record_function_only_at_the_kernel_launch_sites():
    calls = []
    for path in sorted(SRC.rglob("*.py")):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "record_function(" in line:
                name = re.search(r'record_function\("([\w.]+)"\)', line).group(1)
                calls.append((path.relative_to(SRC).as_posix(), name, lines[i + 1]))
    assert sorted((f, name) for f, name, _ in calls) == [
        ("kernels/decode_attention/kernel.py", "kernel.decode_attention"),
        ("kernels/fed_agg/kernel.py", "kernel.fed_agg"),
        ("kernels/fed_agg/kernel.py", "kernel.fed_opt"),
        ("kernels/flash_attention/kernel.py", "kernel.flash_attention"),
        ("kernels/ssd_scan/kernel.py", "kernel.ssd_scan"),
        ("kernels/ssm_prefill/kernel.py", "kernel.ssm_prefill_in"),
        ("kernels/ssm_prefill/kernel.py", "kernel.ssm_prefill_out"),
    ]
    for _, name, gate in calls:
        # entered only while a profiler runs, and named apart from the symbols
        # the benchmark matches as substrings
        assert "torch.autograd._profiler_enabled()" in gate
        for symbol in ("fed_agg_kernel", "ssd_mma_kernel", "ssd_scan_kernel"):
            assert symbol not in name
