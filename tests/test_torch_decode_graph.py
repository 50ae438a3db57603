"""Which serving nodes replay their decode step from a CUDA graph, and how a
node keeps its graphs, on the CPU.

``launch.steps.decode_graphable`` admits a model only on the card, off a
mesh, with every block ``ssm``. Every other node decodes eagerly and builds
no graph: the CPU, attention, MLA, MoE and hybrid archs, a ``mesh=`` node.
The node's bookkeeping (one graph for each device buffer, leaf-set
generation and batch size, held by one batch at a time, dropped once its
leaf set is stale or past the cap) runs here with a stand-in for the graph
that steps eagerly on the same static buffers. The captured graphs run on
the card, in tests/test_torch_cuda.py. No JAX.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import _torch_children as kids
from repro_torch.configs import get_config
from repro_torch.core import Telemetry
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.store import InMemoryFolder, WeightStore
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build_model
from repro_torch.serving import ServingNode
from repro_torch.serving import node as node_mod
from repro_torch.serving.watcher import Deployment

NEW = 5
GRAPH_SPANS = {"serve.decode.replay", "serve.decode.capture"}


@pytest.mark.parametrize("arch,want", [
    ("mamba2-130m", True),
    ("pythia-14m", False),
    ("granite-3-2b", False),
    ("recurrentgemma-9b", False),
    ("minicpm3-4b", False),
    ("llama4-scout-17b-a16e", False),
])
def test_only_all_ssm_models_on_one_card_are_graphable(arch, want):
    model = build_model(get_config(arch).reduced())
    cuda = torch.device("cuda")  # a device name: no card needed
    assert steps.decode_graphable(model, cuda) is want
    assert steps.decode_graphable(model, torch.device("cpu")) is False
    assert steps.decode_graphable(model, cuda, mesh=object()) is False


@pytest.mark.parametrize("pattern,n_layers", [(("ssm", "attn"), 2), (("ssm", "rglru"), 3)])
def test_an_ssm_model_with_another_block_is_not_graphable(pattern, n_layers):
    cfg = get_config("mamba2-130m").reduced().replace(layer_pattern=pattern, n_layers=n_layers)
    assert not steps.decode_graphable(build_model(cfg), torch.device("cuda"))


def _pushed(arch: str, seed: int = 0):
    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(seed, device="cpu")
    store = WeightStore(InMemoryFolder())
    store.push(NodeUpdate(params=params, num_examples=1, node_id="t", counter=0))
    return cfg, params, store


def _prompts(cfg, B: int = 2, S: int = 9, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _counters(tel: Telemetry) -> dict:
    """The counters (a snapshot: drains the spans)."""
    return tel.snapshot()["counters"]


@pytest.mark.parametrize("arch", ["mamba2-130m", "pythia-14m", "granite-3-2b",
                                  "recurrentgemma-9b"])
def test_cpu_nodes_decode_eagerly_and_build_no_graph(arch):
    cfg, params, store = _pushed(arch)
    tel = Telemetry("server", enabled=True, flush_every=10**9)
    node = ServingNode(store, cfg, telemetry=tel, device="cpu")
    assert node.poll_once()
    assert not node._graphable
    prompts = _prompts(cfg)
    for _ in range(2):
        tokens, _ = node.generate(prompts, new_tokens=NEW)
    assert np.array_equal(tokens, serve_batch(cfg, params, prompts, new_tokens=NEW).numpy())
    assert node._graphs == {}
    names = {r.name for r in tel.recorder.drain_records()}
    assert "serve.decode.issue" in names and not names & GRAPH_SPANS
    counters = _counters(tel)
    assert counters["serve.decode.eager"] == 2 * (NEW - 1)
    assert "serve.decode.graph" not in counters and "serve.decode.capture" not in counters


def test_a_mesh_node_decodes_eagerly(tmp_path):
    tmp.start_processes(kids.mesh_decode_rank, args=(str(tmp_path),), nprocs=1,
                        start_method="spawn")  # joins; a child's error raises here
    rec = json.loads((tmp_path / "mesh_decode.json").read_text())
    assert rec["graphable"] is False and rec["graphs"] == 0
    assert "serve.decode.issue" in rec["spans"] and not set(rec["spans"]) & GRAPH_SPANS
    assert rec["counters"]["serve.decode.eager"] == 3
    assert "serve.decode.graph" not in rec["counters"]


# --- the node's graphs, with a stand-in that steps eagerly ---------------------------------


class _SteppedGraph(steps.DecodeGraph):
    """``DecodeGraph``'s static buffers and ``load``; ``replay`` runs the
    step eagerly on them and chains the token, as the graph does."""

    def __init__(self, serve_step, params, model, batch, device):
        self.device = device
        self.token = torch.zeros(batch, dtype=torch.int32, device=device)
        self.cache = model.init_cache(batch, capacity=1, device=device)
        self._step = lambda: serve_step(params, self.token, self.cache, 0)

    def replay(self) -> torch.Tensor:
        out, _ = self._step()
        self.token.copy_(out)
        return self.token


def _deployment(spec, params, counter: int) -> Deployment:
    return Deployment(source="t", counter=counter, timestamp=0.0, max_counter=counter,
                      flat=spec.flatten_into(params, spec.empty_flat()))


@pytest.fixture
def stepped(monkeypatch):
    """A CPU node of mamba2-130m ``reduced()`` that takes the graph path
    with the stand-in, weight sets drawn from seeds 0, 1, 2, ... and a
    Telemetry."""
    monkeypatch.setattr(node_mod, "DecodeGraph", _SteppedGraph)
    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg)
    tel = Telemetry("server", enabled=True, flush_every=10**9)
    node = ServingNode(WeightStore(InMemoryFolder()), cfg, telemetry=tel, device="cpu")
    node._graphable = True
    sets = [model.init(seed, device="cpu") for seed in range(4)]
    return cfg, node, tel, sets


def test_graph_path_serves_the_eager_tokens_and_captures_once(stepped):
    cfg, node, tel, sets = stepped
    node.deploy(_deployment(node.spec, sets[0], 0))
    prompts = _prompts(cfg, B=3)
    want = serve_batch(cfg, sets[0], prompts, new_tokens=NEW).numpy()
    for _ in range(2):
        tokens, _ = node.generate(prompts, new_tokens=NEW)
        assert np.array_equal(tokens, want)
    assert list(node._graphs) == [(0, 1, 3)] and not node._graphs_busy
    records = tel.recorder.drain_records()
    counters = _counters(tel)
    assert counters["serve.decode.capture"] == 1
    assert counters["serve.decode.graph"] == 2 * (NEW - 1)
    assert "serve.decode.eager" not in counters
    by_id = {r.span_id: r for r in records}
    replays = [r for r in records if r.name == "serve.decode.replay"]
    assert len(replays) == 2 * (NEW - 1)
    for r in replays:  # serve.decode > serve.decode.issue > serve.decode.replay
        issue = by_id[r.parent]
        assert issue.name == "serve.decode.issue" and by_id[issue.parent].name == "serve.decode"
    (capture,) = [r for r in records if r.name == "serve.decode.capture"]
    assert capture.trace == 1 and capture.parent == 0  # the first batch's, outside its steps


def test_a_batch_that_finds_the_graph_busy_decodes_eagerly(stepped):
    cfg, node, tel, sets = stepped
    node.deploy(_deployment(node.spec, sets[0], 0))
    prompts = _prompts(cfg, B=2)
    want = serve_batch(cfg, sets[0], prompts, new_tokens=NEW).numpy()
    inner = {}

    def second_batch():
        inner["tokens"], _ = node.generate(prompts, new_tokens=NEW)
        inner["busy"] = set(node._graphs_busy)

    def on_token(t):
        if t == 1:  # the first batch holds the graph: a second batch on another thread
            th = threading.Thread(target=second_batch)
            th.start()
            th.join(timeout=60)
            assert not th.is_alive()

    tokens, _ = node.generate(prompts, new_tokens=NEW, on_token=on_token)
    assert np.array_equal(tokens, want) and np.array_equal(inner["tokens"], want)
    assert inner["busy"] == {(0, 1, 2)}
    counters = _counters(tel)
    assert counters["serve.decode.eager"] == NEW - 1
    assert counters["serve.decode.graph"] == NEW - 1
    assert counters["serve.decode.capture"] == 1
    assert not node._graphs_busy


def test_in_place_swaps_keep_the_graph_and_fresh_leaves_recapture(stepped, monkeypatch):
    cfg, node, tel, sets = stepped
    spec, B = node.spec, 2
    prompts = _prompts(cfg, B=B)

    def served(k):
        tokens, meta = node.generate(prompts, new_tokens=NEW)
        assert meta["counter"] == k
        want = serve_batch(cfg, sets[k], prompts, new_tokens=NEW).numpy()
        assert np.array_equal(tokens, want), k

    node.deploy(_deployment(spec, sets[0], 0))  # buffer 0, generation 1
    node.deploy(_deployment(spec, sets[1], 1))  # buffer 1, generation 1
    served(1)
    node.deploy(_deployment(spec, sets[2], 2))  # buffer 0 rewritten in place
    served(2)
    assert list(node._graphs) == [(1, 1, B), (0, 1, B)]
    node.deploy(_deployment(spec, sets[3], 3))  # buffer 1 rewritten in place
    served(3)  # replays (1, 1, B) on the new leaves
    assert _counters(tel)["serve.decode.capture"] == 2

    # a batch wedged on buffer 0: the next swap into it times out and
    # allocates fresh leaves, a new generation
    monkeypatch.setattr(node_mod, "_SWAP_DRAIN_TIMEOUT_S", 0.05)
    node._buf_refs[0] += 1
    node.deploy(_deployment(spec, sets[0], 0))
    node._buf_refs[0] -= 1
    assert node._leaf_gen == [2, 1] and node._deployed.gen == 2
    served(0)
    assert _counters(tel)["serve.decode.capture"] == 3
    assert list(node._graphs) == [(1, 1, B), (0, 2, B)]  # the stale graph is gone


def test_graphs_past_the_cap_drop_the_oldest_idle_one(stepped):
    cfg, node, tel, sets = stepped
    node.deploy(_deployment(node.spec, sets[0], 0))
    sizes = range(1, node_mod._DECODE_GRAPHS + 3)
    for B in sizes:
        node.generate(_prompts(cfg, B=B), new_tokens=3)
    assert list(node._graphs) == [(0, 1, B) for B in sizes[-node_mod._DECODE_GRAPHS:]]
    assert _counters(tel)["serve.decode.capture"] == len(sizes)
