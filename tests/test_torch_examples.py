"""The nine example twins of ``repro_torch.examples`` against the reference
scripts in ``examples/``, on the CPU (``--device cpu``), at small sizes.

The reference's guarded scripts are loaded by path; the two that run at top
level (``serve_and_strategies``, ``straggler_speedup``) are not loaded, and
their library calls are made here directly. Held: the transport pipelines'
wire counters exactly, the served tokens exactly (the reference's mamba2
weights carried across by ``load_jax_params``), the three strategies' values
within 1e-6, the virtual-clock numbers exactly, the gossip tree and exact
coverage, and the reference's readers (``collect_obs``, ``assemble_report``)
accepting the twins' ``obs/`` and ``fleet/`` blobs. Every process or soak
run has its own join timeout.
"""
import importlib
import importlib.util
import os
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fleet as jfleet
import repro.core.telemetry as jtel
from repro.api import connect as jconnect
from repro.configs import get_config as jget_config
from repro.core import AsyncFederatedNode as JAsyncNode
from repro.core import GossipHierarchy as JGossipHierarchy
from repro.core import simulate_timeline as jsimulate_timeline
from repro.core import straggler_speedup as jstraggler_speedup
from repro.core import InMemoryFolder as JInMemoryFolder
from repro.core import NodeUpdate as JNodeUpdate
from repro.core import WeightStore as JWeightStore
from repro.core.strategies import FedAsync as JFedAsync
from repro.core.strategies import FedAvg as JFedAvg
from repro.core.strategies import FedAvgM as JFedAvgM
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import GossipHierarchy
from repro_torch.examples import (
    elastic_fleet,
    fleet_soak,
    hierarchical_gossip,
    multiprocess_federation,
    observed_fleet,
    serve_and_strategies,
    sharded_federation,
    straggler_speedup,
    transport_pipelines,
)
from repro_torch.models import build_model, load_jax_params

ROOT = Path(__file__).resolve().parents[1]
TWINS = ["transport_pipelines", "serve_and_strategies", "straggler_speedup",
         "multiprocess_federation", "sharded_federation", "hierarchical_gossip",
         "observed_fleet", "fleet_soak", "elastic_fleet"]
PROC_TIMEOUT = 120.0  # join timeout of every process run below (seconds)
SOAK_TIMEOUT = 90.0   # each fleet worker's bound


def _reference(name: str):
    """A guarded script of ``examples/`` loaded by path (its ``main`` does
    not run)."""
    spec = importlib.util.spec_from_file_location(f"_reference_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- completeness ------------------------------------------------------------------


def test_every_reference_example_has_a_twin_that_imports_quietly():
    """Every ``examples/*.py`` has a module of the same name in
    ``repro_torch.examples``; importing each one prints nothing and starts
    no thread."""
    names = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    twins = sorted(p.stem for p in (ROOT / "src" / "repro_torch" / "examples").glob("*.py")
                   if p.stem != "__init__")
    assert names == twins and len(names) == 12, (names, twins)
    code = ("import contextlib, importlib, io, threading\n"
            f"names = {names!r}\n"
            "before = threading.active_count()\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    for n in names:\n"
            "        importlib.import_module('repro_torch.examples.' + n)\n"
            "assert out.getvalue() == '', out.getvalue()\n"
            "assert threading.active_count() == before, threading.enumerate()\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert res.returncode == 0 and res.stdout == "ok\n", res.stderr


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card_and_raises_without_one(name, monkeypatch):
    """``main([])`` asks for ``cuda``: with no card it raises before any
    work, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main([])


# --- (1) transport_pipelines ---------------------------------------------------------


@pytest.mark.parametrize("envelope", ["zstd", "npz"])
def test_transport_pipelines_wire_counts_equal_the_reference(envelope, monkeypatch, capsys):
    """Each pipeline's bytes written and read, rebases, re-anchors and
    chain depth equal the reference's exactly, under the same envelope, over
    the reference's own schedule; so do the prefetch line and the recovery
    line; the restored momentum is bit-equal to the one persisted."""
    ref = _reference("transport_pipelines")
    if envelope == "npz":
        monkeypatch.setattr(transport_pipelines, "_zstd_module", lambda: None)
    got = transport_pipelines.compare_pipelines()
    assert got["envelope"] == envelope
    for row in got["pipelines"]:
        folder = JInMemoryFolder()
        writer, reader = JWeightStore(folder, transport=row["spec"]), JWeightStore(folder)
        for ctr, params in enumerate(ref.sparse_steps()):
            writer.push(JNodeUpdate(params, num_examples=1, node_id="n", counter=ctr))
            reader.pull_node("n")
        s = writer.transport_stats()
        want = {"pipeline": writer.transport, "bytes_written": s["bytes_written"],
                "bytes_read": reader.bytes_read, "rebases": s["rebases"],
                "reanchors": s["reanchors"], "max_chain_depth": s["max_chain_depth"]}
        assert {k: row[k] for k in want} == want, row["spec"]
    capsys.readouterr()
    ref.prefetch_demo()
    ref.recovery_demo()
    want_lines = capsys.readouterr().out
    pre = transport_pipelines.prefetch_demo()
    rec = transport_pipelines.recovery_demo(device="cpu")
    assert capsys.readouterr().out == want_lines
    assert pre["fresh_decodes"] == 0 and pre["decode_hits"] == pre["prefetched"] == 5
    assert rec["bit_equal"] and rec["restored"] == rec["momentum"] > 0


# --- (2) serve_and_strategies --------------------------------------------------------


def test_serve_demo_tokens_equal_the_reference_serve_batch():
    """The reference's reduced mamba2 weights carried across: the twin's
    served tokens (the bulk prefill through the ``ssd`` op, S 12 < chunk 32)
    equal ``repro.launch.serve.serve_batch``'s on the same prompts."""
    jcfg, cfg = jget_config("mamba2-130m").reduced(), get_config("mamba2-130m").reduced()
    params = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    tparams = load_jax_params(build_model(cfg), params, device="cpu")
    rec = serve_and_strategies.serve_demo(device="cpu", params=tparams)
    assert rec["prompts"].shape == (4, 12) and rec["tokens"].shape == (4, 12)
    want = np.asarray(jserve_batch(jcfg, params, jnp.asarray(rec["prompts"]), new_tokens=12))
    np.testing.assert_array_equal(rec["tokens"].numpy(), want)
    assert rec["sample"] == want[0].tolist()


def _reference_strategies(uri: str, rounds: int = 3) -> list[dict]:
    """``examples/serve_and_strategies.py``'s strategy loop, on ``uri``."""
    nodes = {
        "avg": JAsyncNode(strategy=JFedAvg(), store=jconnect(uri), node_id="avg"),
        "asy": JAsyncNode(strategy=JFedAsync(alpha=0.5), store=jconnect(uri), node_id="asy"),
        "mom": JAsyncNode(strategy=JFedAvgM(momentum=0.5), store=jconnect(uri), node_id="mom"),
    }
    vals, history = {"avg": 0.0, "asy": 3.0, "mom": 6.0}, []
    for _ in range(rounds):
        for name, node in nodes.items():
            new = node.update_parameters({"w": np.full((4,), vals[name], np.float32)}, 100)
            if new is not None:
                vals[name] = float(new["w"][0])
        history.append(dict(vals))
    return history


def test_strategies_demo_values_equal_the_reference_loop():
    """FedAvg, FedAsync and FedAvgM on one store: every round's values equal
    the reference loop's within 1e-6."""
    tag = uuid.uuid4().hex[:8]
    got = serve_and_strategies.strategies_demo(device="cpu", uri=f"memory://twin-{tag}")
    want = _reference_strategies(f"memory://reference-{tag}")
    assert len(got["rounds"]) == len(want) == 3
    for g, w in zip(got["rounds"], want):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6, (k, g, w)


def test_serve_and_strategies_main_exits_0(capsys):
    rec = {}
    assert serve_and_strategies.main(["--device", "cpu"], record=rec) == 0
    out = capsys.readouterr().out
    assert "served batch of 4, 12 new tokens each" in out and "zero servers" in out
    assert rec["serve"]["config"] == "mamba2-130m-reduced" and len(rec["strategies"]["rounds"]) == 3


# --- (3) straggler_speedup -----------------------------------------------------------


def test_virtual_clock_equals_the_reference():
    """The speedups (same seeded jitter) and both crash timelines' walls
    equal ``repro.core.straggler_speedup``/``simulate_timeline``'s exactly."""
    got = straggler_speedup.virtual_clock()
    rng = np.random.default_rng(0)
    for ratio in straggler_speedup.RATIOS:
        durations = [[1.0 + 0.2 * rng.random() for _ in range(12)],
                     [ratio * (1.0 + 0.2 * rng.random()) for _ in range(12)]]
        assert got["speedups"][ratio] == jstraggler_speedup(durations), ratio
    assert got["crash_sync_wall"] == jsimulate_timeline(
        [[1.0] * 6] * 3, mode="sync", failures={2: 3}).wall_clock
    assert got["crash_async_wall"] == jsimulate_timeline(
        [[1.0] * 6] * 3, mode="async", failures={2: 3}).wall_clock


def test_straggler_threads_return_both_walls():
    """2 epochs x 3 steps: both modes finish, every sync client aggregated at
    each barrier, the async fleet aggregated, and both walls are returned."""
    got = straggler_speedup.thread_demo(device="cpu", epochs=2, steps=3, num_train=400,
                                        num_test=100)
    assert got["sync"]["wall_s"] > 0 and got["async"]["wall_s"] > 0
    assert got["ratio"] == got["sync"]["wall_s"] / got["async"]["wall_s"]
    assert got["sync"]["aggregations"] == [2, 2]
    assert sum(got["async"]["aggregations"]) >= 1


# --- (4)-(5) multiprocess_federation, sharded_federation ---------------------------------


@pytest.mark.parametrize("crash", [False, True])
def test_multiprocess_federation_survivors_finish(crash, tmp_path):
    """Three spawned clients on a ``cache+`` disk folder, 40 epochs (4 s of
    rounds, past the children's start-up spread); with ``--crash`` the last
    is SIGKILLed at 8 s, parked or still starting. Survivors finish, every
    one aggregated, and each final lies within the targets' span."""
    argv = ["--epochs", "40", "--store", str(tmp_path), "--device", "cpu"]
    got = {}
    assert multiprocess_federation.main(argv + ["--crash"] * crash, join_timeout=PROC_TIMEOUT,
                                        record=got) == 0
    assert got["finished"] == (2 if crash else 3)
    lo, hi = min(got["targets"]), max(got["targets"])
    for c in got["clients"]:
        if crash and c["node"] == "client2":
            assert c["sigkilled"] and c["exitcode"] == -9
            continue
        assert c["aggregations"] >= 1 and c["pushes"] == 40, c
        assert lo <= c["final"] <= hi, c


def _saw_every_other_group(peers, own: int, groups: int) -> bool:
    return {f"group:{g}" for g in range(groups) if g != own} <= set(peers)


def test_sharded_federation_threads_and_scan_cost():
    """12 threads in 3 groups (30 epochs) and the scan-cost demo at fleets of
    20 and 40: every node aggregated, its final within the targets' span,
    and it pulled the summary of every other group."""
    rec = {}
    argv = ["--epochs", "30", "--device", "cpu"]
    assert sharded_federation.main(argv, fleets=(20, 40), record=rec) == 0
    nodes = rec["threads"]["nodes"]
    assert len(nodes) == 12
    for nid, n in nodes.items():
        assert n["aggregations"] >= 1 and 0.0 <= n["final"] <= 11.0, (nid, n)
        assert _saw_every_other_group(n["gossip_peers"], n["group"], 3), (nid, n)
    assert [r["fleet"] for r in rec["scan_cost"]["fleets"]] == [20, 40]


def test_sharded_federation_processes():
    """Four spawned clients in two groups, 200 epochs (10 s of rounds, so
    every client's run overlaps the other group's start-up): each finished,
    aggregated, stayed within the targets' span and pulled the other
    group's summary."""
    rec = {}
    argv = ["--processes", "--nodes", "4", "--groups", "2", "--epochs", "200", "--device", "cpu"]
    assert sharded_federation.main(argv, join_timeout=PROC_TIMEOUT, record=rec) == 0
    for nid, n in rec["processes"]["nodes"].items():
        assert "error" not in n, (nid, n)
        assert n["aggregations"] >= 1 and 0.0 <= n["final"] <= 3.0, (nid, n)
        assert _saw_every_other_group(n["peers"], n["group"], 2), (nid, n)


# --- (6) hierarchical_gossip -------------------------------------------------------


def test_hierarchical_gossip_tree_and_exact_coverage(capsys):
    """The derived tree (holders, scope, printed the same) equals the
    reference's ``GossipHierarchy``; the twin's fleet covers the foreign
    fleet exactly once in one pull."""
    ref = _reference("hierarchical_gossip")
    for groups, levels in [(9, 2), (16, 2), (27, 3)]:
        capsys.readouterr()
        ref.print_tree(JGossipHierarchy(groups, levels))
        want = capsys.readouterr().out
        tree = hierarchical_gossip.print_tree(GossipHierarchy(groups, levels))
        assert capsys.readouterr().out == want
        jh = JGossipHierarchy(groups, levels)
        for level in range(1, levels):
            assert tree["holders"][level] == {o: jh.holder(level, o)
                                              for o in range(jh.counts[level])}
        assert tree["scope"] == {lvl: sorted(o) for lvl, o in jh.scope(0).items()}
    rec = {}
    assert hierarchical_gossip.main(["--device", "cpu"], record=rec) == 0
    cov = rec["coverage"]
    assert cov["examples"] == cov["expected"] == 170
    assert cov["home"] + cov["level0"] + cov["supers"] >= 3 and rec["super_folds"] > 0


# --- (7) observed_fleet ------------------------------------------------------------


def test_observed_fleet_obs_blobs_read_by_the_reference(tmp_path, capsys):
    rec = {}
    store = str(tmp_path / "obs")
    assert observed_fleet.main(["--store", store, "--size", "5000", "--device", "cpu"],
                               record=rec) == 0
    assert "4 nodes reporting" in capsys.readouterr().out
    want = jtel.telemetry_rollups(jtel.collect_obs(store))["fleet"]
    for key in ("nodes_reporting", "rounds_total", "bytes_written"):
        assert rec["fleet"][key] == want[key], key
    assert want["nodes_reporting"] == 4 and want["rounds_total"] == 24
    assert rec["counters"] == {f"n{i}": 6 for i in range(4)}


# --- (8)-(9) fleet_soak, elastic_fleet -----------------------------------------------


def _reference_report(store: str):
    control = jfleet.control_folder(store)
    return jfleet.assemble_report(control, jfleet.read_spec(control))


def test_fleet_soak_passes_and_the_reference_report_agrees(tmp_path):
    """The CLI at its defaults (8 nodes x 8 rounds, 2 kills, 1 stall, thread
    runner) exits 0, and the reference's report on its store passes."""
    store = str(tmp_path / "soak")
    rec = {}
    assert fleet_soak.main(["--store", store, "--device", "cpu"], timeout=SOAK_TIMEOUT,
                           record=rec) == 0
    report = _reference_report(store)
    assert report.passed and report.crashes_injected == 2 and report.restarts == 2
    assert rec["report"]["fleet_hashes"] == report.fleet_hashes


def test_elastic_fleet_passes_and_the_reference_report_agrees(tmp_path):
    """Two founders (one killed whole) and a late rescuer at the reference's
    lease_ttl of 1 s: exit 0, and the reference's report on the store passes
    with every stranded node adopted."""
    store = str(tmp_path / "elastic")
    rec = {}
    assert elastic_fleet.main(["--store", store, "--device", "cpu"], timeout=SOAK_TIMEOUT,
                              record=rec) == 0
    report = _reference_report(store)
    assert report.passed and report.workers_lost and report.stranded
    assert all(report.adopted.get(n) for n in report.stranded)
    assert set(rec["adoption_latency_s"]) == set(report.adoption_latency)
