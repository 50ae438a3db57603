"""The elastic fleet (leases, crash adoption, chaos soaks) and the
observability CLI: the port against the reference.

Cross-package wire: the spec and every fleet blob kind, lease and claim keys,
the seeded chaos draws. Races: ``put_if_absent`` and adoption have one
winner on ``InMemoryFolder`` and ``DiskFolder``. Soaks: a thread-runner fleet
with one JAX worker and one torch worker under node, stall and worker chaos,
read back by both packages' ``assemble_report``; a torch process-runner soak
with a real SIGKILL, read by the JAX readers too. The fleet and obs CLIs run
through ``main(argv)``; the port's modules import with JAX blocked.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core.fleet as jfleet
import repro.core.serialize as jser
import repro.core.store as jstore
import repro.core.telemetry as jtel
import repro.obs as jobs
import repro_torch.core.fleet as tfleet
import repro_torch.core.serialize as tser
import repro_torch.core.store as tstore
import repro_torch.core.telemetry as ttel
import repro_torch.obs as tobs
from repro_torch.core import AsyncFederatedNode, Telemetry
from repro_torch.core.strategies import FedAvg
from repro_torch.fleet import main as fleet_main

ROOT = Path(__file__).resolve().parents[1]
FOLDERS = {"memory": lambda tmp: tstore.InMemoryFolder(),
           "disk": lambda tmp: tstore.DiskFolder(str(tmp / "control"))}


def _spec(mod, tmp_path, **kw):
    defaults = dict(store_uri=str(tmp_path), num_nodes=4, rounds=4, runner="thread",
                    param_size=32, round_sleep=0.01, settle=0.2, result_timeout=60.0)
    defaults.update(kw)
    return mod.FleetSpec(**defaults)


def _chaos(mod, **kw):
    return mod.ChaosSpec(**kw)


# --- the control plane's wire ------------------------------------------------------


def test_fleet_spec_crosses_packages(tmp_path):
    """A spec written by either package is read by the other, field for
    field, as JSON and through the store; both write the same bytes."""
    kw = dict(num_nodes=12, rounds=7, strategy="fedadam", transport="delta(chain=4)",
              runner="process", param_size=1000, lease_ttl=2.5)
    chaos = dict(seed=3, kills=2, stalls=1, kill_workers=1, kill_workers_after=(2, 4),
                 kill_grace=75.0)
    t = _spec(tfleet, tmp_path, chaos=_chaos(tfleet, **chaos), **kw)
    j = _spec(jfleet, tmp_path, chaos=_chaos(jfleet, **chaos), **kw)
    assert t.to_json() == j.to_json()
    assert jfleet.FleetSpec.from_json(t.to_json()).to_dict() == j.to_dict()
    assert tfleet.FleetSpec.from_json(j.to_json()).to_dict() == t.to_dict()
    tfolder = tstore.DiskFolder(str(tmp_path / "t"))
    jfolder = jstore.DiskFolder(str(tmp_path / "j"))
    tfleet.write_spec(tfolder, t)
    jfleet.write_spec(jfolder, j)
    assert tfolder.get(tfleet.SPEC_KEY) == jfolder.get(jfleet.SPEC_KEY)
    assert jfleet.read_spec(jstore.DiskFolder(str(tmp_path / "t"))).to_dict() == j.to_dict()
    assert tfleet.read_spec(tstore.DiskFolder(str(tmp_path / "j"))).to_dict() == t.to_dict()
    assert t.node_ids() == j.node_ids() and t.target_of(7) == j.target_of(7)


PAYLOADS = {
    "lease": {"worker": "hostA", "slot": 3, "node_id": "node0003", "epoch": 2,
              "deadline": 1.7e9 + 0.25, "time": 1.7e9},
    "heartbeat": {"node_id": "node0001", "slot": 1, "counter": 4, "pushes": 4,
                  "status": "parked", "resumed": True, "time": 1.7e9, "adopted": False,
                  "lease_epoch": 0, "obs": {"rounds": 4, "pull_ms": 1.5}},
    "result": {"node_id": "node0002", "slot": 2, "resumed": True, "start_counter": 3,
               "final_counter": 6, "pushes": 3, "aggregations": 3, "skipped_pulls": 0,
               "wall_seconds": 2.5, "first_push_unix": 1.7e9, "finished_unix": 1.7e9 + 3,
               "params_l2": 4.25, "adopted": True, "lease_epoch": 1,
               "transport_stats": {"bytes_written": 1234, "bytes_read": 99}},
    "worker": {"worker": "hostB", "slots": [0, 1], "crashes_injected": 1, "restarts": 1,
               "fleet_state_hash": "ab12", "all_results_seen": True, "wall_seconds": 9.5,
               "recoveries": {"node0000": 1.25}, "adoptions": {"node0001": 0.5},
               "time": 1.7e9},
    "claim": {"worker": "hostA", "slot": 0, "node_id": "node0000", "time": 1.7e9},
}


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_fleet_blob_kinds_cross_packages(kind):
    blob_t = tser.serialize_fleet_blob(kind, PAYLOADS[kind])
    blob_j = jser.serialize_fleet_blob(kind, PAYLOADS[kind])
    assert blob_t == blob_j
    assert jser.deserialize_fleet_blob(blob_t) == (kind, PAYLOADS[kind])
    assert tser.deserialize_fleet_blob(blob_j) == (kind, PAYLOADS[kind])


@pytest.mark.parametrize("node_id,epoch,slot", [("node0000", 0, 0), ("node0042", 17, 42),
                                                ("gpu/host-3", 999_999, 9999)])
def test_lease_and_claim_keys_match_reference(node_id, epoch, slot):
    assert tfleet.lease_key(node_id, epoch) == jfleet.lease_key(node_id, epoch)
    assert tfleet.claim_key(slot) == jfleet.claim_key(slot)
    key = tfleet.lease_key(node_id, epoch)
    assert tfleet._parse_lease_key(key) == jfleet._parse_lease_key(key) == (node_id, epoch)
    for bad in ("fleet/lease/x", "fleet/heartbeat/node0000", "fleet/lease//000001"):
        assert tfleet._parse_lease_key(bad) == jfleet._parse_lease_key(bad)


@pytest.mark.parametrize("seed", range(16))
def test_chaos_draws_match_reference(seed):
    """``chaos_schedule``, ``worker_kill_victims`` and the kill switch's
    threshold draw the same victims and trigger points in both packages, for
    4–16 nodes: a mixed fleet kills the same nodes on every host."""
    for n in range(4, 17):
        rounds = 2 + (seed + n) % 6
        chaos = dict(seed=seed, kills=n // 4, stalls=n // 5, kill_workers=1 + n % 2,
                     park_after=(1 + n % 3, 4), stall_after=(1, 2 + n % 3),
                     kill_workers_after=(1, 3))
        t = _spec(tfleet, "/unused", num_nodes=n, rounds=rounds, chaos=_chaos(tfleet, **chaos))
        j = _spec(jfleet, "/unused", num_nodes=n, rounds=rounds, chaos=_chaos(jfleet, **chaos))
        ts, js = tfleet.chaos_schedule(t), jfleet.chaos_schedule(j)
        assert {k: [dataclasses.astuple(e) for e in v] for k, v in ts.items()} == \
               {k: [dataclasses.astuple(e) for e in v] for k, v in js.items()}, (seed, n)
        control = tstore.InMemoryFolder()
        for w in range(3):  # founding leases of three workers
            tfleet.claim_leases(control, t, f"host{w}-{seed}", max_slots=-(-n // 3))
        assert tfleet.worker_kill_victims(control, t.chaos) == \
               jfleet.worker_kill_victims(control, j.chaos)
        for w in tfleet.founding_workers(control):
            a, b = (tfleet._node_rng(seed, f"worker:{w}"), jfleet._node_rng(seed, f"worker:{w}"))
            assert a.integers(1, 4, size=8).tolist() == b.integers(1, 4, size=8).tolist()


@pytest.mark.parametrize("kw", [dict(runner="fiber"), dict(rounds=1, chaos={"kills": 1}),
                                dict(num_nodes=2, chaos={"kills": 2, "stalls": 1}),
                                dict(lease_ttl=0.0), dict(chaos={"kill_workers": -1}),
                                dict(rounds=1, chaos={"kill_workers": 1}),
                                dict(strategy="fedsgd"), dict(transport="delta(chain=x)"),
                                dict(param_size=0), dict(num_nodes=0)])
def test_fleet_spec_validation_matches_reference(kw, tmp_path):
    for mod in (tfleet, jfleet):
        with pytest.raises(ValueError):
            _spec(mod, tmp_path, **kw)


@pytest.mark.parametrize("uri", ["shard4+cache+/mnt/x", "cache+/mnt/x", "/mnt/x",
                                 "shard2x2+retry+/mnt/y", "memory://", "cache+memory://a"])
def test_fleet_control_uri_matches_reference(uri):
    try:
        want = jfleet.fleet_control_uri(uri)
    except ValueError:
        with pytest.raises(ValueError):
            tfleet.fleet_control_uri(uri)
        return
    assert tfleet.fleet_control_uri(uri) == want


# --- races: one winner ------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(FOLDERS))
def test_claims_and_adoption_have_one_winner(kind, tmp_path):
    """Eight racing workers partition the slots, a worker re-claiming under
    its own id gets its slots back, and eight racing adopters of one lapsed
    lease produce exactly one owner; the winner keeps epoch 0 and its own."""
    control = FOLDERS[kind](tmp_path)
    spec = _spec(tfleet, tmp_path, num_nodes=6, rounds=2, lease_ttl=30.0)
    claimed: dict[str, list[int]] = {}
    barrier = threading.Barrier(8)

    def claim(wid):
        barrier.wait()
        claimed[wid] = tfleet.claim_slots(control, spec, wid)

    threads = [threading.Thread(target=claim, args=(f"w{i}",)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    assert sorted(s for mine in claimed.values() for s in mine) == list(range(6))
    for wid, mine in claimed.items():
        assert tfleet.claim_slots(control, spec, wid) == mine

    ghost = tfleet.lease_key("node9999", 0)
    control.put(ghost, tser.serialize_fleet_blob("lease", {
        "worker": "ghost", "slot": 0, "node_id": "node9999", "epoch": 0,
        "deadline": time.time() - 60.0, "time": time.time() - 120.0}))
    control.put(tfleet.lease_key("node9999", 1), tser.serialize_fleet_blob("lease", {
        "worker": "ghost2", "slot": 0, "node_id": "node9999", "epoch": 1,
        "deadline": time.time() - 30.0, "time": time.time() - 60.0}))
    winners: list[str] = []

    def adopt(i):
        barrier.wait()
        if tfleet.try_adopt(control, spec, f"a{i}", "node9999", 0, 2):
            winners.append(f"a{i}")

    threads = [threading.Thread(target=adopt, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert len(winners) == 1
    keys = sorted(k for k in control.keys() if k.startswith("fleet/lease/node9999/"))
    assert keys == [tfleet.lease_key("node9999", 0), tfleet.lease_key("node9999", 2)]
    epoch, payload = jfleet.read_lease_index(control)["node9999"]
    assert epoch == 2 and payload["worker"] == winners[0]


def test_leases_lapse_and_the_other_package_adopts(tmp_path):
    """Torch claims; nobody refreshes; the JAX package adopts at the next
    epoch; the torch worker cannot sneak back in at the stale epoch."""
    t = _spec(tfleet, tmp_path, num_nodes=2, lease_ttl=0.2)
    j = _spec(jfleet, tmp_path, num_nodes=2, lease_ttl=0.2)
    control = tstore.DiskFolder(str(tmp_path / "c"))
    assert tfleet.claim_leases(control, t, "mortal") == {0: 0, 1: 0}
    assert all(jfleet.lease_fresh(p) for _e, p in jfleet.read_lease_index(control).values())
    time.sleep(0.3)
    assert not any(tfleet.lease_fresh(p) for _e, p in tfleet.read_lease_index(control).values())
    assert jfleet.claim_leases(control, j, "adopter") == {0: 1, 1: 1}
    assert tfleet.claim_leases(control, t, "mortal") == {}
    assert tfleet.founding_workers(control) == jfleet.founding_workers(control) == ["mortal"]


# --- soaks -------------------------------------------------------------------------


@pytest.mark.parametrize("seed,dies", [(0, "torch-host"), (2, "jax-host")])
def test_mixed_fleet_jax_and_torch_workers(seed, dies, tmp_path):
    """The slice's end to end: a JAX ``write_spec``, one ``repro`` worker and
    one ``repro_torch`` worker (thread runner, the port on the CPU) under one
    node kill, one stall and one worker kill. The drawn worker dies, the
    other adopts its lapsed leases and resumes the nodes from blobs the other
    package wrote; both packages' reports pass with one fleet hash and agree
    on victims, restarts and the ``resumed`` map."""
    jspec = _spec(jfleet, tmp_path, num_nodes=6, rounds=6, lease_ttl=1.5,
                  chaos=_chaos(jfleet, seed=seed, kills=1, stalls=1, kill_workers=1,
                               restart_after=0.1, stall_duration=0.2))
    jcontrol = jfleet.control_folder(jspec.store_uri)
    jfleet.write_spec(jcontrol, jspec)
    reports, errors = {}, []

    def run(name, fn):
        try:
            reports[name] = fn()
        except BaseException as e:  # noqa: BLE001 - raised after the join
            errors.append(e)

    workers = [
        threading.Thread(target=run, args=("jax-host", lambda: jfleet.run_worker(
            str(tmp_path), worker_id="jax-host", max_slots=3, timeout=120.0))),
        threading.Thread(target=run, args=("torch-host", lambda: tfleet.run_worker(
            str(tmp_path), worker_id="torch-host", max_slots=3, timeout=120.0,
            device="cpu"))),
    ]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=200.0)
    assert not any(w.is_alive() for w in workers)
    assert not errors, errors
    assert reports[dies].killed and not reports[({"jax-host", "torch-host"} - {dies}).pop()].killed
    jr = jfleet.assemble_report(jcontrol)
    tr = tfleet.assemble_report(tfleet.control_folder(str(tmp_path)))
    assert jr.passed and tr.passed, jr.summary()
    assert jr.workers_lost == tr.workers_lost == [dies]
    assert len(set(jr.fleet_hashes.values())) == 1 and jr.fleet_hashes == tr.fleet_hashes
    for field in ("victims", "stalled", "crashes_injected", "restarts", "resumed", "stranded",
                  "adopted", "rounds_completed", "claims", "complete", "converged"):
        assert getattr(jr, field) == getattr(tr, field), field
    assert jr.stranded and all(jr.adopted[n] for n in jr.stranded)
    assert all(jr.resumed[v] for v in jr.victims)


@pytest.mark.parametrize("seed", [0, 3])
def test_run_fleet_local_lands_seeded_chaos_on_the_same_workers(seed, tmp_path, monkeypatch):
    """``run_fleet_local`` starts each worker once the one before holds its
    leases, so ``local<i>`` owns the slots ``[4i, 4i + 4)`` in every run and
    the seeded chaos lands the same way: the node victim (node0002 on local0
    for seed 0, node0006 on local1 for seed 3) is killed and resumes on the
    worker that survives, and the drawn worker's slots are adopted. Started
    together, the workers split the slots by a race and the victim could land
    on the dying worker, never to be killed. Here the first worker opens its
    device late, as a CUDA context does, which would lose it that race."""
    opened = tfleet.resolve_device

    def slow_first(device):
        if threading.current_thread().name == "fleet-worker-0":
            time.sleep(0.5)
        return opened(device)

    monkeypatch.setattr(tfleet, "resolve_device", slow_first)
    spec = _spec(tfleet, tmp_path, num_nodes=8, rounds=6, lease_ttl=1.5,
                 chaos=_chaos(tfleet, seed=seed, kills=1, stalls=1, kill_workers=1,
                              restart_after=0.1, stall_duration=0.2))
    report = tfleet.run_fleet_local(spec, num_workers=2, timeout=120.0, device="cpu")
    dead = tfleet.worker_kill_victims(tfleet.control_folder(spec.store_uri), spec.chaos)
    survivor = {0: "local0", 3: "local1"}[seed]
    assert report.workers_lost == dead == [({"local0", "local1"} - {survivor}).pop()]
    own = list(range(4)) if survivor == "local0" else list(range(4, 8))
    assert report.workers[survivor]["slots"] == own  # founding claims
    assert sorted(report.workers[survivor]["adoptions"]) == sorted(
        spec.node_id(s) for s in range(8) if s not in own)
    assert report.claims == {s: survivor for s in range(8)}  # newest leases
    assert report.passed, report.summary()
    assert report.crashes_injected == 1 and report.restarts == 1
    assert all(report.resumed[v] for v in report.victims)
    assert report.stranded and all(report.adopted[n] for n in report.stranded)
    assert list(report.fleet_hashes) == [survivor]


def test_process_soak_sigkill_restart_resume(tmp_path):
    """The port's workers with nodes as real OS processes (CPU): the seeded
    victim parks, is SIGKILLed on its parked heartbeat, respawns and resumes;
    the JAX ``assemble_report`` and ``repro.obs`` read the fleet as the port
    does."""
    spec = _spec(tfleet, tmp_path, num_nodes=2, rounds=4, runner="process", round_sleep=0.05,
                 settle=0.3, result_timeout=120.0,
                 chaos=_chaos(tfleet, seed=7, kills=1, restart_after=0.2, kill_grace=90.0))
    report = tfleet.run_fleet_local(spec, num_workers=1, timeout=240.0, device="cpu")
    assert report.passed, report.summary()
    assert report.crashes_injected == 1 and report.restarts == 1
    victim = report.victims[0]
    assert report.resumed[victim] is True
    assert report.results[victim]["start_counter"] > 0
    assert report.recovery_latency[victim] > 0.0
    jr = jfleet.assemble_report(jfleet.control_folder(spec.store_uri))
    assert jr.passed and jr.resumed == report.resumed and jr.fleet_hashes == report.fleet_hashes
    lines: list[str] = []
    rollups = jobs.render_dashboard(jtel.collect_obs(spec.store_uri), printer=lines.append)
    assert sorted(rollups["nodes"]) == spec.node_ids()
    assert all(v["rounds"] == spec.rounds for v in rollups["nodes"].values())


def test_node_counts_kernel_launches_and_resumed_telemetry_continues(tmp_path, monkeypatch):
    """A node with telemetry counts the kernel launches its strategy reports
    for its aggregates as ``kernel.<name>`` counters, before the round's obs
    flush. A resumed node continues its round count, obs sequence and launch
    counters from its last snapshot (a sequence restarted at 0 would rank the
    dead incarnation's snapshots above the live ones). The JAX readers pass
    over the counters."""
    def launching(strategy):
        aggregate = strategy.aggregate

        def run(own, peers):
            strategy.launches["fed_agg"] += 1  # what a combine on the card records
            return aggregate(own, peers)
        return run

    def node(nid):
        strategy = FedAvg(device="cpu")
        monkeypatch.setattr(strategy, "aggregate", launching(strategy))
        return AsyncFederatedNode(strategy=strategy, shared_folder=tstore.DiskFolder(str(tmp_path)),
                                  node_id=nid, telemetry=Telemetry(enabled=True, flush_every=1))

    a, b = node("a"), node("b")
    for r in range(3):
        for n in (a, b):
            n.update_parameters({"w": np.full(4, float(r), np.float32)}, num_examples=1)
    obs = ttel.collect_obs(str(tmp_path))
    assert obs["b"][-1]["counters"]["kernel.fed_agg"] == b.num_aggregations == 3
    assert obs["b"][-1]["rounds"] == 3 and obs["b"][-1]["seq"] == 2
    reborn = node("b")  # same id: resumes counter 3, and its telemetry with it
    reborn.update_parameters({"w": np.full(4, 9.0, np.float32)}, num_examples=1)
    last = ttel.collect_obs(str(tmp_path))["b"][-1]
    assert (last["seq"], last["rounds"], last["counters"]["kernel.fed_agg"]) == (3, 4, 4)
    jobs.render_dashboard(jtel.collect_obs(str(tmp_path)), printer=lambda s: None)
    assert jtel.telemetry_rollups(jtel.collect_obs(str(tmp_path)))["nodes"]["b"]["rounds"] == 4


def test_adopter_result_survives_split_brain_deposit_race(tmp_path):
    """Whichever runner of a doubly run node deposits last, the result
    reads adopted=True: an epoch-0 deposit never clobbers an adopter's."""
    for order, sub in (((1, 0), "a"), ((0, 1), "b")):
        spec = _spec(tfleet, tmp_path / sub, num_nodes=1, rounds=2, round_sleep=0.0)
        for epoch in order:
            tfleet._soak_client(spec.to_dict(), 0, adopted_epoch=epoch, device="cpu")
        result = tfleet._read_fleet_blob(tfleet.control_folder(spec.store_uri),
                                         f"fleet/result/{spec.node_id(0)}")
        assert result["adopted"] is True and result["lease_epoch"] == 1


def test_late_joiner_adopts_ghost_fleet(tmp_path):
    spec = _spec(tfleet, tmp_path, num_nodes=3, rounds=3, lease_ttl=0.3,
                 chaos=_chaos(tfleet, seed=1, kill_workers=1))
    control = tfleet.control_folder(spec.store_uri)
    tfleet.write_spec(control, spec)
    now = time.time()
    for slot in range(spec.num_nodes):
        nid = spec.node_id(slot)
        control.put(tfleet.lease_key(nid, 0), tser.serialize_fleet_blob("lease", {
            "worker": "ghost", "slot": slot, "node_id": nid, "epoch": 0,
            "deadline": now - 60.0, "time": now - 120.0}))
    report = tfleet.run_worker(spec=spec, control=control, worker_id="rescuer", max_slots=0,
                               timeout=60.0, device="cpu")
    assert sorted(report.adoptions) == spec.node_ids()
    fleet = tfleet.assemble_report(control, spec)
    assert fleet.passed, fleet.summary()
    assert fleet.workers_lost == ["ghost"] and fleet.stranded == spec.node_ids()
    # deleting a result flips the verdict: a node that never finished fails the soak
    control.delete(f"fleet/result/{spec.node_id(1)}")
    broken = tfleet.assemble_report(control, spec)
    assert not broken.complete and not broken.passed


# --- the CLIs ----------------------------------------------------------------------


def test_fleet_cli_init_workers_report_launch(tmp_path, capsys):
    store = str(tmp_path / "a")
    assert fleet_main(["init", "--store", store, "--nodes", "4", "--rounds", "3",
                       "--runner", "thread", "--round-sleep", "0.01", "--settle", "0.2",
                       "--chaos-kills", "1", "--seed", "2", "--param-size", "32"]) == 0
    codes = {}

    def worker(wid):
        codes[wid] = fleet_main(["worker", "--store", store, "--worker-id", wid,
                                 "--max-slots", "2", "--device", "cpu"])

    threads = [threading.Thread(target=worker, args=(w,)) for w in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert codes == {"a": 0, "b": 0}
    assert fleet_main(["report", "--store", store, "--assert-passed"]) == 0
    assert "passed: True" in capsys.readouterr().out
    assert fleet_main(["report", "--store", store, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["passed"] is True
    # the one-command local flow, and the JAX report over the port's fleet
    launch = str(tmp_path / "b")
    assert fleet_main(["launch", "--store", launch, "--nodes", "4", "--rounds", "3",
                       "--runner", "thread", "--round-sleep", "0.01", "--settle", "0.2",
                       "--param-size", "32", "--workers", "2", "--device", "cpu",
                       "--assert-passed"]) == 0
    assert jfleet.assemble_report(jfleet.control_folder(launch)).passed
    assert fleet_main(["watch", "--store", launch, "--interval", "0.1", "--timeout", "5"]) == 0


def _obs_fixture(tmp_path) -> str:
    """Two trainers and one serving node's obs blobs, written by the port."""
    store = tstore.WeightStore(tstore.DiskFolder(str(tmp_path)))
    for nid, rounds in (("fast", 6), ("slow", 1)):
        tel = Telemetry(nid, enabled=True, flush_every=1)
        for r in range(rounds):
            with tel.span("pull"):
                time.sleep(0.001)
            tel.observe_staleness(r % 3)
            tel.end_round(aggregated=True)
            store.push_obs(nid, tel.seq, tel.snapshot({"bytes_written": 1000 * (r + 1)}))
            time.sleep(0.01 if nid == "fast" else 0.05)
    serve = Telemetry("server", enabled=True)
    payload = serve.snapshot()
    payload["serve"] = {"deployed": True, "swaps": 3, "tokens_per_sec": 812.5,
                        "staleness_mean": 0.5, "staleness_max": 2.0, "swap_ms_p50": 12.25,
                        "swap_ms_p99": 40.0, "skipped_incompatible": 1}
    store.push_obs("server", 0, payload)
    return str(tmp_path)


def test_kernel_launches_sum_each_nodes_newest_counters(tmp_path):
    """``kernel_launches`` sums the ``kernel.<name>`` counters of each node's
    newest obs payload (a resumed node's counts carry forward, so older
    payloads are not added again); other counters are ignored."""
    store = tstore.WeightStore(tstore.DiskFolder(str(tmp_path)))
    for nid, per_round in (("a", 2), ("b", 3)):
        tel = Telemetry(nid, enabled=True, flush_every=1)
        for _ in range(4):
            tel.count("kernel.fed_agg", per_round)
            tel.count("node.adopted")
            tel.end_round(aggregated=True)
            store.push_obs(nid, tel.seq, tel.snapshot())
    tel = Telemetry("c", enabled=True)
    tel.count("kernel.fed_opt", 5)
    store.push_obs("c", 0, tel.snapshot())
    got = ttel.kernel_launches(ttel.collect_obs(str(tmp_path)))
    assert got == {"fed_agg": 4 * 2 + 4 * 3, "fed_opt": 5}
    assert ttel.kernel_launches({}) == {} and ttel.kernel_launches({"x": []}) == {}


def test_render_dashboard_matches_reference(tmp_path):
    store = _obs_fixture(tmp_path)
    got, want = [], []
    tobs.render_dashboard(ttel.collect_obs(store), printer=got.append)
    jobs.render_dashboard(jtel.collect_obs(store), printer=want.append)
    assert got == want
    assert any("SERVE" in line and "skipped=1" in line for line in got)
    empty = []
    assert tobs.render_dashboard({}, printer=empty.append)["nodes"] == {}
    assert "no obs/ blobs" in empty[0]


def test_obs_cli_watch_and_trace(tmp_path, capsys):
    store = _obs_fixture(tmp_path / "s")
    assert tobs.main(["watch", "--store", store, "--once"]) == 0
    assert "3 nodes reporting" in capsys.readouterr().out
    out = tmp_path / "trace.json"
    assert tobs.main(["trace", "--store", store, "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    # the reference's trace, with the port's span ids as ``args`` beside it
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans and all(set(e["args"]) == {"span", "parent", "trace"} for e in spans)
    for e in spans:
        del e["args"]
    assert doc == jtel.chrome_trace(jtel.collect_obs(store))
    assert tobs.main(["watch", "--store", str(tmp_path / "empty"), "--once"]) == 1


# --- imports ------------------------------------------------------------------------


def test_port_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.core.fleet, repro_torch.fleet, repro_torch.obs\n"
            "import repro_torch.checkpoint, repro_torch.examples.quickstart\n"
            "import repro_torch.core.simulation\n"
            "import repro_torch.examples.transport_pipelines, repro_torch.examples.serve_and_strategies\n"
            "import repro_torch.examples.straggler_speedup, repro_torch.examples.multiprocess_federation\n"
            "import repro_torch.examples.sharded_federation, repro_torch.examples.hierarchical_gossip\n"
            "import repro_torch.examples.observed_fleet, repro_torch.examples.fleet_soak\n"
            "import repro_torch.examples.elastic_fleet\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_names_neither_jax_nor_the_reference():
    source = (ROOT / "chip_smoke.py").read_text()
    assert "jax" not in source
    assert "repro." not in source
