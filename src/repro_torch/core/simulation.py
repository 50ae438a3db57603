"""Federated simulation harnesses (the port of ``repro.core.simulation``).

* ``run_threaded`` — real concurrency with Python threads sharing one weight
  store, mirroring the paper's own experimental setup ("we simulated
  concurrent training jobs with python multi-threading"). One crashed client
  never stops the rest; its exception lands in its ``ClientResult``.

* ``simulate_timeline`` — deterministic event-driven virtual-clock model of
  sync vs async federation: sync wall-clock = Σ_rounds max_k(t_k), async
  wall-clock per node = Σ its own epochs.

``run_multiprocess`` and ``ProcessSupervisor`` come with the federation plane
(ROADMAP Queue 1 item 13a); they will have to use the spawn start method,
because CUDA does not survive a fork.
"""
from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


# --------------------------------------------------------------------------
# Thread-based simulation (paper-faithful)
# --------------------------------------------------------------------------


@dataclass
class ClientResult:
    node_id: str
    result: Any = None
    error: BaseException | None = None
    traceback: str = ""
    exitcode: int | None = None  # set by a process runner; None for threads


def run_threaded(client_fns: Sequence[Callable[[], Any]], *, names: Sequence[str] | None = None,
                 join_timeout: float = 600.0) -> list[ClientResult]:
    """Run client closures concurrently; never lets one crash kill the rest
    (that is precisely the async-robustness story)."""
    names = list(names or [f"node{i}" for i in range(len(client_fns))])
    results = [ClientResult(node_id=n) for n in names]

    def _wrap(i: int, fn: Callable[[], Any]) -> None:
        try:
            results[i].result = fn()
        except BaseException as e:  # noqa: BLE001 - captured for the caller
            results[i].error = e
            results[i].traceback = traceback.format_exc()

    threads = [
        threading.Thread(target=_wrap, args=(i, fn), name=names[i], daemon=True)
        for i, fn in enumerate(client_fns)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_timeout)
    return results


# --------------------------------------------------------------------------
# Event-driven virtual-clock timing model
# --------------------------------------------------------------------------


@dataclass
class TimelineResult:
    mode: str
    wall_clock: float                      # time until ALL nodes finish E epochs
    per_node_finish: list[float]
    per_node_idle: list[float]             # barrier wait (sync) — async is 0
    federation_events: list[tuple[float, int, int]] = field(default_factory=list)
    # (virtual time, node, number of peer updates visible at that moment)


def simulate_timeline(
    epoch_durations: Sequence[Sequence[float]],
    *,
    mode: str = "async",
    comm_time: float = 0.0,
    failures: dict[int, int] | None = None,
) -> TimelineResult:
    """Replay a federation schedule in virtual time.

    epoch_durations[k][i] = duration of node k's epoch i.
    failures maps node → epoch index at which the node dies.
    sync: every epoch ends with a barrier across *alive* nodes... except that
    the paper's (and real Flower's) semantics are that a dead node blocks the
    round forever — we model that: if any node dies, sync wall_clock = inf for
    the remaining nodes' work.
    """
    failures = failures or {}
    num_nodes = len(epoch_durations)
    num_epochs = len(epoch_durations[0])
    if any(len(d) != num_epochs for d in epoch_durations):
        raise ValueError("all nodes need the same number of planned epochs")

    if mode == "sync":
        t = 0.0
        idle = [0.0] * num_nodes
        finish = [0.0] * num_nodes
        events: list[tuple[float, int, int]] = []
        dead: set[int] = set()
        for e in range(num_epochs):
            for k in list(failures):
                if failures[k] == e:
                    dead.add(k)
            if dead:
                # a dead client never deposits round-e weights: barrier hangs.
                return TimelineResult(
                    mode="sync",
                    wall_clock=float("inf"),
                    per_node_finish=[float("inf")] * num_nodes,
                    per_node_idle=idle,
                    federation_events=events,
                )
            ends = [t + epoch_durations[k][e] for k in range(num_nodes)]
            barrier = max(ends) + comm_time
            for k in range(num_nodes):
                idle[k] += barrier - ends[k]
                finish[k] = barrier
                events.append((barrier, k, num_nodes - 1))
            t = barrier
        return TimelineResult("sync", t, finish, idle, events)

    if mode == "async":
        # Each node runs its own timeline; at each epoch end it sees whichever
        # peers have already deposited (push at epoch end, pull immediately).
        deposit_times: list[list[float]] = []
        for k in range(num_nodes):
            t, deps = 0.0, []
            die_at = failures.get(k, num_epochs + 1)
            for e in range(num_epochs):
                if e >= die_at:
                    break
                t += epoch_durations[k][e] + comm_time
                deps.append(t)
            deposit_times.append(deps)
        events = []
        finish = []
        for k in range(num_nodes):
            deps = deposit_times[k]
            finish.append(deps[-1] if deps else 0.0)
            for t_dep in deps:
                visible = sum(
                    1
                    for j in range(num_nodes)
                    if j != k and any(dj <= t_dep for dj in deposit_times[j])
                )
                events.append((t_dep, k, visible))
        events.sort()
        alive_finish = [f for k, f in enumerate(finish) if failures.get(k, num_epochs + 1) > num_epochs]
        wall = max(alive_finish) if alive_finish else max(finish)
        return TimelineResult("async", wall, finish, [0.0] * num_nodes, events)

    raise ValueError(f"unknown mode {mode!r}")


def straggler_speedup(epoch_durations: Sequence[Sequence[float]], comm_time: float = 0.0) -> float:
    """wall_clock(sync) / wall_clock(async) for the same schedule."""
    sync = simulate_timeline(epoch_durations, mode="sync", comm_time=comm_time)
    asyn = simulate_timeline(epoch_durations, mode="async", comm_time=comm_time)
    return sync.wall_clock / asyn.wall_clock
