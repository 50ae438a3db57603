"""Federated simulation harnesses (the port of ``repro.core.simulation``).

* ``run_threaded`` — real concurrency with Python threads sharing one weight
  store, mirroring the paper's own experimental setup ("we simulated
  concurrent training jobs with python multi-threading"). One crashed client
  never stops the rest; its exception lands in its ``ClientResult``.

* ``run_multiprocess`` — the same contract across real OS processes sharing a
  ``DiskFolder`` (or any mountable backend): no shared Python objects, no
  GIL, crash injection is a real SIGKILL mid-round, and survivors must make
  progress on the strength of the shared folder alone. Clients start under
  the ``spawn`` method: CUDA does not survive a fork, so each child opens its
  own context on the card.

* ``simulate_timeline`` — deterministic event-driven virtual-clock model of
  sync vs async federation: sync wall-clock = Σ_rounds max_k(t_k), async
  wall-clock per node = Σ its own epochs.
"""
from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time
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
# Process-based federation runtime
# --------------------------------------------------------------------------


class ProcessCrashed(RuntimeError):
    """A client process exited without reporting a result (crash / SIGKILL)."""


def _mp_entry(target: Callable[..., Any], args: tuple, kwargs: dict, conn) -> None:
    """Child entrypoint: run the client and ship (ok, result, tb) back over the
    child's private pipe (one channel per process — a SIGKILL mid-send can only
    corrupt the victim's own channel, never a survivor's).

    Each child runs torch's CPU ops on one thread: several clients share the
    host's cores, and torch's default of one thread per core in every child
    oversubscribes them."""
    try:
        import torch

        torch.set_num_threads(1)
        result = target(*args, **kwargs)
        conn.send((True, result, ""))
    except BaseException:  # noqa: BLE001 - reported to the parent, never raised
        conn.send((False, None, traceback.format_exc()))
    finally:
        conn.close()


class _Supervised:
    """One client slot under a ProcessSupervisor: the (re)spawnable target
    spec, the live process + pipe of the current incarnation, its result, and
    any armed kill timers."""

    __slots__ = ("name", "target", "args", "kwargs", "proc", "conn", "result",
                 "settled", "received", "timers", "history")

    def __init__(self, name: str, target: Callable[..., Any], args: tuple, kwargs: dict):
        self.name = name
        self.target = target
        self.args = args
        self.kwargs = kwargs
        self.proc = None
        self.conn = None
        self.result = ClientResult(node_id=name)
        self.settled = False
        self.received = False
        self.timers: list[threading.Timer] = []
        self.history: list[ClientResult] = []  # earlier incarnations' results

    def cancel_timers(self) -> None:
        """A settled client's scheduled kills must die with it: an unfired
        Timer is a live thread, and a long-running supervisor (the fleet
        worker) would otherwise accumulate one per finished client until its
        own shutdown."""
        for t in self.timers:
            t.cancel()
        for t in self.timers:
            t.join(timeout=1.0)
        self.timers.clear()


def _start_context(start_method: str):
    """The multiprocessing context for ``start_method``. A fork after CUDA is
    initialised gives a child whose first CUDA call fails or hangs, so that
    combination raises here instead."""
    if start_method == "fork":
        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "start_method='fork' in a process that has initialised CUDA: the "
                "children cannot use the card; use 'spawn'")
    return multiprocessing.get_context(start_method)


class ProcessSupervisor:
    """Owns a set of client OS processes: spawn, poll, kill, restart, reap.

    The process-supervision core of ``run_multiprocess`` (which remains the
    one-shot convenience wrapper), exposed as an incremental object so
    long-lived harnesses — the fleet chaos worker — can SIGKILL a client
    mid-round and respawn it under the same name without tearing the whole
    cohort down. Clients run under the ``spawn`` start method (clean
    interpreters, each opening its own CUDA context) and are daemonic: a dying
    supervisor never strands children.

    Lifecycle of one client: ``spawn(name, target, args)`` → the child runs
    and ships ``(ok, result, tb)`` over a private pipe → ``poll()`` absorbs
    the message (or notices a silent death) and marks the client *settled* →
    ``result(name)`` carries the outcome. ``spawn`` on a settled name is a
    restart: the previous incarnation's result moves to ``history(name)``.
    Kill timers armed via ``schedule_kill`` are cancelled the moment their
    client settles (no leaked timer threads) and on ``shutdown()``.
    """

    def __init__(self, *, start_method: str = "spawn"):
        self._ctx = _start_context(start_method)
        self._clients: dict[str, _Supervised] = {}

    # -- lifecycle ------------------------------------------------------------
    def spawn(self, name: str, target: Callable[..., Any], args: tuple = (),
              kwargs: dict | None = None) -> None:
        """Launch ``target(*args, **kwargs)`` as a supervised process. A name
        already present must be settled (then this is a restart); anything
        else is two live processes under one identity — a caller bug."""
        c = self._clients.get(name)
        if c is not None:
            if not c.settled:
                raise ValueError(f"client {name!r} is still running")
            self._reap(c, timeout=5.0)
            c.cancel_timers()
            c.history.append(c.result)
            c.target, c.args, c.kwargs = target, args, dict(kwargs or {})
            c.result = ClientResult(node_id=name)
            c.settled = c.received = False
        else:
            c = _Supervised(name, target, args, dict(kwargs or {}))
            self._clients[name] = c
        parent_conn, child_conn = self._ctx.Pipe(duplex=False)
        c.proc = self._ctx.Process(
            target=_mp_entry, args=(c.target, c.args, c.kwargs, child_conn),
            name=name, daemon=True)
        c.conn = parent_conn
        c.proc.start()
        child_conn.close()  # parent's copy; lets recv see EOF when a child dies

    def respawn(self, name: str) -> None:
        """Restart a settled client with its previous target spec (the chaos
        engine's restart-with-resume step)."""
        c = self._client(name)
        self.spawn(name, c.target, c.args, c.kwargs)

    def kill(self, name: str) -> None:
        """SIGKILL the client's current process: no cleanup, no goodbye
        deposit — the crash the serverless robustness claim must survive."""
        c = self._client(name)
        if c.proc is not None:
            _sigkill(c.proc)

    def schedule_kill(self, name: str, delay: float) -> None:
        """Arm a SIGKILL ``delay`` seconds from now. The timer targets the
        process object alive *now* — a client that settles (or restarts)
        first has the timer cancelled, never a stale kill on a reused pid."""
        c = self._client(name)
        timer = threading.Timer(delay, _sigkill, args=(c.proc,))
        timer.daemon = True
        timer.start()
        c.timers.append(timer)

    def cancel_scheduled_kills(self, name: str) -> None:
        """Disarm every pending ``schedule_kill`` timer for ``name`` without
        touching the process. The chaos engine's clean-finish path: a kill
        victim that deposited its result between the parked heartbeat and the
        backstop must not eat a spurious SIGKILL (or be counted as a crash)."""
        self._client(name).cancel_timers()

    # -- observation ----------------------------------------------------------
    def poll(self) -> list[str]:
        """Absorb whatever the clients have reported; returns the names that
        settled during this call. Non-blocking (modulo a 50 ms drain grant to
        freshly-dead channels)."""
        newly = []
        for c in self._clients.values():
            if not c.settled and self._try_settle(c):
                newly.append(c.name)
        return newly

    def unsettled(self) -> list[str]:
        return [c.name for c in self._clients.values() if not c.settled]

    def names(self) -> list[str]:
        return list(self._clients)

    def result(self, name: str) -> ClientResult:
        """The current (latest-incarnation) result of ``name``."""
        return self._client(name).result

    def history(self, name: str) -> list[ClientResult]:
        """Results of earlier incarnations (oldest first), excluding the
        current one."""
        return list(self._client(name).history)

    def incarnation(self, name: str) -> int:
        """0 for the first launch, +1 per restart."""
        return len(self._client(name).history)

    # -- collective waits -----------------------------------------------------
    def join(self, timeout: float) -> None:
        """Wait (bounded) for every client to settle; clients still alive at
        the deadline are reaped (SIGKILL) and report ``ProcessCrashed``."""
        deadline = time.monotonic() + timeout
        while self.unsettled() and time.monotonic() < deadline:
            if not self.poll():
                time.sleep(0.05)
        # Final sweep: a result delivered right at the deadline is already
        # sitting in our end of the pipe — recover it, don't report a crash.
        for c in self._clients.values():
            if not c.settled:
                self._try_settle(c)
        for c in self._clients.values():
            if not c.settled:  # hung past the deadline: reap it
                self._reap(c, timeout=0.0)
                self._settle(c)
            else:
                self._reap(c, timeout=max(0.0, deadline - time.monotonic()) + 1.0)
            c.cancel_timers()

    def shutdown(self) -> None:
        """Cancel every armed timer, reap every process. Idempotent; safe
        after an exception mid-flight (run_multiprocess calls it in a
        ``finally``)."""
        for c in self._clients.values():
            c.cancel_timers()
            self._reap(c, timeout=0.0)
            if not c.settled:
                self._try_settle(c)
            if not c.settled:
                self._settle(c)

    # -- internals ------------------------------------------------------------
    def _client(self, name: str) -> _Supervised:
        c = self._clients.get(name)
        if c is None:
            raise KeyError(f"no supervised client {name!r}")
        return c

    def _try_settle(self, c: _Supervised) -> bool:
        """Absorb the client's message if available; True when it settled
        (reported, channel dead, or process gone without reporting)."""
        alive = c.proc.is_alive()  # check BEFORE polling: a message landing
        # between poll and liveness check must not be mistaken for a crash
        try:
            if not c.conn.poll(0 if alive else 0.05):
                if alive:
                    return False
                # dead + channel empty ⇒ will never report
                self._settle(c)
                return True
            ok, result, tb = c.conn.recv()
        except (EOFError, OSError):  # killed mid-send: only its own channel dies
            self._settle(c)
            return True
        c.received = True
        if ok:
            c.result.result = result
        else:
            c.result.error = ProcessCrashed(f"client {c.name} raised")
            c.result.traceback = tb
        self._settle(c)
        return True

    def _settle(self, c: _Supervised) -> None:
        c.settled = True
        c.cancel_timers()
        self._reap(c, timeout=5.0)
        if not c.received and c.result.error is None:
            c.result.error = ProcessCrashed(
                f"client {c.name} exited with code {c.result.exitcode} "
                "before reporting"
            )

    @staticmethod
    def _reap(c: _Supervised, timeout: float) -> None:
        if c.proc is None:
            return
        c.proc.join(timeout=timeout)
        if c.proc.is_alive():
            _sigkill(c.proc)
            c.proc.join(timeout=5.0)
        c.result.exitcode = c.proc.exitcode


def _sigkill(proc) -> None:
    if proc is not None and proc.is_alive() and proc.pid is not None:
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def run_multiprocess(
    clients: Sequence[Callable[[], Any] | tuple],
    *,
    names: Sequence[str] | None = None,
    start_method: str = "spawn",
    join_timeout: float = 600.0,
    kill_after: dict[int, float] | None = None,
) -> list[ClientResult]:
    """Run clients as real OS processes; a crashed process never kills the rest.

    Each entry of ``clients`` is either a zero-arg callable or a
    ``(target, args)`` / ``(target, args, kwargs)`` tuple. Targets and their
    return values cross a process boundary, so both must be picklable —
    module-level functions, not closures (the ``spawn`` start method gives
    every client a clean interpreter, which is what a real serverless
    deployment looks like and the only start method under which a child can
    open its own CUDA context). A client that launches the port's kernels
    returns its own launch counts: the parent's counters never see a child's.

    ``kill_after`` maps client index → seconds after launch at which the
    process is SIGKILLed (crash injection mid-round: no cleanup, no goodbye
    deposit — exactly what the async-robustness claim must survive). Killed or
    timed-out clients report a ``ProcessCrashed`` error in their
    ``ClientResult``; survivors are unaffected. Kill timers are cancelled as
    soon as their client settles — a client finishing before its scheduled
    kill leaves no timer thread behind.

    One-shot wrapper over ``ProcessSupervisor`` (use that directly for
    incremental spawn/kill/restart — the fleet chaos harness does).
    """
    specs: list[tuple[Callable[..., Any], tuple, dict]] = []
    for entry in clients:
        if callable(entry):
            specs.append((entry, (), {}))
        else:
            target = entry[0]
            args = tuple(entry[1]) if len(entry) > 1 else ()
            kwargs = dict(entry[2]) if len(entry) > 2 else {}
            specs.append((target, args, kwargs))
    for i in kill_after or {}:
        # validate BEFORE launching anything: failing mid-setup would leave
        # already-started children running unsupervised
        if not 0 <= i < len(specs):
            raise ValueError(f"kill_after index {i} out of range for {len(specs)} clients")
    names = list(names or [f"node{i}" for i in range(len(specs))])
    if len(names) != len(specs):
        raise ValueError(f"{len(names)} names for {len(specs)} clients")
    if len(set(names)) != len(names):
        raise ValueError(f"client names must be unique, got {names}")

    sup = ProcessSupervisor(start_method=start_method)
    try:
        for name, (t, a, kw) in zip(names, specs):
            sup.spawn(name, t, a, kw)
        for i, delay in (kill_after or {}).items():
            sup.schedule_kill(names[i], delay)
        sup.join(join_timeout)
    finally:
        sup.shutdown()
    return [sup.result(n) for n in names]


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
