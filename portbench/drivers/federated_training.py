"""One client of a serverless federated fleet: the paper's three lines,
``Trainer.fit`` with ``FederatedCallback(AsyncFederatedNode(FedAvg))`` over a
``memory://`` store, the rest of the fleet replayed into that store.

Set-up draws the initial weights on the card from the seed, the client's
shard of synthetic CIFAR-10 and each peer's two deposits (the initial
weights plus N(0, ``peer_spread``²) noise), which are serialized once. It
then drives the client's own objects through their first three steps (the
steps the check follows) and one warm-up round, and hands those same objects
to the window. During the window a thread writes the next deposit of every
peer each ``peer_period_s``, a period shorter than the client's epoch plus
round, so that every round pulls every peer fresh, as in a steady fleet of
clients of equal speed.

The window runs epoch after epoch; it ends at the first epoch boundary
(after its round) at or past ``seconds``, and its rate is every sample trained
over that time. The check follows the first three steps with the plain
reference, reads the client's deposit of one round back from the store and
works that round's aggregate out again from the deposits it pulled.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import harness
from portbench.counts import resnet18 as counts
from portbench.reference import resnet18 as ref
from portbench.reference import wire
from portbench.traffic import cifar

CLIENT = "client0"
B1 = 0.9  # Adam's first-moment decay: the first gradient is m after one step / (1 - B1)


class _Closed(Exception):
    """Raised at the epoch boundary that closes the window."""


def _seed(seed: int, *k: int) -> list[int]:
    return [int(seed) % 2**64, *k]


def initial_weights(cfg: dict, seed: int, device) -> dict:
    """He-normal convolutions, 1/sqrt(d_in) for the classifier, zero biases,
    unit norm scales: one normal draw on ``device`` for every leaf, scaled
    per leaf."""
    leaves = ref.layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in leaves]
    std = torch.tensor([scale if kind == "normal" else 0.0 for _, _, kind, scale in leaves],
                       device=device)
    base = torch.tensor([scale if kind == "const" else 0.0 for _, _, kind, scale in leaves],
                        device=device)
    counts_t = torch.tensor(sizes, device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(std, counts_t) + torch.repeat_interleave(base, counts_t)
    return {path: part.view(shape)
            for (path, shape, _, _), part in zip(leaves, flat.split(sizes))}


class Feed:
    """The client's shard, batch after batch along an endless stream of
    seed-drawn permutations, so consecutive batches hold different rows."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int, seed: int):
        self.x, self.y, self.batch = x, y, batch
        self.rng = np.random.default_rng(_seed(seed, 2))
        self.order = np.empty(0, np.int64)

    def next_batch(self) -> dict:
        while len(self.order) < self.batch:
            self.order = np.concatenate([self.order, self.rng.permutation(len(self.x))])
        idx, self.order = self.order[: self.batch], self.order[self.batch:]
        return {"x": self.x[idx], "y": self.y[idx]}

    def epochs(self, steps: int, keep: list | None = None):
        """``Trainer.fit``'s data function: each epoch, ``steps`` batches."""

        def epoch(_):
            for _ in range(steps):
                batch = self.next_batch()
                if keep is not None:
                    keep.append(batch)
                yield batch

        return epoch


def _make_recording_fedavg(FedAvg, folder, record_round: int):
    """FedAvg that notes, for round ``record_round``, the client's blob as
    read back from the store, the peers it pulled and its output; and the
    (K, N) and time of every round."""

    class RecordingFedAvg(FedAvg):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.rounds = 0
            self.record = None
            self.calls: list[tuple[float, int, int]] = []

        def aggregate(self, own, peers):
            out = super().aggregate(own, peers)
            k = 1 + len(peers)
            self.calls.append((time.perf_counter(), k, self._spec.num_params))
            if self.rounds == record_round:
                self.record = {
                    "num_examples": own.num_examples,
                    "blob": folder.get(f"latest/{CLIENT}"),
                    "peers": [(p.node_id, p.counter, p.num_examples) for p in peers],
                    "out": {p: t.detach().clone() for p, t in harness.flat_paths(out).items()},
                }
            self.rounds += 1
            return out

    return RecordingFedAvg


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", patch=None, control: bool = False,
        record_round: int | None = None) -> dict:
    """One run of the cell. ``patch(objects)`` may replace parts of the
    program before the first step (the fault tests); ``control`` reads the
    control in the program's place; ``record_round`` picks the round the
    check works out again (default: one of the window's first three, drawn
    from the seed; 0 is the warm-up round)."""
    from repro_torch.api import connect
    from repro_torch.core import AsyncFederatedNode, FederatedCallback, Telemetry
    from repro_torch.core.callback import Callback
    from repro_torch.core.strategies import FedAvg
    from repro_torch.models.cnn import ResNet
    from repro_torch.optim import adam
    from repro_torch.training import Trainer

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(_seed(seed, 1))
    if record_round is None:
        record_round = 1 + int(rng.integers(0, 3))

    # -- inputs, made from the seed -----------------------------------------------------
    init = initial_weights(cfg, seed, dev)
    model = ResNet(cfg["num_classes"], cfg["in_channels"], cfg["width"], cfg["blocks_per_stage"])
    want = {p: tuple(t.shape) for p, t in harness.flat_paths(model.abstract()).items()}
    if want != {p: tuple(t.shape) for p, t in init.items()}:
        raise RuntimeError("the program's ResNet layout differs from the reference's")
    hw = cfg["image_hw"]
    x, y = cifar.images(mix["shard_images"], _seed(seed, 3), hw=hw,
                        channels=cfg["in_channels"], num_classes=cfg["num_classes"])
    feed = Feed(x, y, cfg["batch"], seed)
    peers = [f"peer{i}" for i in range(1, mix["clients"])]
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 7) % 2**63)
    init_flat = torch.cat([t.reshape(-1) for t in init.values()])
    blobs = {}
    for peer in peers:
        blobs[peer] = []
        for s in range(mix["peer_sets"]):
            noise = torch.randn(init_flat.numel(), generator=gen, device=dev)
            flat = (init_flat + mix["peer_spread"] * noise).cpu().numpy()
            leaves, pos = {}, 0
            for p, t in init.items():
                leaves[p] = flat[pos:pos + t.numel()].reshape(t.shape)
                pos += t.numel()
            blobs[peer].append(wire.write_update(leaves, node_id=peer, counter=s,
                                                 num_examples=mix["shard_images"]))

    # -- the system under test ----------------------------------------------------------
    store = connect(f"memory://portbench-{CLIENT}")
    folder = store.folder
    for key in list(folder.keys()):
        folder.delete(key)
    for peer in peers:
        folder.put(f"latest/{peer}", blobs[peer][0])
    tel = Telemetry(CLIENT, enabled=trace, flush_every=10**9, ring_capacity=1 << 16)
    strategy = _make_recording_fedavg(FedAvg, folder, record_round)(device=dev)
    node = AsyncFederatedNode(strategy=strategy, store=store, node_id=CLIENT, telemetry=tel,
                              device=dev)
    trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b), optimizer=adam(cfg["lr"]),
                      init_params=harness.nested(init), telemetry=tel, device=dev, seed=0)
    fed = FederatedCallback(node, num_examples_per_epoch=mix["shard_images"])
    if patch is not None:
        patch({"trainer": trainer, "node": node, "strategy": strategy})

    # -- the first three steps, through the window's own call and feed -------------------
    probe_batches: list = []
    probe: dict = {"losses": []}

    class Probe(Callback):
        def on_epoch_end(self, trainer, epoch, logs):
            probe["losses"].append(logs["loss"])
            if len(probe["losses"]) == 1:
                probe["grad"] = {p: m / (1 - B1)
                                 for p, m in harness.flat_paths(trainer.opt_state["m"]).items()}
            if len(probe["losses"]) == 3:
                probe["change"] = {p: t - init[p]
                                   for p, t in harness.flat_paths(trainer.params).items()}

    for _ in range(3):
        trainer.fit(feed.epochs(1, keep=probe_batches), epochs=1, callbacks=[Probe()])

    snapshot: dict = {}

    class Deposit(Callback):
        """Before the round the check works out again, the trainer's own
        parameters, copied to the host by the benchmark: what the client
        ought to push."""

        def on_epoch_end(self, trainer, epoch, logs):
            if strategy.rounds == record_round:
                snapshot.update({p: t.detach().to("cpu", copy=True).numpy()
                                 for p, t in harness.flat_paths(trainer.params).items()})

    deposit = Deposit()
    # one round before the window: the kernel build, the stack, every shape of a round
    trainer.fit(feed.epochs(2), epochs=1, callbacks=[deposit, fed])

    # -- the window ---------------------------------------------------------------------
    steps = mix["steps_per_epoch"]
    stop = threading.Event()

    def replay():
        k = 1
        while not stop.wait(mix["peer_period_s"]):
            for peer in peers:
                folder.put(f"latest/{peer}", blobs[peer][k % mix["peer_sets"]])
            k += 1

    profiler = harness.Profiled() if trace else None
    boundaries: list[float] = []

    class Window(Callback):
        def on_epoch_end(self, trainer, epoch, logs):
            now = time.perf_counter()
            boundaries.append(now)
            if profiler is not None:
                if len(boundaries) == mix["profile_from_round"]:
                    profiler.start()
                elif len(boundaries) == mix["profile_from_round"] + mix["profile_rounds"]:
                    profiler.stop()
            # the window closes once its time is up, the profile is taken and the
            # round the check works out again has run
            if now >= close and (profiler is None or profiler.done) and strategy.record is not None:
                raise _Closed

    replayer = threading.Thread(target=replay, name="portbench-peers", daemon=True)
    tel.recorder.drain()
    step0 = trainer.step
    setup_s = harness.process_age_s()
    t0 = time.perf_counter()
    close = t0 + seconds
    replayer.start()
    try:
        trainer.fit(feed.epochs(steps), epochs=10**9, callbacks=[deposit, fed, Window()])
    except _Closed:
        pass
    finally:
        stop.set()
        replayer.join(timeout=60)
    t_end = boundaries[-1]
    samples = (trainer.step - step0) * cfg["batch"]
    spans = [(n, s, d) for n, s, d in tel.recorder.drain() if s >= t0]
    out = {
        "setup_s": setup_s,
        "attempted": trainer.step - step0,
        "failed": 0,
        "metrics": {"train_samples_per_s": harness.rate(samples, t_end - t0)},
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        "records": {
            "window_s": t_end - t0, "steps_per_epoch": steps,
            "sample_events": [(b, steps * cfg["batch"]) for b in boundaries],
            "spans": spans,
            "train_flops_per_sample": counts.train_flops_per_sample(cfg, hw),
            "fed_agg_calls": [c for c in strategy.calls if c[0] >= t0],
            "trace": profiler.result() if profiler else None,
        },
    }
    record = strategy.record
    del trainer, node, fed, strategy, store
    for key in list(folder.keys()):
        folder.delete(key)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------------------
    batches = [(torch.from_numpy(b["x"]).to(dev), torch.from_numpy(b["y"]).to(dev))
               for b in probe_batches]
    out["readings"] = check(cfg, init, batches, probe["losses"], probe["grad"], probe["change"],
                            record, snapshot, blobs, control=control)
    out["limits"] = mix["limits"]
    return out


def _reference(cfg: dict, init: dict, batches: list, *, tf32: bool) -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return ref.train_steps(init, cfg, batches, cfg["lr"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]


def check(cfg: dict, init: dict, batches: list, losses: list, grad: dict, change: dict,
          record: dict | None, snapshot: dict, blobs: dict, *, control: bool = False) -> dict:
    """The numbers the cell compares (see PERF.md): the three steps against
    the reference, the deposit read back, and the recorded round's
    aggregate. ``control`` puts the reference computed in TF32 in the
    program's place for the steps."""
    want = _reference(cfg, init, batches, tf32=False)
    if control:
        losses, grad, change = _reference(cfg, init, batches, tf32=True)
    readings = steps_readings(losses, grad, change, *want)
    readings.update(round_readings(record, snapshot, blobs))
    return readings


def steps_readings(losses, grad, change, ref_losses, ref_grad, ref_change) -> dict:
    """loss_gap: the first step's relative loss gap (the later steps' gaps,
    ``loss_gaps``, are given beside it: Adam's first step moves every weight
    by about its learning rate whatever the gradient's size, so weights whose
    gradient is near nought move apart on round-off, and the later losses
    with them; PERF.md). grad_gap, change_gap: the worst leaf's gap of norms
    (``harness.worst_leaf_gap``); the change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's (moved by
    round-off alone)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    still = {k for k, n in norms.items() if n < 1e-3 * median}
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad_gap, grad_leaf = harness.worst_leaf_gap(grad, ref_grad)
    change_gap, change_leaf = harness.worst_leaf_gap(change, ref_change, skip=still)
    return {"loss_gap": loss_gaps[0], "grad_gap": grad_gap, "change_gap": change_gap,
            "loss_gaps": loss_gaps, "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "still_leaves": sorted(still)}


def round_readings(record: dict | None, snapshot: dict, blobs: dict) -> dict:
    """deposit_gap: the client's deposit as read back from the store against
    the benchmark's own host copy of the trainer's parameters at that epoch's
    end (exact). aggregate_gap: the round's aggregate against the
    example-weighted mean of that copy and the peers' rows it pulled, worked
    out in float64 from the blobs, over the largest magnitude."""
    if record is None or not snapshot:
        return {"deposit_gap": None, "aggregate_gap": None}
    own = snapshot
    deposit, _ = wire.read_update(record["blob"])
    deposit_gap = max(float(np.max(np.abs(deposit[p] - own[p]))) if p in deposit else np.inf
                      for p in own)
    rows = [(own, record["num_examples"])]
    for peer, counter, n in record["peers"]:
        rows.append((wire.read_update(blobs[peer][counter])[0], n))
    weights = np.asarray([max(1, n) for _, n in rows], np.float64)
    weights /= weights.sum()
    worst, scale = 0.0, 0.0
    for p, got in record["out"].items():
        want = sum(w * r[p].astype(np.float64) for w, (r, _) in zip(weights, rows))
        worst = max(worst, float(np.max(np.abs(got.double().cpu().numpy() - want))))
        scale = max(scale, float(np.max(np.abs(want))))
    return {"deposit_gap": deposit_gap, "aggregate_gap": worst / scale}
