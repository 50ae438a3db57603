"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each one
against its plain PyTorch version at the main path's shapes, times it beside
its bound, then drives the port's federation loop end to end: four threaded
clients (two FedAvg, two FedAdam) train the GroupNorm ResNet-18 at full width
and federate through a disk folder. Prints one JSON line per phase, then the
kernel summary and, last, ``{"ok": true, "device": {...}}``. Any failure
raises (exit code != 0). Without a CUDA card, or without the repository
beside it, it exits non-zero before printing any result.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Main-path shapes: the two paper models' parameter counts.
N_MNIST, N_RESNET18 = 421_642, 11_176_970
CHECK_SHAPES = [(2, N_MNIST), (4, N_RESNET18), (8, 8193), (65, 8192), (200, 4000), (3, 7)]
TIME_SHAPES = [(4, N_RESNET18), (16, N_RESNET18)]
FED_CLIENTS, FED_EPOCHS, FED_STEPS, FED_BATCH = 4, 3, 8, 64
OPT_HP = dict(lr=0.3, b1=0.9, b2=0.95, tau=1e-2)

# Device-memory rate by card (NVIDIA data sheets), bytes/s, and the f32 rate
# outside the tensor cores (the fed kernels' arithmetic), flop/s.
_BANDWIDTH = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
_F32_FLOPS = [("H100 PCIe", 51e12), ("H100", 67e12), ("H200", 67e12)]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_rate(table, name: str) -> tuple[float, str]:
    for key, rate in table:
        if key in name:
            return rate, key
    raise RuntimeError(f"no published rate for card {name!r}")


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` calls, each between its own pair of CUDA events.
    The calls are enqueued back to back, so the card does not sit idle
    waiting for the host's next launch inside a timed interval."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
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
    ptxas = [line.strip() for log in _build.build_logs.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, libraries=[str(p) for p in libs.values()],
         ptxas=sorted(set(ptxas)))

    # -- 3. kernel_check --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {"fed_agg": 0.0, "fed_opt": 0.0}
    checks = []

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
    timings = []
    for k, n in TIME_SHAPES:
        ld = -(-n // 32) * 32  # the strategies' stack layout
        x = torch.randn(k, ld, device=dev, generator=gen)[:, :n]
        w = torch.full((k,), 1.0 / k, device=dev)
        p, m, v = (torch.randn(n, device=dev, generator=gen) for _ in range(3))
        v = v.abs()
        timings.append({
            "name": "fed_agg", "K": k, "N": n,
            "kernel_ms": time_ms(lambda: fk.fed_agg(x, w)),
            "plain_ms": time_ms(lambda: fed_agg_ref(x, w)),
            "library_ms": time_ms(lambda: torch.mv(x.t(), w)),
            **bound("fed_agg", k, n, card)})
        timings.append({
            "name": "fed_opt", "variant": "adam", "K": k, "N": n,
            "kernel_ms": time_ms(lambda: fk.fed_opt(x, w, p, m, v, variant="adam", **OPT_HP)),
            "plain_ms": time_ms(lambda: fed_opt_ref(x, w, p, m, v, variant="adam", **OPT_HP)),
            "library_ms": None,
            **bound("fed_opt", k, n, card)})
        del x, p, m, v
    emit("kernels", card=card, nvidia_smi=smi, timings=timings)

    # -- 5. federation: the port's main path, end to end -------------------------
    from repro_torch.api import connect
    from repro_torch.core import AsyncFederatedNode, Callback, FederatedCallback, run_threaded
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

    class EpochClock(Callback):
        def __init__(self):
            self.seconds: list[float] = []

        def on_epoch_begin(self, trainer, epoch):
            torch.cuda.synchronize()
            self._t = time.perf_counter()

        def on_epoch_end(self, trainer, epoch, logs):
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - self._t)

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

    # -- summary ----------------------------------------------------------------
    main_shape = {t["name"]: t for t in timings if t["K"] == 4}
    kernels = [{
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": replaces, "launches": launches[name], "max_abs_err": max_err[name],
        "ms": main_shape[name]["kernel_ms"], "plain_ms": main_shape[name]["plain_ms"],
        "bound_ms": main_shape[name]["bound_ms"], "bound_by": main_shape[name]["bound_by"],
        "library_ms": main_shape[name]["library_ms"],
    } for name, replaces in (("fed_agg", "src/repro/kernels/fed_agg/kernel.py:62"),
                             ("fed_opt", "src/repro/kernels/fed_agg/kernel.py:144"))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
