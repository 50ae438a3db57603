"""Multi-process serverless federation — the paper's claim with real
processes (the torch twin of ``examples/multiprocess_federation.py``).

K clients run as separate OS processes (``spawn``: each gets a clean
interpreter and opens its own CUDA context) whose ONLY shared state is a
folder on disk. Each client holds its model on the card and aggregates there
(``fed_agg``); the children load the kernels the first build left in
``build/repro_torch/``. Optionally one client is SIGKILLed mid-training; in
async mode the survivors keep going and still converge — no server, no
coordinator, nothing to restart.

Also demonstrates the store transports: ``--transport delta`` ships sparse
diffs against a content-hashed base blob, and ``cache+`` folders skip
re-downloading unchanged peer blobs (per-key version metadata).

    PYTHONPATH=src python -m repro_torch.examples.multiprocess_federation [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.multiprocess_federation --crash --nodes 4
    PYTHONPATH=src python -m repro_torch.examples.multiprocess_federation --transport delta

``main`` returns the exit code; ``federate`` returns each client's numbers.
"""
from __future__ import annotations

import argparse
import signal
import tempfile
import time

import torch

from repro_torch.core import (
    AsyncFederatedNode,
    CachingFolder,
    make_folder,
    run_multiprocess,
)
from repro_torch.core.strategies import FedAvg
from repro_torch.kernels import resolve_device


def client(i: int, folder_uri: str, target: float, epochs: int, transport: str,
           hang_after: int | None = None, device: str = "cuda") -> dict:
    """Quadratic consensus client (module-level: spawn must pickle it).

    Local 'training' pulls w toward this client's own target; federation mixes
    in the peers. With FedAvg the fleet converges near the mean of targets.
    ``hang_after`` parks the client after that many federation rounds so an
    injected SIGKILL reliably lands mid-training. ``w`` lives on ``device``.
    """
    dev = resolve_device(device)
    folder = make_folder(folder_uri)
    node = AsyncFederatedNode(strategy=FedAvg(device=dev), shared_folder=folder,
                              node_id=f"client{i}", transport=transport)
    w = torch.zeros((8,), dtype=torch.float32, device=dev)
    ready_unix = time.time()  # interpreter, imports and the device context are up
    for epoch in range(epochs):
        w = w + 0.3 * (target - w)  # local step
        aggregated = node.update_parameters({"w": w}, num_examples=10)
        if aggregated is not None:
            w = aggregated["w"]
        if hang_after is not None and epoch + 1 >= hang_after:
            while True:  # mid-training: wait for the SIGKILL
                time.sleep(0.05)
        time.sleep(0.1)
    out = {"final": float(w.mean()), "pushes": node.num_pushes,
           "aggregations": node.num_aggregations, "launches": dict(node.strategy.launches),
           "ready_unix": ready_unix}
    if isinstance(folder, CachingFolder):
        out["cache"] = folder.cache_stats()
    return out


def federate(*, nodes: int = 3, epochs: int = 10, transport: str = "full",
             no_cache: bool = False, crash: bool = False, store: str | None = None,
             device: "str | torch.device" = "cuda", join_timeout: float = 300.0) -> dict:
    """Run the clients as processes and print each one's outcome; returns
    the store, the targets, each client's record (or its error and exit
    code), the survivors' finals, their start-up seconds (spawn to the model
    on the device) and the children's ``fed_agg`` launches."""
    device = str(resolve_device(device))  # fail here, not in every child
    shared_dir = store or tempfile.mkdtemp(prefix="flwr_serverless_mp_")
    folder_uri = ("" if no_cache else "cache+") + shared_dir
    print(f"weight store: {shared_dir}  (transport={transport})")

    targets = [float(i) for i in range(nodes)]
    clients = [
        (client, (i, folder_uri, targets[i], epochs, transport),
         {"hang_after": 3 if (crash and i == nodes - 1) else None, "device": device})
        for i in range(nodes)
    ]
    kill_after = {nodes - 1: 8.0} if crash else None
    spawned_unix = time.time()
    results = run_multiprocess(clients, names=[f"client{i}" for i in range(nodes)],
                               kill_after=kill_after, join_timeout=join_timeout)

    records = []
    for r in results:
        if r.error is not None:
            crashed = r.exitcode == -signal.SIGKILL
            print(f"{r.node_id}: {'SIGKILLED mid-training' if crashed else r.error} "
                  f"(exit code {r.exitcode})")
            records.append({"node": r.node_id, "error": str(r.error), "exitcode": r.exitcode,
                            "sigkilled": crashed})
        else:
            print(f"{r.node_id}: final={r.result['final']:.3f} "
                  f"pushes={r.result['pushes']} aggregations={r.result['aggregations']}"
                  + (f" cache={r.result['cache']}" if "cache" in r.result else ""))
            records.append({"node": r.node_id, **r.result})
    survivors = [r for r in results if r.error is None]
    finals = [r.result["final"] for r in survivors]
    spread = f"consensus spread {max(finals) - min(finals):.3f} " if finals else ""
    print(f"{len(survivors)}/{nodes} clients finished; "
          f"{spread}(targets spanned {max(targets) - min(targets):.1f})")
    launches = {"fed_agg": sum(r.result["launches"]["fed_agg"] for r in survivors)}
    return {"store": shared_dir, "targets": targets, "clients": records,
            "finished": len(survivors), "finals": finals, "launches": launches,
            "startup_s": [r.result["ready_unix"] - spawned_unix for r in survivors]}


def main(argv: list[str] | None = None, *, join_timeout: float = 300.0,
         record: dict | None = None) -> int:
    """``join_timeout`` bounds the clients' run; ``record``, when given,
    receives ``federate``'s numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.multiprocess_federation",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--transport", default="full",
                    help="legacy name (full/quantized/delta/delta_q/topk) or "
                         "a pipeline spec string such as 'delta(chain=4)|npz' "
                         "or 'topk(adaptive)'")
    ap.add_argument("--no-cache", action="store_true",
                    help="read the folder directly instead of through cache+")
    ap.add_argument("--crash", action="store_true",
                    help="SIGKILL the last client mid-training")
    ap.add_argument("--store", default=None,
                    help="shared folder path (default: fresh temp dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = federate(nodes=args.nodes, epochs=args.epochs, transport=args.transport,
                   no_cache=args.no_cache, crash=args.crash, store=args.store,
                   device=args.device, join_timeout=join_timeout)
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
