"""Join a live fleet read-only and serve its freshest weights — the port of
the ``python -m repro.serve`` CLI.

    python -m repro_torch.serve --store /mnt/shared/exp1 --arch mamba2-130m --reduced

Works against any store the port's URI grammar accepts (``memory://`` is only
useful in-process). The node deploys the freshest aggregated update in the
store, hot-swaps as trainers push new rounds, and serves synthetic
greedy-decode batches, printing per-batch throughput plus the swap/staleness
SLOs. With ``REPRO_OBS`` (or ``--obs``) the
node's ``Telemetry`` also deposits ``obs/`` blobs with its SERVE row. Runs on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.api import connect, serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--store", required=True, help="weight-store URI (see repro_torch.api)")
    ap.add_argument("--arch", required=True, help="arch name from repro_torch.configs")
    ap.add_argument("--reduced", action="store_true", help="reduced config (smoke scale)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic batches to serve before exiting (0 = until --timeout)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="overall wall-clock budget in seconds")
    ap.add_argument("--wait", type=float, default=30.0,
                    help="seconds to wait for the first weights in the store")
    ap.add_argument("--poll-interval", type=float, default=0.25)
    ap.add_argument("--obs", action="store_true",
                    help="force telemetry on (default: REPRO_OBS env)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the weights live and decode runs")
    args = ap.parse_args(argv)

    store = connect(args.store)
    node = serve(
        store,
        args.arch,
        reduced=args.reduced,
        poll_interval=args.poll_interval,
        telemetry=True if args.obs else None,
        start=True,
        device=args.device,
    )
    try:
        if not node.wait_until_deployed(args.wait):
            print(f"serve: no deployable weights in {args.store!r} "
                  f"after {args.wait:.0f}s")
            return 1
        rng = np.random.default_rng(args.seed)
        deadline = time.monotonic() + args.timeout
        served = 0
        while time.monotonic() < deadline:
            prompts = rng.integers(
                0, node.cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32
            )
            t0 = time.monotonic()
            out, meta = node.generate(prompts, new_tokens=args.new_tokens)
            dt = time.monotonic() - t0
            served += 1
            tps = out.size / dt
            print(
                f"batch {served}: tokens/s={tps:.1f} weights={meta['source']}"
                f"@{meta['counter']} swaps={node.stats()['swaps']}"
            )
            if args.requests and served >= args.requests:
                break
        print("SLO", json.dumps(node.stats()))
        return 0
    finally:
        node.stop()
        store.stop_prefetch()


if __name__ == "__main__":
    raise SystemExit(main())
