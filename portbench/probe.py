"""The readings a cell's limits are set from, on the card at the cell's own
size: the program's on many seeds, the control's (the reference one
precision below the configuration's), and those of planted faults.

    python3 -m portbench.probe --workload <cell> --seeds 1,2,3 --mode program|control|<fault>
        [--seconds 3]

Prints one JSON line per seed with its readings. The benchmark's runs never
call this."""
from __future__ import annotations

import argparse
import json
import sys

from portbench import faults, harness
from portbench.run import _environment


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--mode", default="program",
                        choices=["program", "control", *faults.FAULTS])
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    cell, cfg, mix = harness.workload(args.workload)
    _environment()
    driver = harness.load_by_name("drivers", cfg["driver"])
    patch = faults.FAULTS.get(args.mode)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = driver.run(cfg, mix, seed=seed, seconds=args.seconds, trace=False,
                            patch=patch, control=args.mode == "control")
        print(json.dumps({"workload": cell["name"], "mode": args.mode, "seed": seed,
                          "readings": result["readings"], "metrics": result["metrics"],
                          "setup_s": result["setup_s"], "attempted": result["attempted"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
