"""``portbench.probe`` with the hybrid's attention faults beside the shared
ones, for the cells of a hybrid model:

    python3 -m portbench.probe_hybrid --workload <cell> --seeds 1,2,3 \
        --mode program|control|attention_zeroed|attention_scale_default|<fault>

The benchmark's runs never call this."""
from __future__ import annotations

import sys

from portbench import faults, faults_hybrid, probe


def main(argv: list[str] | None = None) -> int:
    faults.FAULTS.update(faults_hybrid.FAULTS)
    return probe.main(argv)


if __name__ == "__main__":
    sys.exit(main())
