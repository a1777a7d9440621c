"""Run one cell of the port's benchmark; see ``bench/README.md``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness.core import Refused, run  # noqa: E402

if __name__ == "__main__":
    try:
        sys.exit(run())
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        sys.exit(2)
