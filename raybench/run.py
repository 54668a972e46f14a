"""Run one cell of the benchmark of blink_torch once.

    python3 raybench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as its last line, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks` (each number compared beside its limit,
which also end standard error). Exits non-zero, printing no result, without
a CUDA device, and if a module of JAX or of the JAX package is loaded when
the result would print.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from raybench.lib import bench

    bench.env_for_caches(ROOT)
    import torch

    spec = bench.cell_spec(ROOT, args.workload)
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"raybench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda:0",
                            T_START, log=lambda m: print(m, file=sys.stderr))
    bad = bench.forbidden_loaded()
    if bad:
        print(f"raybench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in bench.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
