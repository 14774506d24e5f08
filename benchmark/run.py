"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell's files (``benchmark/workloads/<cell>.json`` and the
configuration, traffic mix and driver it names) say what to run.  The run
makes its inputs from ``--seed``, warms up the cell's own shapes, sends
requests back to back for ``--seconds`` (one client, closed loop), checks
the outputs against the plain reference, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiler trace of the window.  It exits non-zero
without a result where there is no CUDA card, or fewer than the cell asks
for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness import core

    ctx = core.context(args.workload, args.seed, args.seconds,
                       bool(args.trace), T0)
    import torch
    chips = int(ctx.workload["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    run = core.driver(ctx.workload["driver"]).run(ctx)
    return core.finish(ctx, run)


if __name__ == "__main__":
    sys.exit(main())
