"""Run one cell of ``BENCHMARK.json`` once and print its result as the
last line of standard output::

    python3 -m benchmark.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for) and when a module the benchmark may not load
(JAX or the JAX package) was loaded.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
