#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload m462b.search --seed 7 --seconds 45 \
        --trace 0

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell, its configuration, traffic mix, metrics and limits
come from `BENCHMARK.json` and the files under `bench/` it names.  The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` also `breakdown`, and last
`checks`: each number compared with its limit); the last lines of
standard error are the same checks.  Without the cards, or with a module
of JAX or of the JAX package loaded, it prints no result and exits 2.
"""
import time

T0 = time.perf_counter()    # set-up counts from here, less the start below

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _since_start() -> float:
    """Seconds since this process started, from /proc (0 where there is
    none): the interpreter's own start counts towards set-up too."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc builds go to build/kernels/), and one thread per
    CPU thread pool: the program's work is the card's and the host's one
    Python thread, and idle pool threads only take cores from it."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")


def main(argv=None) -> int:
    t0 = T0 - _since_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

    from harness.cell import FORBIDDEN, forbidden_modules, run_cell
    from harness.spec import Spec
    spec = Spec.load(ROOT)
    chips = int(spec.workload(args.workload)["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), t0, log=log)
    found = forbidden_modules(FORBIDDEN)
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
