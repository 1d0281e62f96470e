#!/usr/bin/env python3
"""Readings that set the limits of a cell's checks, on the chip.

    python3 bench/control.py --workload m462b.search --seconds 10 \
        --seeds 11 12 13 ... --out control.m462b.search.json

In one process (set-up once), for each seed: a short window of the cell's
own traffic through the program as it is (the lower readings), then for
the first three seeds the same gaps with the reference put in the
program's place one precision lower (bfloat16 lanes, float32
certification: the control's upper readings), and for the first three
seeds a window with the fault `answer_altered` planted (the upper
readings of `plan_excess`, which no lower precision reaches).  The benchmark's own runs never run
this.  Every reading goes to `--out` as JSON and to standard error.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
READS = 3       # seeds of the control's and of the fault's readings
FAULT = "answer_altered"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    from harness import check, job, traffic
    from harness.cell import warm_up
    from harness.faults import FAULTS
    from harness.probe import Probe
    from harness.spec import Spec

    spec = Spec.load(ROOT)
    wl = spec.workload(args.workload)
    config, traf = spec.config(wl), spec.traffic(wl)
    limits = {k: float("inf") for k in spec.limits(wl)}
    lanes = traf["check"]["lanes"]
    dag = job.build_dag(config)
    warm_up(dag, traf, config, None)
    judge = check.Judge(job.raw_dag(dag))
    out = {"workload": args.workload, "seconds": args.seconds,
           "program": [], "control": [], "fault": []}

    def window(seed: int, fault: str | None):
        probe = Probe()
        if fault:
            FAULTS[fault](probe)
        probe.record_outputs()
        try:
            records, window_s = traffic.drive(traf, config, dag, seed,
                                              args.seconds, probe)
        finally:
            probe.restore()
        checks, info = check.compare(records, probe, judge, config, lanes,
                                     seed, limits)
        return records, probe, {c.name: c.value for c in checks}, dict(
            info, window_s=window_s, failed=sum(not r.ok for r in records))

    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        records, probe, read, info = window(seed, None)
        out["program"].append({"seed": seed, **read, **info})
        print(f"program seed {seed}: {read} {info} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr,
              flush=True)
        if i < READS:
            t = time.perf_counter()
            low = check.control_readings(records, probe, judge, lanes, seed)
            out["control"].append({"seed": seed, **low})
            print(f"control seed {seed}: {low} "
                  f"({time.perf_counter() - t:.1f} s)", file=sys.stderr,
                  flush=True)
    for seed in args.seeds[:READS]:
        _, _, read, info = window(seed, FAULT)
        out["fault"].append({"fault": FAULT, "seed": seed, **read, **info})
        print(f"fault {FAULT} seed {seed}: {read}", file=sys.stderr,
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
