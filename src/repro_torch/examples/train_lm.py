"""End-to-end driver: plan the fabric with DELTA, then train a ~100M-class
model for a few hundred steps on synthetic data with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--quick] \
        [--ckpt-dir DIR] [--device cpu]

Runs `repro_torch.launch.train` in process on qwen3-0.6b at its reduced
size: batch 8, seq 128, a checkpoint every 50 steps, the fabric planned
first; 300 steps with a failure injected at step 75, or 60 steps and no
failure with --quick.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile

from repro_torch.launch import train


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a new temporary "
                         "directory, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda | cpu)")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        # a fresh directory per run: a checkpoint left by an earlier run
        # would make the first save fail and the loop restore that run
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_"))
        steps = "60" if args.quick else "300"
        cmd = ["--arch", "qwen3-0.6b", "--reduce",
               "--steps", steps, "--batch", "8", "--seq", "128",
               "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
               "--plan-topology",
               "--simulate-failure", "75" if not args.quick else "-1",
               "--log-every", "20", "--device", args.device]
        print("+ python -m repro_torch.launch.train", " ".join(cmd))
        train.main(cmd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
