"""Serve a small model with batched requests (prefill + decode loop).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

Runs `repro_torch.launch.serve` in process on qwen3-0.6b at its reduced
size: batch 4, a 64-token prompt, 32 decode steps.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda | cpu)")
    args = ap.parse_args(argv)
    cmd = ["--arch", "qwen3-0.6b", "--reduce", "--batch", "4",
           "--prompt-len", "64", "--decode-steps", "32",
           "--device", args.device]
    print("+ python -m repro_torch.launch.serve", " ".join(cmd))
    serve.main(cmd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
