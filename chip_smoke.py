#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and drives the port (`src/repro_torch`)
only; it imports nothing of JAX or of the JAX package `repro`.  Phases:

  1. device   torch/CUDA versions, the card's name and power limit;
  2. build    every kernel of the port (waterfill, tclosure, maxplus), one
              nvcc each, all started together, from the sources in the
              checkout, with ptxas's register and shared-memory report;
  3. kernels  each kernel against its plain-torch version on the card
              (the shape and dtype sweeps of tests/test_kernels.py and the
              shape its path gives it at full width: bit equality for
              tclosure and maxplus; the fused filling kernel over a sweep
              and on the CSRs of megatron-462b and of the widest registry
              DAG, jamba-1.5-large-398b, at 48 lanes, with equal rounds),
              with its time, the plain version's, one PyTorch library
              call's and the card's bound;
  4. DES      the torch DES at the full width of megatron-462b (paper
              Table I: 1,024 GPUs, 32 pods) against the exact numpy DES on
              the fused path ('cuda': one fill_maxmin launch per trip) and
              on the per-round path ('cuda-round': one fill_round launch
              per round); a 48-genome batch in turns on both paths (round,
              fused, fused, round) with wall time, device busy time, idle
              share and host syncs per trip, the host's torch ops and the
              device's kernels of one fused trip, and the batch against
              48 single simulations;
  5. plan     the slice end to end: plan(PlanRequest(method="delta-fast"))
              for 5 GA generations of 48 genomes on the fused path, on the
              per-round path, and on the fused path again (s/generation of
              each, the kernel launch counts of each path, identical
              topologies from the two fused runs); and the GA on the card
              against the GA on the CPU at a small size (the same
              topology);
  6. xbound   Alg. 2 on megatron-462b with the closure by matrix squaring
              (the tclosure kernel) against the bitset closure: the same
              reachability and the same X-bar;
  7. paths    all-pairs longest paths by max-plus squaring (the maxplus
              kernel) on megatron-462b's dependency weights: row VIRTUAL
              is Alg. 4's EST; and the Bellman check of
              tests/test_kernels.py;
  8. robust   plan(delta-robust, max-regret) of an ensemble of
              megatron-462b at sequence lengths 4096 and 16384 (96 lanes
              per fitness batch: 48 genomes x 2 members, one fill_maxmin
              launch per trip), the refs by the facade's own delta-fast;
              the winner's member makespans on the card against the numpy
              DES; then delta_robust on megatron-462b at 128 and 64
              microbatches, members that differ in structure (801 and 417
              tasks, padded to one shape), its winner likewise;
  9. failsafe plan() of megatron-462b under four fabric scenarios (the
              healthy fabric and 1 of 4 planes dark on each of the three
              pod pairs of most volume: 192 lanes), its scenario makespans
              on the card against the numpy DES; gpt-7b under the default
              scenarios on the card and on the CPU (the same topology);
 10. milp     plan(delta-joint-hotstart) on gpt-7b at the reference
              benchmark's 4 microbatches: the hot-start GA on the card,
              the MILP on the host (HiGHS), a validate-clean schedule no
              worse than the same run's delta-fast;
 11. resilient plan() of gpt-7b with a zero MILP budget: the fallback
              chain lands on its GA stage, which runs on the card;
 12. trim     trim_ports on [plan]'s megatron-462b topology (its two
              pod pairs of most circuits first set to the 8 circuits
              where the full sweep leaves them) and trim_ports_ensemble
              on [robust]'s ensemble from that result, on the batched
              path on the card (every drop-one candidate of a round in
              one batch, one fill_maxmin launch per trip): ports before
              and after, rounds, and every accepted drop certified by the
              numpy DES;
 13. planes   delta_planes on megatron-462b with 4 planes (48 genomes x 5
              fabric states = 240 lanes per spare-stage batch): the
              winner's split and every one-plane-dark state against the
              numpy DES, s/generation and the idle share of a batch;
 14. fleet    the paper's Fig. 10 pair (a port-minimized donor and its
              reversed-stage co-tenant) through plan(kind="fleet") at the
              Table-I width of megatron-177b (the co-tenant's NCT before
              and after the surplus is water-filled into it, fill_matvec
              once per waterfill round) and of mixtral-8x22b (the largest
              DAG, 2,065 tasks per tenant): the ledger after every event,
              the engine-cache counts, the co-tenant's makespan against
              the numpy DES; fill_matvec at the fleet's shape against its
              plain version; the pair at gpt-7b on the card and on the
              CPU (the same topologies);
 15. cli      the control-plane CLI (python -m repro_torch.launch.topo_plan)
              in process at the full configured width of two registry
              architectures that the GA runs on the card
              (granite-moe-1b-a400m, MoE; llama-3.2-vision-11b,
              vision-language) with its default methods: fill_maxmin once
              per trip, delta-fast no worse than the best baseline, the
              written topology within the port limits, every method's
              topology scored on the card against the numpy DES, and
              fill_maxmin at each DAG's CSR against its plain version;
              the same methods on grok-1-314b (MoE, 2,192 tasks, a real
              GA search) with the GA forced onto the card for 3
              generations, likewise checked; 48 random topologies of
              jamba-1.5-large-398b (2,898 tasks, the widest registry DAG)
              as one batch on the card against the numpy DES;
 16. examples the seven planner and fleet examples (quickstart,
              plan_topology at gpt-7b, trace_plan, fleet_realloc,
              chaos_fleet, control_plane, planes_transition) on the
              card, each returning 0, with fill_maxmin once per trip and
              fill_matvec once per waterfill round;
 17. serve    the LM serving path (python -m repro_torch.launch.serve) in
              process at full published width in float32, the weights
              drawn on the card from a seeded generator: qwen3-0.6b (its
              default architecture; twice, the first call cold),
              granite-moe-1b-a400m (MoE), mamba2-130m (SSM) and
              whisper-large-v3 (encoder-decoder) at batch 4, a 64-token
              prompt and 32 decode steps, each with its weight bytes,
              prefill ms, decode ms per step, tok/s and peak allocated
              memory; kernels launched, device busy time and idle share
              of one qwen3-0.6b decode step; prefill and 4
              teacher-forced decode steps of qwen3-0.6b and
              granite-moe-1b-a400m at full width on the card against the
              same weights on the CPU (rel 1e-3 of max |logit|); decode
              against the full forward at full width for qwen3-0.6b,
              mamba2-130m and whisper-large-v3 (rel 2e-2); and all ten
              registry architectures at their reduced size on the card,
              decode against the full forward, finite logits;
 18. train    the LM training path (python -m repro_torch.launch.train)
              in process at qwen3-0.6b's full published width in float32
              with the driver's defaults (batch 8, seq 128, lr 1e-3): 40
              steps, a checkpoint every 10, a failure injected at step 25
              and --plan-topology (the job's fabric planned first, its GA
              on the card: fill_maxmin once per trip); exactly one
              restart, the replayed steps within rel 1e-5 of their first
              run, a falling loss, the state on the card; then steady
              steps timed (ms per step, tokens/s, peak memory, one step's
              launches, device busy and idle share, the FLOP and HBM
              bounds, host syncs) and a full-width checkpoint saved and
              restored; the card against the CPU from one state
              (qwen3-0.6b at full width, batch 2 x seq 32, 2 steps, and
              the ten registry architectures reduced, 3 steps: loss rel
              1e-5, grad norm rel 1e-4); granite-moe-1b-a400m and
              mamba2-130m at full width, 5 steps; accumulation over 4
              microbatches against one batch (loss rel 1e-4, parameters
              5e-3).

 19. dist     the distributed tools: (a) a 1 x 1 mesh over a world-size-1
              NCCL group (make_host_mesh(1, "cuda")), on which the
              sharding rules place plain tensors, and serve.main and
              train.main at qwen3-0.6b's full width through it:
              serve.main's tokens and logits equal to [serve]'s, the
              first loss equal to [train]'s, and the train path's losses
              and parameters equal to a plain step loop's from the same
              seed (deterministic kernels on both), bit for bit; (b)
              mean_grads_int8 on the card at world size 1 (the gradients
              unchanged, a zero residual), then the int8 ring on 4 gloo
              ranks on the host against the exact sum at the reference
              test's bounds; (c) the dry run's prediction for qwen3-0.6b
              training at [train]'s shape (batch 8 x seq 128, float32)
              on a 1 x 1 cuda mesh against the same step on the card:
              the argument bytes against the bytes the allocator holds
              for the placed state and batch, the FLOPs against a
              FlopCounterMode count of the step, temporaries plus
              arguments against the peak (printed, not gated); (d) the
              20 quick dry-run cells (the ten architectures reduced, at
              train_4k and decode_32k) on the 2 x 16 x 16 mesh of 512
              fake ranks, in a process of its own: 0 errors, 512
              devices, and each cell's FLOPs per device at most 1.1x
              and its collective bytes per device at most 2x the
              reference's (a table of the reference's figures, held
              against a live run by tests/test_torch_shardplan*.py);
              (e) the legacy GA at gpt-7b on the card under
              a generation cap: fill_maxmin once per trip, its x scored
              on the card as on the numpy DES, the vectorized GA no
              worse; (f) the sharded step on more than one rank:
              train.main and serve.main with --model-parallel 2 on 4
              gloo ranks of the host (a (2, 2) mesh, each rank joined to
              the group before main, as under torchrun) at qwen3-0.6b's
              reduced width, every rank's losses, parameters, tokens
              and logits against the same entry points in a process of
              their own (tests/test_torch_multirank.py's tolerances),
              after the phase has destroyed its process group.

Right after [device], [sentinel] runs the port's static analysis
(python -m repro_torch.analysis over its default paths) in a process of
its own on the card's host: exit 0 (no finding), the findings and the
inline suppressions by rule, its wall time, and the sanctioned host
syncs inside TorchDES's event loop (1: the loop's exit test), which
[des] prints again beside the host syncs per trip it measures.

On the fused path the event loop replays CUDA graphs of GRAPH_TRIPS
trips, and a replay launches fill_maxmin where the host sees no launch:
`waterfill.maxmin_launches` counts the launches made from the host (a
graph's warm-up).  Every fused-path check holds those launches, with
GRAPH_TRIPS per replay, against the trips the device ran (the trips in
which some lane ran and the idle ones after every lane had stopped, both
counted on the device).  [des]'s second profiled fused batch, [plan]'s
last fused run, the ensemble batches of [robust] and [failsafe] and
[planes]' spare-stage batch count fill_maxmin's kernels in a device trace,
closed by TRAILING_KERNELS spin kernels that take any loss of the trace's
last records, and hold that count against the same trips.  After every phase a [mem] line gives
the phase's peak device memory, what it left allocated and the trip
graphs kept.

The kernels phase also holds fill_maxmin's member axis against its plain
version: a sweep of 1-3 members, and the two members of each [robust]
ensemble at 96 lanes (the sequence-length pair shares one CSR; the
microbatch pair's CSRs differ, and each member's lanes must equal a
launch of that member alone).

Any failed check or error exits non-zero.  Without a CUDA device, or
without the port beside it, it exits non-zero before printing a result.
The second-to-last line of standard output is the kernels' JSON record
(fill_matvec twice: at the per-round DES path's shape and at the fleet's);
the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
F32_INSTR = F32_PEAK / 2  # float32 instructions/s: the peak counts FMA as 2
INT8_PEAK = 1979e12     # H100 SXM int8 tensor-core OP/s, dense
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
KERNEL_RTOL = KERNEL_ATOL = 1e-5
DES_RTOL = 5e-5
# (C, N) sweep of tests/test_kernels.py:79-106
SWEEP = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128), (34, 273)]
# tclosure and maxplus sweeps of tests/test_kernels.py:16-57
TC_SIZES = [1, 5, 64, 127, 128, 130, 257]
TC_DENSITIES = [0.02, 0.2]
MP_SHAPES = [(3, 4, 5), (64, 64, 64), (130, 17, 70), (1, 1, 1),
             (128, 128, 128)]
# the edges of the max-plus kernel's stream-K schedule: one row and column
# with a long k, ragged tiles, and a short k (fewer chunks than one block's
# range), each at megatron-462b's width
MP_EDGES = [(1, 801, 1), (33, 1000, 65), (801, 1, 801), (801, 3, 801),
            (801, 17, 801)]
KERNELS = ("waterfill", "tclosure", "maxplus")
# fill_maxmin sweep of tests/test_torch_cuda.py: (lanes S, tasks N,
# constraints C, entries E, density of the active sets); the last needs
# 93 KB of shared memory, above the 48 KB default
MAXMIN_SWEEP = [(1, 1, 1, 1, 1.0), (3, 5, 3, 7, 0.5), (8, 64, 8, 100, 0.3),
                (5, 257, 40, 600, 0.8), (2, 1000, 200, 3000, 0.05),
                (4, 4000, 100, 8000, 0.1)]
LANES = 48              # the GA population of the main path
ROBUST_SEQ_LENS = (4096, 16384)   # the [robust] ensemble's two members
# the second [robust] ensemble: megatron-462b at seq_len 4096 with Table
# I's 128 microbatches and with 64, members that differ in structure (the
# reference's robust benchmark mixes megatron microbatch counts likewise)
ROBUST_MICROBATCHES = (128, 64)
MEMBER_SWEEP = (257, 40, 600, 0.8)   # (N, C, E, density) of each member
ROBUST_GENERATIONS = 3
# depth cuts that keep the script inside its time limit (PERF.md section
# 4): the [robust] microbatch pair's generations, every
# SINGLES_STRIDE-th genome of [des]'s batch simulated alone, the
# [planes] stages' generations and the [fleet] mixtral-8x22b tenants'
ROBUST_MB_GENERATIONS = 2
SINGLES_STRIDE = 8
TRAILING_KERNELS = 10000   # spin kernels closing a trace whose kernels count
PLANES = 4              # OCS planes of the [planes] decomposition
PLANES_GENERATIONS = 2
FLEET_GENERATIONS = 3   # GA depth of each [fleet] tenant at full width
FLEET_MIXTRAL_GENERATIONS = 1
# the megatron-177b Fig. 10 pair's waterfill: W (P, T*P) @ (T*P, 2) with
# P = 24 pods and T = 1 bottlenecked tenant
FLEET_MATVEC = (24, 24, 2)
# [trim]'s single-DAG sweep starts from [plan]'s topology (ROUND_PATH_PORTS
# ports) with the TRIM_HEAVY pod pairs of most circuits in it set to
# TRIM_FLOOR circuits, where the full sweep from that topology leaves
# them (122 -> 74 ports in 25 rounds, 16 of its 24 drops on these two
# pairs, both left at 8); its ensemble sweep starts TRIM_ENSEMBLE_EXTRA
# circuits above the single-DAG sweep's result on each of the two pod
# pairs of most volume
TRIM_HEAVY, TRIM_FLOOR = 2, 8
TRIM_ENSEMBLE_EXTRA = 1
# plan() on megatron-462b (48 genomes, 5 generations, seed 0) on the
# per-round kernel path, as PERF.md records it
ROUND_PATH_PORTS, ROUND_PATH_MAKESPAN = 122, 93.60538748389672
# [cli]: two registry architectures that the GA's `auto` backend sends to
# the card (under its 1,200-task limit), the CLI's --time-limit for each
# (its GA takes half) and its default methods; an MoE architecture above
# that limit whose GA search is real (three pod pairs of 1-32 circuits),
# run with the GA forced onto the card for a few generations; and the
# widest registry DAG, run as one batch
CLI_ARCHS = ("granite-moe-1b-a400m", "llama-3.2-vision-11b")
CLI_TIME_LIMIT = 20.0
CLI_METHODS = ("prop-alloc", "sqrt-alloc", "iter-halve", "delta-fast")
CLI_GA_ARCH = "grok-1-314b"
CLI_GA_GENERATIONS = 3
JAMBA = "jamba-1.5-large-398b"
# [serve]: the architectures served at full published width (each fits
# one card in float32), serve.main's default shape, the two held against
# the same weights on the CPU, and the three whose decode is held against
# their full forward.  granite-moe-1b-a400m is left out of that check:
# its expert capacity C = ceil(S * 8 / 32 * 1.25) depends on the tokens
# of one call, so at full width the drops of one forward over S + 1
# tokens differ from those of a prefill plus a decode step, in the
# reference too (the reduced configs drop nothing).
SERVE_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "mamba2-130m",
               "whisper-large-v3")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 64, 32
SERVE_CPU_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m")
SERVE_CPU_REL = 1e-3
SERVE_DECODE_ARCHS = ("qwen3-0.6b", "mamba2-130m", "whisper-large-v3")
SERVE_DECODE_REL = 2e-2
# [train]: launch.train.main at qwen3-0.6b's full published width with
# the driver's defaults (batch 8, seq 128, accum 1, lr 1e-3, float32), a
# failure injected between two checkpoints; replays held at
# tests/test_training.py's rel 1e-5 (the card's atomic sums are not
# ordered); steady steps timed after it; the card against the CPU from
# one initial state (full width at a small shape, and the ten registry
# architectures reduced); the other two families at full width; and
# accumulation against one batch at tests/test_training.py's limits
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 40, 10, 25
TRAIN_REPLAY_REL = 1e-5
TRAIN_TIMED_STEPS = 5
TRAIN_CPU_SHAPE = (2, 32, 2)        # batch, seq, steps at full width
TRAIN_REDUCED_STEPS = 3
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-5, 1e-4
TRAIN_FAMILIES = ("granite-moe-1b-a400m", "mamba2-130m")
TRAIN_FAMILY_STEPS = 5
TRAIN_ACCUM = 4
TRAIN_ACCUM_LOSS_REL, TRAIN_ACCUM_PARAM_ABS = 1e-4, 5e-3
# [dist]: steps of train.main against the plain step loop; the ring's
# ranks and input (tests/test_distributed.py: seed 0, x of (4, 1000));
# the quick dry-run cells (the ten architectures reduced, two shapes, on
# the 2 x 16 x 16 mesh) and the bounds on their per-device FLOPs and
# collective bytes against the reference's; the legacy GA's depth
DIST_TRAIN_STEPS = 5
DIST_RING_RANKS, DIST_RING_SIZE = 4, 1000
DIST_QUICK_SHAPES = ("train_4k", "decode_32k")
DIST_FLOPS_BOUND, DIST_BYTES_BOUND = 1.1, 2.0
# (FLOPs, collective bytes) per device of each quick cell in the
# reference's dry run (`python -m repro.launch.dryrun --quick --mesh multi
# --shape train_4k,decode_32k`: its compiled, partitioned HLO on 512 fake
# XLA host devices; JAX does not run on the card, and
# tests/test_torch_shardplan*.py hold this table against a live run)
DIST_REF = {
    ("jamba-1.5-large-398b", "train_4k"): (2_162_540_544, 113_111_376),
    ("jamba-1.5-large-398b", "decode_32k"): (1_743_616, 85_960),
    ("yi-6b", "train_4k"): (58_720_256, 6_640_704),
    ("yi-6b", "decode_32k"): (61_440, 12_656),
    ("qwen2.5-14b", "train_4k"): (58_720_256, 6_648_920),
    ("qwen2.5-14b", "decode_32k"): (61_440, 12_656),
    ("phi3-mini-3.8b", "train_4k"): (62_914_560, 6_902_848),
    ("phi3-mini-3.8b", "decode_32k"): (65_536, 13_248),
    ("qwen3-0.6b", "train_4k"): (58_720_256, 6_641_728),
    ("qwen3-0.6b", "decode_32k"): (61_440, 12_704),
    ("mamba2-130m", "train_4k"): (41_975_808, 5_747_368),
    ("mamba2-130m", "decode_32k"): (35_328, 3_552),
    ("llama-3.2-vision-11b", "train_4k"): (169_377_792, 18_346_224),
    ("llama-3.2-vision-11b", "decode_32k"): (178_688, 31_448),
    ("whisper-large-v3", "train_4k"): (79_691_776, 12_024_952),
    ("whisper-large-v3", "decode_32k"): (337_920, 15_296),
    ("grok-1-314b", "train_4k"): (440_401_920, 22_520_896),
    ("grok-1-314b", "decode_32k"): (432_128, 29_040),
    ("granite-moe-1b-a400m", "train_4k"): (1_648_361_472, 72_852_544),
    ("granite-moe-1b-a400m", "decode_32k"): (1_611_776, 78_192),
}
DIST_QUICK_ARCHS = tuple(dict.fromkeys(a for a, _ in DIST_REF))
DIST_GA_GENERATIONS = 6
# (f): the sharded launchers' ranks and arguments, and the tolerances of
# tests/test_torch_multirank.py
DIST_MP_RANKS = 4
DIST_MP_TRAIN = ("--reduce", "--steps", "2", "--batch", "4", "--seq", "8",
                 "--log-every", "100", "--device", "cpu")
DIST_MP_SERVE = ("--reduce", "--batch", "4", "--prompt-len", "8",
                 "--decode-steps", "2", "--device", "cpu")
DIST_MP_REL, DIST_MP_LOSS_ABS, DIST_MP_PARAM_ABS = 1e-5, 1e-6, 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call, CUDA events around back-to-back calls
    (what a caller in a loop pays, launch included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(bytes_moved: float, ops: float, rate: float = F32_PEAK
             ) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate or `ops` at
    `rate`, whichever is longer, and which of the two it is."""
    t_bytes, t_ops = bytes_moved / HBM_RATE, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    card = _card()
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(card)


def _by_rule(items: list[dict]) -> str:
    counts: dict[str, int] = {}
    for it in items:
        counts[it["rule"]] = counts.get(it["rule"], 0) + 1
    return "{" + ", ".join(f"{k}: {v}" for k, v in sorted(counts.items())) \
        + "}"


def phase_sentinel() -> int:
    """The port's Sentinel over its default paths, in a process of its
    own: it must exit 0.  Returns the sanctioned host syncs inside
    TorchDES's event loop (`_LaneDES._simulate`)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"python -m repro_torch.analysis exited {run.returncode}: "
             f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
    report = json.loads(run.stdout)
    found, quiet = report["findings"], report["suppressed"]
    log(f"[sentinel] python -m repro_torch.analysis: "
        f"{report['files_analyzed']} files, {len(found)} findings "
        f"{_by_rule(found)}, {len(quiet)} suppressed inline "
        f"{_by_rule(quiet)}, {len(report['baselined'])} baselined; exit 0 "
        f"in {wall:.2f} s wall")
    loop = [q for q in quiet if q["rule"] == "RPR006"
            and q["path"].endswith("core/des_torch.py")
            and q["key"].startswith("_LaneDES._simulate:")]
    sites = ", ".join(f"{q['path']}:{q['line']}" for q in loop)
    log(f"[sentinel] sanctioned host syncs in TorchDES's event loop: "
        f"{len(loop)} ({sites})")
    if len(loop) != 1:
        fail(f"expected 1 sanctioned host sync in the event loop, the "
             f"Sentinel reports {len(loop)}")
    return len(loop)


def phase_build():
    import torch
    from repro_torch.kernels import _build
    log(f"[build] repro_torch sets tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = _build.build(*KERNELS)
    log(f"[build] {', '.join(f'{k}.cu' for k in KERNELS)} (one nvcc each, "
        f"in parallel) in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        report = [line.split(":", 1)[-1].strip() for line in
                  lib.with_suffix(".log").read_text().splitlines()
                  if "Used" in line or "spill" in line]
        log(f"[build] {lib.relative_to(ROOT)}: {'; '.join(report)}")


def _ptxas(name: str) -> str:
    """The compiler's report (registers, spills, shared memory) for each
    kernel of `csrc/<name>.cu`, from its build log."""
    from repro_torch.kernels import _build
    lines, kernel = [], None
    for line in _build.library_path(name).with_suffix(".log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:pack|square|"
                      r"maxplus|combine)_[a-z]+)(?:I(\w)E)?", line)
        if m:       # the kernel's name, and a template's type code
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif "Used" in line and kernel:
            lines.append(f"{kernel[:40]}: {line.split(':', 1)[1].strip()}")
    return "; ".join(lines)


def _check_close(name: str, got, want) -> tuple[float, float]:
    import torch
    err = (got - want).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs {max_abs:.3e}, max rel {max_rel:.3e})")
    return max_abs, max_rel


def kernel_waterfill() -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops, waterfill
    from repro_torch.kernels.ref import fill_matvec_ref, fill_round_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def w_of(c, n):
        return torch.from_numpy((rng.random((c, n))
                                 * (rng.random((c, n)) < 0.3))
                                .astype(np.float32)).to(dev)

    worst = 0.0
    for c, n in SWEEP:
        for r in (1, 2, 3):
            for batch in (None, 48):
                w = w_of(c, n)
                shape = (n, r) if batch is None else (batch, n, r)
                rhs = torch.from_numpy(rng.random(shape).astype(np.float32)
                                       ).to(dev)
                got = ops.fill_matvec(w, rhs, backend="cuda")
                torch.cuda.synchronize()
                a, _ = _check_close(f"fill_matvec C={c} N={n} R={r} "
                                    f"B={batch}", got, fill_matvec_ref(w,
                                                                       rhs))
                worst = max(worst, a)
    log(f"[kernels] fill_matvec sweep {len(SWEEP)}x3x2 cases within "
        f"rtol/atol {KERNEL_RTOL:g}: max abs err {worst:.3e}")

    # the main path's shape: a 48-lane population round on megatron-462b's
    # padded incidence (C=80 constraints, N=832 tasks), R=2 (level, unfrozen)
    B, C, N, R = 48, 80, 832, 2
    w = w_of(C, N)
    level = torch.from_numpy(rng.random((B, N)).astype(np.float32)).to(dev)
    unfrozen = torch.from_numpy((rng.random((B, N)) < 0.5)
                                .astype(np.float32)).to(dev)
    used, denom = ops.fill_round(w, level, unfrozen, backend="cuda")
    u_ref, d_ref = fill_round_ref(w, level, unfrozen)
    torch.cuda.synchronize()
    a1, r1 = _check_close("fill_round main shape (used)", used, u_ref)
    a2, r2 = _check_close("fill_round main shape (denom)", denom, d_ref)
    rhs = torch.stack([level, unfrozen], -1)
    got = ops.fill_matvec(w, rhs, backend="cuda")
    if not torch.equal(got, ops.fill_matvec(w, rhs, backend="cuda")):
        fail("fill_matvec is not bit-identical run to run")
    max_abs = max(a1, a2)
    log(f"[kernels] fill_round B={B} C={C} N={N}: max abs err "
        f"{max_abs:.3e}, max rel err {max(r1, r2):.3e}; bit-identical "
        f"rerun")

    ms = time_ms(lambda: waterfill.fill_matvec(w, rhs))
    plain_ms = time_ms(lambda: fill_matvec_ref(w, rhs))
    library_ms = time_ms(lambda: torch.matmul(w, rhs))
    round_ms = time_ms(lambda: waterfill.fill_round(w, level, unfrozen))
    b_ms, b_by = bound_ms(4.0 * (C * N + B * N * R + B * C * R),
                          2.0 * B * C * N * R)
    log(f"[kernels] fill_matvec B={B} C={C} N={N} R={R}: kernel {ms:.5f} ms"
        f"/call, plain {plain_ms:.5f}, torch.matmul {library_ms:.5f}, "
        f"fill_round (stack + kernel) {round_ms:.5f}, bound {b_ms:.6f} ms "
        f"({b_by})")
    dev_us = {name: _device_us_per_call(fn) for name, fn in (
        ("kernel", lambda: waterfill.fill_matvec(w, rhs)),
        ("plain", lambda: fill_matvec_ref(w, rhs)),
        ("torch.matmul", lambda: torch.matmul(w, rhs)))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    # the fleet's waterfill shape ([fleet] holds its own operands against
    # the plain version and times them; their device time is taken here)
    c, n, r = FLEET_MATVEC
    w, rhs = w_of(c, n), torch.from_numpy(rng.random((n, r)).astype(
        np.float32)).to(dev)
    _check_close(f"fill_matvec C={c} N={n} R={r}",
                 waterfill.fill_matvec(w, rhs), fill_matvec_ref(w, rhs))
    dev_us = {name: _device_us_per_call(fn) for name, fn in (
        ("kernel", lambda: waterfill.fill_matvec(w, rhs)),
        ("plain", lambda: fill_matvec_ref(w, rhs)),
        ("torch.matmul", lambda: torch.matmul(w, rhs)))}
    log(f"[kernels] fill_matvec at the fleet's shape C={c} N={n} R={r}: "
        f"device time per call (profiler): " + ", ".join(
            f"{k} {v}" for k, v in dev_us.items()))
    return {"name": "waterfill.fill_matvec", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def _maxmin_instance(rng, s, n, c, e, density, dev):
    """A random CSR incidence in which every task sits in a constraint
    (when E >= N), with a member axis of 1, and S lanes of active sets
    and capacities."""
    import numpy as np
    import torch
    con = np.concatenate([np.arange(min(n, e)) % c,
                          rng.integers(0, c, max(e - n, 0))])
    task = np.concatenate([np.arange(min(n, e)),
                           rng.integers(0, n, max(e - n, 0))])
    order = np.argsort(con, kind="stable")
    con_ptr = np.zeros(c + 1, dtype=np.int32)
    con_ptr[1:] = np.cumsum(np.bincount(con, minlength=c))
    tensors = (con_ptr[None], task[order].astype(np.int32)[None],
               rng.uniform(0.1, 3.0, (1, e)).astype(np.float32),
               rng.random((s, n)) < density,
               rng.uniform(0.1, 5.0, (s, c)).astype(np.float32),
               rng.uniform(1.0, 4.0, (1, n)).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(t)).to(dev)
            for t in tensors]


def _check_maxmin(name: str, args) -> tuple[float, float, list]:
    """fill_maxmin against its plain version: rates within the tolerance
    and bit-equal (both sum in one order and round every operation once),
    the same rounds on every lane."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fill_maxmin_ref
    rates, rounds = ops.fill_maxmin(*args, backend="cuda")
    want, want_rounds = fill_maxmin_ref(*args)
    torch.cuda.synchronize()
    a, r = _check_close(name, rates, want)
    _bits_equal(name, rates, want)
    if not torch.equal(rounds, want_rounds):
        fail(f"{name}: kernel rounds {rounds.tolist()} differ from the "
             f"plain version's {want_rounds.tolist()}")
    again, again_rounds = ops.fill_maxmin(*args, backend="cuda")
    if not (torch.equal(again, rates) and torch.equal(again_rounds, rounds)):
        fail(f"{name}: fill_maxmin is not bit-identical run to run")
    return a, r, rounds.tolist()


def _maxmin_at_dag(tag: str, name: str, dag, rng):
    """fill_maxmin against its plain version on `dag`'s padded CSR at
    LANES lanes of random active sets and caps, with its time, the plain
    version's, the bound and the device time per call: (max abs err, ms,
    plain ms, bound ms, what binds)."""
    import numpy as np
    import torch
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import TorchDES, _incidence_csr
    from repro_torch.kernels import waterfill
    from repro_torch.kernels.ref import fill_maxmin_ref
    dev = torch.device("cuda")
    a = TorchDES(DESProblem(dag)).arrays
    con_ptr, ent_task, ent_w = _incidence_csr(a)
    S, N, C, E = LANES, a.n, a.num_cons, ent_task.shape[1]
    real = a.task_valid[0].cpu().numpy().copy()
    real[0] = False
    active = (rng.random((S, N)) < rng.uniform(0.02, 0.5, (S, 1))) & real
    caps = np.concatenate([rng.integers(1, 5, (S, a.num_link_cons)),
                           np.ones((S, C - a.num_link_cons))], 1)
    args = [con_ptr, ent_task, ent_w, torch.from_numpy(active).to(dev),
            torch.from_numpy(caps.astype(np.float32)).to(dev), a.flows]
    max_abs, max_rel, rounds = _check_maxmin(f"fill_maxmin {name}", args)
    log(f"[{tag}] fill_maxmin S={S} N={N} C={C} E={E} ({name} CSR, max "
        f"{int((con_ptr[0, 1:] - con_ptr[0, :-1]).max())} entries per "
        f"constraint, {waterfill.maxmin_smem_bytes(N, C, E)} bytes of "
        f"shared memory per block): bit-equal to the plain version (max abs "
        f"err {max_abs:.3e}, max rel err {max_rel:.3e}); rounds per lane "
        f"{min(rounds)}-{max(rounds)} (sum {sum(rounds)}), equal to the plain"
        f" version's; bit-identical rerun")

    ms = time_ms(lambda: waterfill.fill_maxmin(*args))
    plain_ms = time_ms(lambda: fill_maxmin_ref(*args), iters=20, warmup=3)
    # bytes: the CSR, active, caps and flows read once, rates and rounds
    # written once; operations: per lane and round two FMAs per entry,
    # a subtraction, a division and a min per constraint, an add per task
    b_ms, b_by = bound_ms(
        4.0 * (C + 1) + 8.0 * E + S * N + 4.0 * S * C + 4.0 * N
        + 4.0 * S * N + 4.0 * S, sum(rounds) * (4.0 * E + 3.0 * C + N))
    log(f"[{tag}] fill_maxmin S={S} N={N} C={C} E={E}: kernel {ms:.5f} ms"
        f"/call, plain {plain_ms:.5f}, no library call, bound {b_ms:.6f} "
        f"ms ({b_by})")
    dev_us = {k: _device_us_per_call(fn, iters) for k, fn, iters in (
        ("kernel", lambda: waterfill.fill_maxmin(*args), 50),
        ("plain", lambda: fill_maxmin_ref(*args), 5))}
    log(f"[{tag}] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    return max_abs, ms, plain_ms, b_ms, b_by


def kernel_maxmin(dag, widest) -> dict:
    """The fused filling kernel against its plain version over the sweep
    and on megatron-462b's CSR at 48 lanes of random active sets and
    caps, with its time and bound; then likewise on `widest`, the widest
    registry DAG's CSR (90,916 bytes of shared memory per block)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    worst = 0.0
    for shape in MAXMIN_SWEEP:
        a, _, _ = _check_maxmin(f"fill_maxmin {shape}",
                                _maxmin_instance(rng, *shape, dev))
        worst = max(worst, a)
    log(f"[kernels] fill_maxmin sweep {len(MAXMIN_SWEEP)} shapes (S, N, C, "
        f"E, density): bit-equal to the plain version (max abs err "
        f"{worst:.3e}, rtol/atol {KERNEL_RTOL:g}), rounds equal, "
        f"bit-identical reruns")

    # the main path's shape: megatron-462b's padded CSR, 48 lanes
    max_abs, ms, plain_ms, b_ms, b_by = _maxmin_at_dag(
        "kernels", "megatron-462b", dag, rng)
    _maxmin_at_dag("kernels", JAMBA, widest, rng)
    return {"name": "waterfill.fill_maxmin", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def _stack_members(parts):
    """M one-member (con_ptr, ent_task, ent_w, flows) on one member axis."""
    import torch
    return [torch.cat([p[i] for p in parts]).contiguous() for i in range(4)]


def _member_args(dags, rng, dev):
    """fill_maxmin's operands for an ensemble's members as
    `EnsembleTorchDES` pads and stacks them: LANES genomes x M members of
    random active sets and link capacities."""
    import numpy as np
    import torch
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import EnsembleTorchDES, _incidence_csr
    a = EnsembleTorchDES([DESProblem(d) for d in dags]).arrays
    m, N, C = len(dags), a.n, a.num_cons
    S = LANES * m
    real = a.task_valid.cpu().numpy().copy()
    real[:, 0] = False
    dens = rng.uniform(0.02, 0.5, (LANES, 1, 1))
    active = ((rng.random((LANES, m, N)) < dens) & real).reshape(S, N)
    link = rng.integers(1, 5, (S, a.num_link_cons))
    caps = np.concatenate([link, np.ones((S, C - a.num_link_cons))], 1)
    return [*_incidence_csr(a), torch.from_numpy(active).to(dev),
            torch.from_numpy(caps.astype(np.float32)).to(dev), a.flows]


def kernel_maxmin_members(ensembles) -> None:
    """fill_maxmin with a member axis (lane s reads member s % M) against
    its plain version: M in {1, 2, 3} distinct random CSRs at S = M x
    {1, 5, 48}, one problem read as both members of an M = 2 launch, and
    the two megatron-462b members of each [robust] ensemble, padded to one
    shape, at S = 96 lanes, with the time and bound of the first.
    `ensembles` holds (tag, dags, whether their CSRs must differ)."""
    import numpy as np
    import torch
    from repro_torch.kernels import waterfill
    from repro_torch.kernels.ref import fill_maxmin_ref
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    n, c, e, density = MEMBER_SWEEP
    cases = 0
    for m in (1, 2, 3):
        for per in (1, 5, LANES):
            s = m * per
            parts = [_maxmin_instance(rng, s, n, c, e, density, dev)
                     for _ in range(m)]
            con_ptr, ent_task, ent_w, flows = _stack_members(
                [(p[0], p[1], p[2], p[5]) for p in parts])
            args = [con_ptr, ent_task, ent_w, parts[0][3], parts[0][4],
                    flows]
            _check_maxmin(f"fill_maxmin M={m} S={s}", args)
            if m == 1 and s % 2 == 0:   # one problem as both of M = 2
                got, rounds = waterfill.fill_maxmin(*args)
                twice, twice_rounds = waterfill.fill_maxmin(
                    *(t.expand(2, -1).contiguous() for t in args[:3]),
                    args[3], args[4], args[5].expand(2, -1).contiguous())
                if not (torch.equal(twice, got)
                        and torch.equal(twice_rounds, rounds)):
                    fail(f"fill_maxmin M=1 S={s}: one problem read as two "
                         f"members differs from the one-member launch")
            cases += 1
    log(f"[kernels] fill_maxmin members sweep: {cases} cases (M in 1-3, S "
        f"= M x 1/5/{LANES}, N={n} C={c} E={e}): bit-equal to the plain "
        f"version, rounds equal, bit-identical reruns; one problem read as "
        f"two members at S={LANES} bit-equal to its one-member launch")

    for tag, dags, must_differ in ensembles:
        args = _member_args(dags, rng, dev)
        max_abs, _, rounds = _check_maxmin(f"fill_maxmin {tag}", args)
        con_ptr, ent_task = args[0], args[1]
        m, N = con_ptr.shape[0], args[3].shape[1]
        S, C, E = args[3].shape[0], con_ptr.shape[1] - 1, ent_task.shape[1]
        distinct = not all(torch.equal(t[0], t[j]) for t in args[:3] + args[5:]
                           for j in range(m))
        if must_differ and not distinct:
            fail(f"fill_maxmin {tag}: the members' CSRs are equal")
        if distinct:
            # each member's lanes against a launch of that member alone:
            # a kernel that ignored s % M would read member 0's CSR here
            got, got_rounds = waterfill.fill_maxmin(*args)
            for j in range(m):
                one, one_rounds = waterfill.fill_maxmin(
                    *(t[j:j + 1] for t in args[:3]),
                    args[3][j::m].contiguous(), args[4][j::m].contiguous(),
                    args[5][j:j + 1])
                if not (torch.equal(one, got[j::m])
                        and torch.equal(one_rounds, got_rounds[j::m])):
                    fail(f"fill_maxmin {tag}: member {j}'s lanes differ "
                         f"from a launch of member {j} alone")
        log(f"[kernels] fill_maxmin {tag} S={S} M={m} N={N} C={C} E={E} "
            f"(tasks {[d.num_tasks for d in dags]}, member-padded; the "
            f"members' CSRs {'differ' if distinct else 'are equal'}): "
            f"bit-equal to the plain version (max abs err {max_abs:.3e}); "
            f"rounds per lane {min(rounds)}-{max(rounds)} (sum "
            f"{sum(rounds)}), equal to the plain version's; bit-identical "
            f"rerun" + ("; each member's lanes bit-equal to a launch of "
                        "that member alone" if distinct else ""))
        if tag == ensembles[0][0]:
            timed = args, rounds
    args, rounds = timed
    m, N = args[0].shape[0], args[3].shape[1]
    S, C, E = args[3].shape[0], args[0].shape[1] - 1, args[1].shape[1]
    ms = time_ms(lambda: waterfill.fill_maxmin(*args))
    plain_ms = time_ms(lambda: fill_maxmin_ref(*args), iters=20, warmup=3)
    # bytes: every member's CSR and flows, active, caps read once, rates
    # and rounds written once; operations as at the main shape
    b_ms, b_by = bound_ms(
        m * (4.0 * (C + 1) + 8.0 * E + 4.0 * N) + S * N + 4.0 * S * C
        + 4.0 * S * N + 4.0 * S, sum(rounds) * (4.0 * E + 3.0 * C + N))
    dev_us = {name: _device_us_per_call(fn, iters) for name, fn, iters in (
        ("kernel", lambda: waterfill.fill_maxmin(*args), 50),
        ("plain", lambda: fill_maxmin_ref(*args), 5))}
    log(f"[kernels] fill_maxmin {ensembles[0][0]} S={S} M={m}: kernel "
        f"{ms:.5f} ms/call "
        f"(device {dev_us['kernel']}), plain {plain_ms:.5f} ms/call "
        f"(device {dev_us['plain']}), no library call, bound {b_ms:.6f} ms "
        f"({b_by}); members check wall {time.perf_counter() - t_phase:.1f} s")


def _bits_equal(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        diff = (got != want).sum().item() if got.shape == want.shape \
            else "shape"
        fail(f"{name}: kernel is not bit-equal to its plain version "
             f"({got.dtype}{tuple(got.shape)} vs {want.dtype}"
             f"{tuple(want.shape)}, {diff} entries differ)")


def _paths_start(dag, device):
    """The matrix longest_paths squares first on megatron-462b: the
    dependency weights (float32) with the diagonal forced to 0."""
    import torch
    from repro_torch.core.pruning import dep_weights
    w = torch.from_numpy(dep_weights(dag)).to(device, torch.float32)
    return torch.maximum(w, torch.full_like(w, -1e30).fill_diagonal_(0.0))


def kernel_tclosure(dag) -> tuple[dict, int]:
    """The tclosure kernel against its plain version; returns its record
    and the squaring steps of megatron-462b's closure."""
    import numpy as np
    import torch
    from repro_torch.core.xbound import dep_adjacency
    from repro_torch.kernels import ops, tclosure
    from repro_torch.kernels.ref import tclosure_step_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = 0
    for n in TC_SIZES:
        for density in TC_DENSITIES:
            a = torch.from_numpy(rng.random((n, n)) < density).to(dev)
            for dtype in (torch.bool, torch.int8, torch.int32,
                          torch.float32):
                x = a.to(dtype)
                _bits_equal(f"tclosure_step n={n} density={density} "
                            f"{dtype}", ops.tclosure_step(x, backend="cuda"),
                            tclosure_step_ref(x))
                cases += 1
    torch.cuda.synchronize()
    log(f"[kernels] tclosure_step sweep {cases} cases (n x density x "
        f"dtype): bit-equal to the plain version")
    # the two paths of the square, on either side of the resident limit
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = max(m for m in range(1, 4096) if tclosure.plan(m, sms).resident)
    for m in (limit, limit + 1):
        path = "resident" if tclosure.plan(m, sms).resident else "streamed"
        if path != ("resident" if m == limit else "streamed"):
            fail(f"tclosure_step n={m}: plan takes the {path} path")
        a = torch.from_numpy(rng.random((m, m)) < 0.02).to(dev)
        got = ops.tclosure_step(a, backend="cuda")
        _bits_equal(f"tclosure_step n={m} ({path})", got,
                    tclosure_step_ref(a))
        if not torch.equal(got, ops.tclosure_step(a, backend="cuda")):
            fail(f"tclosure_step n={m} is not bit-identical run to run")
        log(f"[kernels] tclosure_step n={m} ({path} path, "
            f"{tclosure.plan(m, sms).smem} bytes of shared memory per "
            f"block): bit-equal to the plain version; bit-identical rerun")

    # full width: every squaring step of megatron-462b's closure
    adj = dep_adjacency(dag, dev)
    n = adj.shape[0]
    a = adj
    for steps in range(1, 2 + math.ceil(math.log2(n))):
        got = ops.tclosure_step(a, backend="cuda")
        _bits_equal(f"tclosure_step n={n} step {steps}", got,
                    tclosure_step_ref(a))
        if torch.equal(got, a):
            break
        a = got
    else:
        fail(f"tclosure_step n={n}: no fixed point in {steps} steps")
    if not torch.equal(ops.tclosure_step(adj, backend="cuda"),
                       ops.tclosure_step(adj, backend="cuda")):
        fail("tclosure_step is not bit-identical run to run")
    log(f"[kernels] tclosure_step n={n} (megatron-462b adjacency, "
        f"{int(adj.sum())} edges): {steps} steps to the fixed point, each "
        f"bit-equal to the plain version; bit-identical rerun")

    f = adj.to(torch.float32)
    # the counting product an int8 route would run: torch._int_mm needs
    # sizes that are multiples of 8, so the matrix is padded with zeros
    pad = -(-n // 8) * 8
    i8 = torch.zeros((pad, pad), dtype=torch.int8, device=dev)
    i8[:n, :n] = adj
    ms = time_ms(lambda: tclosure.tclosure_step(adj))
    plain_ms = time_ms(lambda: tclosure_step_ref(adj))
    library_ms = time_ms(lambda: torch.matmul(f, f))
    int_mm_ms = time_ms(lambda: torch._int_mm(i8, i8))
    # bool in and out; the product counted as the dense int8 product an
    # exact tensor-core version would run (2 n^3 at the int8 peak)
    b_ms, b_by = bound_ms(2.0 * n * n, 2.0 * n ** 3, INT8_PEAK)
    p = tclosure.plan(n, sms)
    path = "resident" if p.resident else "streamed"
    log(f"[kernels] tclosure_step n={n} ({path} path, {p.blocks} blocks of "
        f"{p.warps} warps, {p.smem} bytes of shared memory per block): "
        f"kernel {ms:.5f} ms/call, plain {plain_ms:.5f}, torch.matmul "
        f"(f32) {library_ms:.5f}, torch._int_mm (int8, padded to {pad}) "
        f"{int_mm_ms:.5f}, bound {b_ms:.6f} ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn) for name, fn in (
        ("kernel", lambda: tclosure.tclosure_step(adj)),
        ("plain", lambda: tclosure_step_ref(adj)),
        ("torch.matmul", lambda: torch.matmul(f, f)),
        (f"torch._int_mm padded to {pad}", lambda: torch._int_mm(i8, i8)))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    a = adj
    for step in range(1, steps + 1):
        by_kernel = _device_us_by_kernel(lambda: tclosure.tclosure_step(a))
        total = sum(by_kernel.values())
        log(f"[kernels] tclosure_step n={n} step {step} ({int(a.sum())} set "
            f"bits) device time by kernel (profiler): " + ", ".join(
                f"{k} {v:.3f} us" for k, v in by_kernel.items())
            + f"; {total:.3f} us in all, {b_ms * 1e3 / total:.4f} of the "
            f"bound")
        a = tclosure_step_ref(a)
    log(f"[kernels] tclosure ptxas: {_ptxas('tclosure')}")
    return {"name": "tclosure.tclosure_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tclosure.cu",
            "replaces": "src/repro/kernels/tclosure.py:41",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}, steps


def kernel_maxplus(dag) -> tuple[dict, int]:
    """The maxplus kernel against its plain version; returns its record
    and the squaring steps of megatron-462b's longest paths."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ops
    from repro_torch.kernels.ref import NEG_INF, maxplus_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def sparse(m, k):
        return torch.from_numpy(np.where(
            rng.random((m, k)) < 0.4, rng.random((m, k)) * 10, NEG_INF)
            .astype(np.float32)).to(dev)

    for m, k, n in MP_SHAPES:
        a, b = sparse(m, k), sparse(k, n)
        _bits_equal(f"maxplus {m}x{k}x{n}", ops.maxplus(a, b, backend="cuda"),
                    maxplus_ref(a, b))
    for m, k, n in MP_EDGES:
        a, b = sparse(m, k), sparse(k, n)
        got = ops.maxplus(a, b, backend="cuda")
        _bits_equal(f"maxplus {m}x{k}x{n}", got, maxplus_ref(a, b))
        if not torch.equal(got, ops.maxplus(a, b, backend="cuda")):
            fail(f"maxplus {m}x{k}x{n} is not bit-identical run to run")
    torch.cuda.synchronize()
    log(f"[kernels] maxplus sweep {len(MP_SHAPES)} shapes and "
        f"{len(MP_EDGES)} edges of the schedule {MP_EDGES}: bit-equal to "
        f"the plain version, bit-identical reruns")

    # full width: every squaring step of longest_paths on megatron-462b
    d0 = _paths_start(dag, dev)
    n = d0.shape[0]
    d = d0
    for steps in range(1, 2 + math.ceil(math.log2(n))):
        got = ops.maxplus(d, d, backend="cuda")
        _bits_equal(f"maxplus {n}x{n}x{n} step {steps}", got,
                    maxplus_ref(d, d))
        if torch.allclose(got, d):
            break
        d = got
    else:
        fail(f"maxplus {n}x{n}x{n}: no fixed point in {steps} squarings")
    if not torch.equal(ops.maxplus(d0, d0, backend="cuda"),
                       ops.maxplus(d0, d0, backend="cuda")):
        fail("maxplus is not bit-identical run to run")
    log(f"[kernels] maxplus {n}x{n}x{n} (megatron-462b dependency "
        f"weights): {steps} squarings to the fixed point, each bit-equal "
        f"to the plain version; bit-identical rerun")

    ms = time_ms(lambda: maxplus.maxplus(d0, d0))
    plain_ms = time_ms(lambda: maxplus_ref(d0, d0), iters=20, warmup=3)
    b_ms, b_by = bound_ms(4.0 * 3 * n * n, 2.0 * n ** 3, F32_INSTR)
    p = maxplus.plan(n, n, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log(f"[kernels] maxplus {n}x{n}x{n} ({p.tiles_m * p.tiles_n} tiles x "
        f"{p.kc} k-chunks = {p.units} units on {p.blocks} blocks, workspace "
        f"{p.blocks * p.max_seg} tiles): kernel {ms:.5f} ms/call, plain "
        f"{plain_ms:.5f}, no library call, bound {b_ms:.6f} ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn, iters) for name, fn, iters in (
        ("kernel", lambda: maxplus.maxplus(d0, d0), 50),
        ("plain", lambda: maxplus_ref(d0, d0), 5))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    by_kernel = _device_us_by_kernel(lambda: maxplus.maxplus(d0, d0))
    total = sum(by_kernel.values())
    log("[kernels] maxplus device time by kernel (profiler): " + ", ".join(
        f"{k} {v:.3f} us" for k, v in by_kernel.items())
        + f"; {total:.3f} us in all, {b_ms * 1e3 / total:.4f} of the bound")
    log(f"[kernels] maxplus ptxas: {_ptxas('maxplus')}")
    return {"name": "maxplus.maxplus", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/maxplus.cu",
            "replaces": "src/repro/kernels/maxplus.py:40",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, steps


def _trailing_kernels() -> None:
    """TRAILING_KERNELS short `spin_kernel`s, waited for, at the end of a
    trace whose kernels are counted: on an H100 a trace can lose the
    records of its last moments when the profiler stops (at times a
    fifth of a fitness batch's fill_maxmin records), and these take that
    loss in place of the counted call's."""
    import torch
    for _ in range(TRAILING_KERNELS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _profile(fn):
    """A torch.profiler trace (host and device) of one call of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _busy_s(prof) -> float:
    """Seconds the device spent in kernels and copies in a trace (0.0 when
    it holds no device time), summed over the profiler's raw events: the
    event tree that `prof.events()` builds takes tens of seconds for a
    trace of a fitness batch's ~130,000 kernels.  `_trailing_kernels`'
    spin kernels are not counted."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return 1e-9 * sum(ev.end_ns() - ev.start_ns()
                      for ev in prof.profiler.kineto_results.events()
                      if ev.device_type() == cuda and not ev.is_async()
                      and "spin_kernel" not in ev.name())


def _device_profile(fn, trailing: bool = False):
    """fn()'s result and a trace of the call on the device alone (no
    host-side events, so the traced call costs little more than the call
    itself), with `_trailing_kernels` after it where `trailing`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
        if trailing:
            _trailing_kernels()
    return out, prof


def _kernels_in(prof, name: str) -> int:
    """The kernels in a trace whose name holds `name`, over the
    profiler's raw events (each kernel of a replayed CUDA graph is one)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return sum(name in ev.name()
               for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == cuda)


def _traced_launches(tag: str, prof, c: dict, what: str = "traced run"
                     ) -> int:
    """fill_maxmin's kernels in the device trace `prof` of a fused-path
    run against the trips the device ran in it and against the host's
    launches and replays (`c`, the run's counts from zero); returns the
    kernels counted."""
    kernels = _kernels_in(prof, "fill_maxmin_kernel")
    ran = c["trips"] + c["idle"]
    log(f"[{tag}] {what}: {kernels} fill_maxmin kernels in the device "
        f"trace; the device ran {ran:.0f} trips ({c['trips']:.0f} with a "
        f"lane running, {c['idle']:.0f} idle); the host launched "
        f"{c['host']} and replayed {c['replays']} graphs; "
        f"{_kernels_in(prof, 'spin_kernel')} of {TRAILING_KERNELS} trailing "
        f"kernels recorded")
    if kernels == 0 or kernels != ran or kernels != c["maxmin"]:
        fail(f"{tag}: {kernels} fill_maxmin kernels traced, {ran:.0f} "
             f"trips run, {c['maxmin']} launched or replayed")
    return kernels


def _traced_batch(tag: str, fn) -> float:
    """The device's busy seconds in a rerun of fused-path batch `fn`
    traced on the device alone, with its fill_maxmin kernels checked
    (`_traced_launches`)."""
    _reset_counts()
    _, prof = _device_profile(fn, trailing=True)
    _traced_launches(tag, prof, _counts())
    return _busy_s(prof)


def _host_syncs(fn) -> int:
    """Host syncs during one call of `fn`: the warnings of
    torch.cuda.set_sync_debug_mode("warn"), each one counted (not the
    notice, given once per process, that the mode is a prototype)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _device_us_per_call(fn, iters: int = 50) -> str:
    """Device microseconds per call of `fn` from a trace of `iters` calls,
    or "not measured" when the trace holds fewer device events than calls
    (every call launches at least one kernel, so the trace lost some)."""
    import torch
    prof = _profile(lambda: [fn() for _ in range(iters)])
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    if len(events) < iters:
        return "not measured"
    busy_s = 1e-6 * sum(ev.device_time_total for ev in events)
    return f"{busy_s * 1e6 / iters:.3f} us"


def _device_us_by_kernel(fn, iters: int = 50) -> dict[str, float]:
    """Device microseconds per call of `fn`, by kernel name, from a
    torch.profiler trace of `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            m = re.search(r"::(\w+)", ev.key)   # drop namespaces and types
            out[m.group(1) if m else ev.key[:40]] = \
                ev.device_time_total / iters
    return out


def _megatron_462b(seq_len: int = 4096, microbatches: int = 128):
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.schedule import build_comm_dag
    job = make_job(PAPER_WORKLOADS["megatron-462b"], seq_len=seq_len,
                   microbatches=microbatches)
    dag = build_comm_dag(job, 400.0)
    n, deps, pods = dag.num_tasks, len(dag.deps), dag.cluster.num_pods
    log(f"[des] megatron-462b Table I at seq_len {seq_len}: "
        f"{job.tp * job.pp * job.dp} GPUs, {job.num_microbatches} "
        f"microbatches, {n} tasks, {deps} deps, {pods} pods")
    want = {128: (801, 88096, 32), 64: (417, 23584, 32)}[microbatches]
    if (n, deps, pods) != want:
        fail(f"megatron-462b DAG is ({n}, {deps}, {pods}), expected {want}")
    return dag


def _counts():
    """The launch and trip counts since `_reset_counts`: `maxmin` is
    fill_maxmin's launches made from the host (`host`) and GRAPH_TRIPS per
    trip-graph replay; `trips` and `idle` are counted on the device."""
    from repro_torch.core.des_torch import GRAPH_TRIPS
    from repro_torch.kernels import waterfill
    from repro_torch.obs import REGISTRY
    replays = int(REGISTRY.counter("des_graph_replays_total").value())
    return {"launches": waterfill.launches,
            "maxmin": waterfill.maxmin_launches + GRAPH_TRIPS * replays,
            "host": waterfill.maxmin_launches, "replays": replays,
            "trips": REGISTRY.counter("des_event_trips_total").value(),
            "idle": REGISTRY.counter("des_graph_idle_trips_total").value(),
            "rounds": REGISTRY.counter("des_fill_rounds_total").value()}


def _reset_counts() -> None:
    from repro_torch.kernels import maxplus, tclosure, waterfill
    from repro_torch.obs import REGISTRY
    waterfill.launches = waterfill.maxmin_launches = 0
    tclosure.launches = maxplus.launches = 0
    REGISTRY.counter("des_event_trips_total").reset()
    REGISTRY.counter("des_graph_idle_trips_total").reset()
    REGISTRY.counter("des_graph_replays_total").reset()
    REGISTRY.counter("des_fill_rounds_total").reset()


def _check_path(name: str, c: dict) -> None:
    """The launch counts of one DES run on `name`'s path: the fused path
    launches fill_maxmin, from the host or in a replay, once per trip the
    device ran (the trips in which some lane ran and the idle ones after
    every lane had stopped) and fill_round never; the per-round path fill_round once per round
    and fill_maxmin never; the plain path neither."""
    if name == "ref":
        if c["maxmin"] or c["launches"] or c["trips"] == 0:
            fail(f"plain path: {c['maxmin']} fill_maxmin and "
                 f"{c['launches']} fill_round launches")
    elif name == "cuda":
        if c["maxmin"] != c["trips"] + c["idle"] or c["trips"] == 0 \
                or c["launches"] != 0:
            fail(f"fused path: {c['maxmin']} fill_maxmin launches for "
                 f"{c['trips']:.0f} trips and {c['launches']} fill_round "
                 f"launches")
    elif c["launches"] != c["rounds"] or c["launches"] == 0 \
            or c["maxmin"] != 0:
        fail(f"per-round path: {c['launches']} fill_round launches for "
             f"{c['rounds']:.0f} filling rounds and {c['maxmin']} "
             f"fill_maxmin launches")


def _trip_ops(prof, trips: float, wall_s: float, top: int = 16) -> None:
    """The host's torch ops of one profiled run, by self CPU time, per
    trip (torch.profiler's CPU side; its own cost inflates the times, and
    what is not a torch op -- Python, the ctypes launch -- is the rest of
    the wall time), and the device's kernels of the same run."""
    import torch
    rows = [(ev.key, ev.count, ev.self_cpu_time_total)
            for ev in prof.key_averages() if ev.count]
    rows.sort(key=lambda r: -r[2])
    total_us = sum(r[2] for r in rows)
    calls = sum(r[1] for r in rows if r[0].startswith("aten::"))
    log(f"[des] host ops of one fused batch per trip (torch.profiler CPU "
        f"side, {trips:.0f} trips, {wall_s * 1e6 / trips:.2f} us of "
        f"profiled wall time per trip): {calls / trips:.2f} aten ops "
        f"(nested ones included), {total_us / trips:.2f} us self CPU time "
        f"in all")
    for key, count, self_us in rows[:top]:
        log(f"[des]   {key[:48]:48s} {count / trips:7.2f} calls "
            f"{self_us / trips:9.3f} us")
    # device-side events only: a CPU op's entry carries its kernels' time
    kernels = [(ev.key, ev.count, ev.device_time_total)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda r: -r[2])
    log(f"[des] device time of one fused batch per trip by kernel "
        f"(torch.profiler): {sum(k[2] for k in kernels) / trips:.2f} us in "
        f"{sum(k[1] for k in kernels) / trips:.2f} kernels and copies")
    for key, count, dev_us in kernels[:10]:
        name = re.split(r"[<(]", key.replace("(anonymous namespace)::", "")
                        )[0].split("::")[-1].strip() or key
        log(f"[des]   {name[:48]:48s} {count / trips:7.2f} calls "
            f"{dev_us / trips:9.3f} us")


def phase_des(dag, loop_syncs: int) -> None:
    """The DES at full width on the fused, per-round and plain paths."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.baselines import BASELINES
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.des_torch import DESOptions, TorchDES
    from repro_torch.core.ga import TopologySpace

    prob = DESProblem(dag)
    engines = {}
    for name in ("cuda", "cuda-round", "ref"):
        t0 = time.perf_counter()
        des = TorchDES(prob, options=DESOptions(backend=name))
        log(f"[des] TorchDES device {des.device} backend {des.backend} pad "
            f"{tuple(des.pad)} built in {time.perf_counter() - t0:.2f} s")
        if des.backend != name:
            fail(f"TorchDES took backend {des.backend!r}, not {name!r}")
        engines[name] = des
    if TorchDES(prob).backend != "cuda":
        fail("TorchDES on the card does not default to the fused kernel")
    for base in ("prop-alloc", "sqrt-alloc"):
        x = BASELINES[base](dag)
        t0 = time.perf_counter()
        want = simulate(prob, x)
        t_np = time.perf_counter() - t0
        got = {}
        for name, des in engines.items():
            _reset_counts()         # this path's counts start at 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with obs.enabled():     # the rounds count while tracing is on
                ms, feas, _, _ = des.simulate(x)
            t_dev = time.perf_counter() - t0
            c = _counts()
            rel = abs(ms - want.makespan) / want.makespan
            log(f"[des] {base} ({int(x.sum())} ports) on {name}: numpy "
                f"{want.makespan!r} ({t_np:.3f} s), torch {ms!r} ({t_dev:.3f}"
                f" s), rel {rel:.3e}; {c['trips']:.0f} trips, "
                f"{c['rounds']:.0f} rounds, {c['maxmin']} fill_maxmin and "
                f"{c['launches']} fill_round launches")
            if feas != want.feasible or not rel <= DES_RTOL:
                fail(f"{base} on {name}: torch DES {ms} vs numpy "
                     f"{want.makespan} (rel {rel:.3e} > {DES_RTOL:g})")
            _check_path(name, c)
            got[name] = (ms, c["rounds"])
        # the fused kernel and its plain version give the same bits, so
        # the same makespan and rounds; the per-round kernel sums in
        # another order
        if got["cuda"] != got["ref"]:
            fail(f"{base}: fused path {got['cuda']} vs its plain version "
                 f"{got['ref']} (makespan, rounds) on the card")
        rel = abs(got["cuda"][0] - got["cuda-round"][0]) / got["cuda"][0]
        log(f"[des] {base}: fused == plain (makespan and rounds); fused vs "
            f"per-round makespan rel {rel:.3e}, rounds {got['cuda'][1]:.0f} "
            f"vs {got['cuda-round'][1]:.0f}")
        if not rel <= KERNEL_RTOL:
            fail(f"{base}: fused path {got['cuda']} vs per-round path "
                 f"{got['cuda-round']} (makespan, rounds), rel {rel:.3e}")

    # a 48-genome fitness batch in turns: round, fused, fused, round
    space = TopologySpace(dag)
    genomes = space.random_init_batch(np.random.default_rng(0), LANES)
    results = {}
    for turn, name in enumerate(("cuda-round", "cuda", "cuda", "cuda-round"),
                                1):
        des = engines[name]

        def batch():
            return des.batch_genome_makespan(genomes, space.edge_u,
                                             space.edge_v)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.enabled():         # the rounds count while tracing is on
            ms_b, feas_b = batch()
        wall = time.perf_counter() - t0
        c = _counts()
        _check_path(name, c)
        # the first fused turn's rerun is traced on the host and the
        # device (the trip's host ops below); the others' on the device
        # alone, whose trace costs far less to record and read
        first_fused = name == "cuda" and name not in results
        _reset_counts()             # the profiled rerun's counts
        t0 = time.perf_counter()
        if first_fused:
            prof = _profile(batch)
            prof_wall = time.perf_counter() - t0
        else:
            _, prof = _device_profile(batch, trailing=name == "cuda")
        busy = _busy_s(prof)
        if name == "cuda" and not first_fused:
            _traced_launches("des", prof, _counts(),
                             f"turn {turn} profiled rerun")
        counter = obs.REGISTRY.counter("des_host_syncs_total")
        before = counter.value()
        syncs = _host_syncs(batch)
        counted = counter.value() - before
        trips = c["trips"]
        log(f"[des] turn {turn} {name}: 48-genome batch {wall:.4f} s wall "
            f"({wall * 1e3 / c['trips']:.4f} ms per trip); "
            f"device busy {busy:.4f} s (profiled rerun), idle share "
            + (f"{1.0 - busy / wall:.4f}" if busy else "not measured")
            + f"; {syncs} host syncs in {trips:.0f} trips, "
            f"{syncs / trips:.3f} per trip (sanctioned sync sites in the "
            f"event loop, [sentinel]: {loop_syncs}; des_host_syncs_total "
            f"{counted:.0f} in the same call); {c['rounds']:.0f} rounds, "
            f"{c['maxmin']} fill_maxmin, {c['launches']} fill_round launches")
        if first_fused:
            _trip_ops(prof, trips, prof_wall)
        results.setdefault(name, []).append((ms_b, feas_b))
    (ms_f, feas_f), (ms_r, feas_r) = results["cuda"][0], \
        results["cuda-round"][0]
    ok = feas_f & feas_r
    worst = float((np.abs(ms_f[ok] - ms_r[ok]) / ms_r[ok]).max()) \
        if ok.any() else 0.0
    log(f"[des] fused vs per-round batch: max rel diff {worst:.3e} "
        f"({int(ok.sum())} of {LANES} feasible on both)")
    if not np.array_equal(feas_f, feas_r) or not worst <= KERNEL_RTOL:
        fail(f"fused and per-round batches differ: rel {worst:.3e}")
    for name, runs in results.items():
        if not all(np.array_equal(m, runs[0][0]) for m, _ in runs):
            fail(f"{name}: two batches of one seed gave other makespans")

    des = engines["cuda"]
    t0 = time.perf_counter()
    worst = 0.0
    picked = range(0, LANES, SINGLES_STRIDE)
    for i, x in zip(picked, space.to_matrix_batch(genomes[::SINGLES_STRIDE])):
        ms, feas, _, _ = des.simulate(x)
        if feas != bool(feas_f[i]):
            fail(f"genome {i}: batched feasible {feas_f[i]}, single {feas}")
        if feas:
            worst = max(worst, abs(ms - ms_f[i]) / ms)
    t_single = time.perf_counter() - t0
    log(f"[des] {len(picked)} single calls (every {SINGLES_STRIDE}th "
        f"genome of the batch) {t_single:.2f} s; max rel diff from the "
        f"batch {worst:.3e} ({int(feas_f.sum())} of {LANES} feasible in the "
        f"batch)")
    if not worst <= 1e-6:
        fail(f"batched makespans differ from single ones by rel {worst}")


def phase_plan(dag) -> tuple[int, int, object]:
    """plan(delta-fast) at full width on the fused path, on the per-round
    path, and on the fused path again, traced on the device; returns the
    fill_maxmin kernels in the trace of the last fused run, the
    fill_round launches of the per-round run and the fused runs'
    topology."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions

    results = {}
    for run, name in enumerate(("cuda", "cuda-round", "cuda"), 1):
        obs.TRACER.clear()
        _reset_counts()             # this path's counts start at 0
        req = PlanRequest(
            dag=dag, method="delta-fast",
            ga_options=GAOptions(seed=0, pop_size=48, max_generations=5,
                                 patience=60, time_limit=1e9),
            # the fused runs take the default, which is the fused path
            des_options=DESOptions(backend="auto" if name == "cuda"
                                   else name))
        t0 = time.perf_counter()
        with obs.enabled():
            if run == 3:            # traced on the device
                res, prof = _device_profile(lambda: plan(req),
                                            trailing=True)
            else:
                res = plan(req)
        wall = time.perf_counter() - t0
        c = _counts()
        if run == 3:
            traced = _traced_launches(
                "plan", prof, c, f"run {run} traced on the device (its wall "
                f"time includes the trace)")
        spans = obs.TRACER.summary()
        gens = res.details["generations"]
        batches = spans["ga.fitness_batch"]["count"]
        gen_s = spans["ga.generation"]["total_s"] / max(gens, 1)
        log(f"[plan] run {run} on {name}: makespan {float(res.makespan)!r} "
            f"s, NCT {float(res.nct)!r}, {res.total_ports} ports, {gens} "
            f"generations, {res.details['evaluations']} evaluations, plan "
            f"{wall:.2f} s, {gen_s:.3f} s/generation")
        log(f"[plan] run {run} on {name}: {batches} fitness batches, per "
            f"batch {c['trips'] / batches:.1f} trips, "
            f"{c['rounds'] / batches:.1f} rounds, "
            f"{c['maxmin'] / batches:.1f} fill_maxmin and "
            f"{c['launches'] / batches:.1f} fill_round launches; totals "
            f"{c['trips']:.0f} / {c['rounds']:.0f} / {c['maxmin']} / "
            f"{c['launches']}")
        log(f"[plan] run {run} on {name}: x has {res.total_ports} ports, "
            f"makespan {float(res.makespan)!r} s (recorded on the per-round "
            f"path: {ROUND_PATH_PORTS} ports, {ROUND_PATH_MAKESPAN!r} s)")
        if gens != 5 or not res.feasible or not np.isfinite(res.makespan) \
                or not 0.0 < res.nct < np.inf:
            fail(f"plan run {run} on {name}: generations {gens}, feasible "
                 f"{res.feasible}, makespan {res.makespan}, nct {res.nct}")
        _check_path(name, c)
        results.setdefault(name, []).append((res, c))
    (a, _), (b, _) = results["cuda"]
    if not np.array_equal(a.x, b.x) or a.makespan != b.makespan:
        fail("plan() gave different topologies on two runs with one seed")
    r, cr = results["cuda-round"][0]
    log(f"[plan] two fused runs: identical x and makespan; the per-round "
        f"run's x is {'identical' if np.array_equal(a.x, r.x) else 'other'}"
        f" (makespan {float(r.makespan)!r} s)")
    return traced, cr["launches"], a.x


def phase_small_parity() -> None:
    """The GA at a small size on the card's kernel and on the CPU's plain
    path: same seed, same topology."""
    import numpy as np
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions
    from repro_torch.core.schedule import build_comm_dag
    dag = build_comm_dag(make_job(PAPER_WORKLOADS["gpt-7b"]), 400.0)
    kw = dict(seed=0, pop_size=16, max_generations=6, patience=60,
              time_limit=1e9)
    card = plan(PlanRequest(dag=dag, ga_options=GAOptions(**kw)))
    cpu = plan(PlanRequest(dag=dag, ga_options=GAOptions(**kw),
                           des_options=DESOptions(device="cpu")))
    same = bool(np.array_equal(card.x, cpu.x))
    rel = abs(card.makespan - cpu.makespan) / cpu.makespan
    log(f"[plan] gpt-7b ({dag.num_tasks} tasks): card {card.makespan!r}, "
        f"cpu {cpu.makespan!r}, rel {rel:.3e}, identical x {same}")
    if not rel <= DES_RTOL or not same:
        fail(f"gpt-7b plan on the card {card.makespan} vs the CPU "
             f"{cpu.makespan}, identical x {same}")


def phase_xbound(dag, steps: int) -> tuple[int, float]:
    """Alg. 2 with the closure by matrix squaring on the card against the
    bitset closure, each run launching one kernel per squaring step;
    returns the tclosure launches of the x_upper_bound run and the t_up
    both runs share."""
    import numpy as np
    from repro_torch.core.des import DESProblem
    from repro_torch.core.pruning import estimate_t_up
    from repro_torch.core.xbound import (reachability_bitset,
                                         reachability_kernel, x_upper_bound)
    from repro_torch.kernels import tclosure

    _reset_counts()
    t0 = time.perf_counter()
    reach = reachability_kernel(dag)
    t_kernel = time.perf_counter() - t0
    launches = tclosure.launches
    t0 = time.perf_counter()
    want = reachability_bitset(dag)
    t_bitset = time.perf_counter() - t0
    log(f"[xbound] reachability n={dag.num_tasks}: kernel {t_kernel:.4f} s "
        f"({launches} tclosure launches, {steps} squaring steps), bitset "
        f"{t_bitset:.4f} s; {int(want.sum())} reachable pairs")
    if not np.array_equal(reach, want):
        fail(f"reachability on the kernel differs from the bitset in "
             f"{int((reach != want).sum())} pairs")
    if launches != steps:
        fail(f"reachability: {launches} tclosure launches for {steps} "
             f"squaring steps")

    t_up = estimate_t_up(DESProblem(dag))
    _reset_counts()             # the slice's path: its counts start at 0
    t0 = time.perf_counter()
    xbar = x_upper_bound(dag, t_up, closure_backend="kernel")
    t_kernel = time.perf_counter() - t0
    launches = tclosure.launches
    t0 = time.perf_counter()
    xbar_bitset = x_upper_bound(dag, t_up, closure_backend="bitset")
    t_bitset = time.perf_counter() - t0
    log(f"[xbound] x_upper_bound t_up {t_up!r} s: kernel closure "
        f"{t_kernel:.3f} s ({launches} tclosure launches), bitset "
        f"{t_bitset:.3f} s; X-bar sums to {int(xbar.sum())}")
    if not np.array_equal(xbar, xbar_bitset):
        fail("X-bar on the kernel closure differs from X-bar on the bitset")
    if launches != steps:
        fail(f"x_upper_bound: {launches} tclosure launches for {steps} "
             f"squaring steps")
    return launches, t_up


def phase_paths(dag, t_up: float, steps: int) -> int:
    """All-pairs longest paths by max-plus squaring on the card, one
    launch per squaring step: row VIRTUAL against Alg. 4's EST, and the
    Bellman check at n = 24; returns the maxplus launches of the
    longest_paths run."""
    import numpy as np
    import torch
    from repro_torch.core.dag import VIRTUAL
    from repro_torch.core.pruning import cal_task_time_windows, dep_weights
    from repro_torch.kernels import maxplus, ops
    from repro_torch.kernels.ref import NEG_INF

    w = torch.from_numpy(dep_weights(dag)).to("cuda", torch.float32)
    est, _ = cal_task_time_windows(dag, t_up)
    _reset_counts()             # the slice's path: its counts start at 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = ops.longest_paths(w)
    torch.cuda.synchronize()
    t_lp = time.perf_counter() - t0
    launches = maxplus.launches
    row = lp[VIRTUAL].double().cpu().numpy()
    err = float(np.abs(row - est).max())
    atol = 1e-5 * float(est.max())
    log(f"[paths] longest_paths n={dag.num_tasks}: {launches} maxplus "
        f"launches, {steps} squaring steps, {t_lp:.4f} s; row VIRTUAL vs "
        f"Alg. 4 EST: max abs err {err:.3e} (atol {atol:.3e}, max EST "
        f"{float(est.max())!r} s)")
    if not (row > NEG_INF / 2).all() or not err <= atol:
        fail(f"longest_paths row VIRTUAL differs from the EST by {err} "
             f"(> {atol}) or leaves a task unreached")
    if launches != steps:
        fail(f"longest_paths: {launches} maxplus launches for {steps} "
             f"squaring steps")

    # the Bellman check of tests/test_kernels.py:59-76
    n = 24
    rng = np.random.default_rng(24)
    adj_mask = np.triu(rng.random((n, n)) < 0.2, k=1)
    adj = np.where(adj_mask, rng.random((n, n)) * 5, NEG_INF) \
        .astype(np.float32)
    got = ops.longest_paths(torch.from_numpy(adj).cuda()).cpu().numpy()
    dist = np.where(np.eye(n, dtype=bool), 0.0, NEG_INF)
    for _ in range(n):
        nd = dist.copy()
        for i, j in zip(*np.nonzero(adj_mask)):
            nd[:, j] = np.maximum(nd[:, j], dist[:, i] + adj[i, j])
        dist = nd
    mask = dist > NEG_INF / 2
    if not np.allclose(got[mask], dist[mask], rtol=1e-5) \
            or not (got[~mask] <= NEG_INF / 2 + 1).all():
        fail("longest_paths on the card disagrees with the Bellman loop")
    log(f"[paths] Bellman check n={n}: longest_paths on the card agrees "
        f"(rtol 1e-5)")
    return launches


def _trips_and_launches(tag: str, c: dict, batches: int) -> None:
    """The fused path's counts of one run: one fill_maxmin launch per
    trip, no fill_round launch, and some trips at all."""
    log(f"[{tag}] {batches} fitness batches: {c['trips']:.0f} trips, "
        f"{c['maxmin']} fill_maxmin launches, {c['launches']} fill_round "
        f"launches; per batch {c['trips'] / max(batches, 1):.1f} trips and "
        f"{c['maxmin'] / max(batches, 1):.1f} launches")
    if c["maxmin"] != c["trips"] + c["idle"] or c["maxmin"] == 0 \
            or c["launches"]:
        fail(f"{tag}: {c['maxmin']} fill_maxmin launches for "
             f"{c['trips']:.0f} trips, {c['launches']} fill_round launches")


def _robust_ga(generations: int):
    from repro_torch.core.ga import GAOptions
    return GAOptions(seed=0, pop_size=LANES, max_generations=generations,
                     patience=60, time_limit=1e9)


def _evolve_gen_s(kind: str) -> tuple[float, int]:
    """Seconds per generation of the GA run `kind` (its ga.generation
    spans inside its ga.evolve span) and its generations."""
    from repro_torch import obs
    recs = obs.TRACER.records
    ev = [r for r in recs if r.name == "ga.evolve"
          and r.attrs.get("kind") == kind]
    if len(ev) != 1:
        fail(f"expected one ga.evolve span of {kind}, found {len(ev)}")
    t0, t1 = ev[0].t0, ev[0].t0 + ev[0].dur
    gens = [r.dur for r in recs if r.name == "ga.generation"
            and t0 <= r.t0 <= t1]
    return sum(gens) / max(len(gens), 1), len(gens)


def _engine_batch(tag: str, eng, space, masks=None) -> None:
    """One fitness batch of LANES random genomes on ensemble engine `eng`
    (LANES x M lanes): wall time, trips and launches, then the device's
    busy time and idle share in a rerun traced on the device alone."""
    import numpy as np
    import torch
    genomes = space.random_init_batch(np.random.default_rng(0), LANES)

    def batch():
        return eng.ensemble_genome_makespan(genomes, space.edge_u,
                                            space.edge_v, masks)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, feas = batch()
    wall = time.perf_counter() - t0
    c = _counts()
    busy = _traced_batch(tag, batch)
    log(f"[{tag}] one batch of {LANES} genomes x {eng.M} members "
        f"({LANES * eng.M} lanes) on EnsembleTorchDES: {wall:.3f} s, "
        f"{c['trips']:.0f} trips ({wall * 1e3 / c['trips']:.3f} ms per "
        f"trip), {c['maxmin']} fill_maxmin launches, {int(feas.sum())} of "
        f"{feas.size} lanes feasible; device busy {busy:.4f} s (rerun traced "
        f"on the device, {busy * 1e3 / c['trips']:.4f} ms per trip), idle "
        f"share "
        + (f"{1.0 - busy / wall:.4f}" if busy else "not measured"))
    if c["maxmin"] != c["trips"] + c["idle"] or c["maxmin"] == 0:
        fail(f"{tag} batch: {c['maxmin']} launches for {c['trips']} trips")


def phase_robust(dags, mb_dags):
    """plan(delta-robust, max-regret) of megatron-462b at two sequence
    lengths, refs by the facade's delta-fast; then one 96-lane batch of
    the ensemble engine alone and the winner on the card against the
    numpy DES; then delta_robust on megatron-462b at two microbatch
    counts, whose members differ in structure, and its winner likewise.
    Returns the sequence-length ensemble."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.dag import DagEnsemble
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import EnsembleTorchDES
    from repro_torch.core.ga import TopologySpace, delta_robust

    t_phase = time.perf_counter()
    ens = DagEnsemble(list(dags), names=[f"seq{s}" for s in
                                         ROBUST_SEQ_LENS])
    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    with obs.enabled():
        res = plan(PlanRequest(ensemble=ens, method="delta-robust",
                               objective="max-regret",
                               ga_options=_robust_ga(ROBUST_GENERATIONS)))
    wall = time.perf_counter() - t0
    c = _counts()
    spans = obs.TRACER.summary()
    gen_s, gens = _evolve_gen_s("delta_robust")
    log(f"[robust] plan(delta-robust, max-regret) {len(ens.members)} "
        f"members x {LANES} genomes: {wall:.2f} s (refs by delta-fast "
        f"{res.details['refs_s']:.2f} s), robust GA {gens} generations at "
        f"{gen_s:.3f} s/generation, {res.details['evaluations']} "
        f"evaluations")
    log(f"[robust] refs {res.refs.tolist()}, makespans "
        f"{res.makespans.tolist()}, regrets {res.regrets.tolist()}, worst "
        f"regret {res.worst_regret!r}, {res.total_ports} ports")
    _trips_and_launches("robust", c, spans["ga.fitness_batch"]["count"])
    if gens != ROBUST_GENERATIONS or not res.feasible \
            or not np.isfinite(res.regrets).all() \
            or not res.worst_regret >= 1.0 - 1e-9:
        fail(f"robust plan: generations {gens}, feasible {res.feasible}, "
             f"regrets {res.regrets}")

    # the ensemble engine alone: one 96-lane batch, then the winner
    eng = EnsembleTorchDES([DESProblem(d) for d in dags])
    _engine_batch("robust", eng, TopologySpace.for_ensemble(ens))
    got, feas = eng.makespans(res.x)
    rel = np.abs(got - res.makespans) / res.makespans
    log(f"[robust] winner on the card {got.tolist()} vs the numpy DES "
        f"{res.makespans.tolist()}: rel {rel.tolist()}")
    if not feas.all() or not (rel <= DES_RTOL).all():
        fail(f"robust winner: card {got} vs numpy {res.makespans}")

    # members that differ in structure, padded to one shape: the lanes of
    # each batch read two different CSRs
    mb = DagEnsemble(list(mb_dags),
                     names=[f"mb{m}" for m in ROBUST_MICROBATCHES])
    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    with obs.enabled():
        rob = delta_robust(mb, _robust_ga(ROBUST_MB_GENERATIONS),
                           objective="weighted", refs=np.ones(2))
    wall = time.perf_counter() - t0
    c = _counts()
    spans = obs.TRACER.summary()
    gen_s, gens = _evolve_gen_s("delta_robust")
    log(f"[robust] delta_robust(weighted) of megatron-462b at "
        f"{'/'.join(map(str, ROBUST_MICROBATCHES))} microbatches "
        f"({[d.num_tasks for d in mb_dags]} tasks) x {LANES} genomes: "
        f"{wall:.2f} s, {gens} generations at {gen_s:.3f} s/generation, "
        f"makespans {rob.makespans.tolist()}, {rob.total_ports} ports")
    _trips_and_launches("robust", c, spans["ga.fitness_batch"]["count"])
    eng = EnsembleTorchDES([DESProblem(d) for d in mb_dags])
    if not eng.pad.n > min(d.num_tasks for d in mb_dags) \
            or gens != ROBUST_MB_GENERATIONS or not rob.feasible:
        fail(f"robust microbatch pair: pad {eng.pad}, generations {gens}, "
             f"feasible {rob.feasible}")
    got, feas = eng.makespans(rob.x)
    rel = np.abs(got - rob.makespans) / rob.makespans
    log(f"[robust] winner on the card {got.tolist()} vs the numpy DES "
        f"{rob.makespans.tolist()}: rel {rel.tolist()} (members padded to "
        f"{eng.pad.n} tasks)")
    if not feas.all() or not (rel <= DES_RTOL).all():
        fail(f"robust microbatch winner: card {got} vs numpy "
             f"{rob.makespans}")
    log(f"[robust] phase wall {time.perf_counter() - t_phase:.1f} s")
    return ens


def _failsafe_scenarios(dag, top: int = 3, planes: int = 4):
    """The healthy fabric, then 1 of `planes` planes dark on each of the
    `top` pod pairs that carry the most volume (ties by pair)."""
    import numpy as np
    vol: dict[tuple[int, int], float] = {}
    for t in dag.real_tasks():
        pair = tuple(sorted(t.pair))
        vol[pair] = vol.get(pair, 0.0) + t.volume
    pairs = sorted(vol, key=lambda p: (-vol[p], p))[:top]
    P = dag.cluster.num_pods
    out = [np.ones((P, P))]
    for i, j in pairs:
        m = np.ones((P, P))
        m[i, j] = m[j, i] = (planes - 1) / planes
        out.append(m)
    return out, pairs


def phase_failsafe(dag) -> None:
    """plan() of megatron-462b under four fabric scenarios on the card,
    its scenario makespans on the card against the numpy DES; then gpt-7b
    under the default scenarios on the card and on the CPU."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.api import FailureModel, PlanRequest, plan
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import DESOptions, EnsembleTorchDES
    from repro_torch.core.ga import GAOptions, TopologySpace
    from repro_torch.core.schedule import build_comm_dag

    t_phase = time.perf_counter()
    scen, pairs = _failsafe_scenarios(dag)
    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    with obs.enabled():
        res = plan(PlanRequest(dag=dag, failure=FailureModel(scenarios=scen),
                               ga_options=_robust_ga(ROBUST_GENERATIONS)))
    wall = time.perf_counter() - t0
    c = _counts()
    spans = obs.TRACER.summary()
    gen_s, gens = _evolve_gen_s("delta_failsafe")
    worst = res.details["scenario_makespans"]
    log(f"[failsafe] megatron-462b, {len(scen)} scenarios (healthy, 1 of 4 "
        f"planes dark on pairs {pairs}) x {LANES} genomes = "
        f"{len(scen) * LANES} lanes: {wall:.2f} s, {gens} generations at "
        f"{gen_s:.3f} s/generation; makespan {res.makespan!r}, scenario "
        f"makespans {worst}, {res.total_ports} ports")
    _trips_and_launches("failsafe", c, spans["ga.fitness_batch"]["count"])
    if gens != ROBUST_GENERATIONS or not res.feasible:
        fail(f"failsafe plan: generations {gens}, feasible {res.feasible}")
    eng = EnsembleTorchDES([DESProblem(dag)] * len(scen))
    _engine_batch("failsafe", eng, TopologySpace(dag), np.stack(scen))
    got, feas = eng.makespans(res.x, np.stack(scen))
    rel = np.abs(got - np.asarray(worst)) / np.asarray(worst)
    log(f"[failsafe] winner on the card {got.tolist()}: rel to the numpy "
        f"DES {rel.tolist()}")
    if not feas.all() or not (rel <= DES_RTOL).all():
        fail(f"failsafe winner: card {got} vs numpy {worst}")

    small = build_comm_dag(make_job(PAPER_WORKLOADS["gpt-7b"]), 400.0)
    kw = dict(seed=0, pop_size=16, max_generations=6, patience=60,
              time_limit=1e9)
    card = plan(PlanRequest(dag=small, failure=FailureModel(),
                            ga_options=GAOptions(**kw)))
    cpu = plan(PlanRequest(dag=small, failure=FailureModel(),
                           ga_options=GAOptions(**kw),
                           des_options=DESOptions(device="cpu")))
    same = bool(np.array_equal(card.x, cpu.x))
    log(f"[failsafe] gpt-7b ({small.num_tasks} tasks, "
        f"{len(card.details['scenario_makespans'])} default scenarios): "
        f"card worst {card.details['worst_scenario_makespan']!r}, cpu "
        f"{cpu.details['worst_scenario_makespan']!r}, identical x {same}")
    if not same:
        fail("gpt-7b failsafe plan on the card differs from the CPU's")
    log(f"[failsafe] phase wall {time.perf_counter() - t_phase:.1f} s")


def _gpt7b_milp_dag():
    """The reference benchmark's MILP DAG: gpt-7b at Table-I width with 4
    microbatches (benchmarks/common.py)."""
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.schedule import build_comm_dag
    return build_comm_dag(make_job(PAPER_WORKLOADS["gpt-7b"], seq_len=4096,
                                   microbatches=4), 400.0)


def phase_milp() -> None:
    """plan(delta-joint-hotstart) on gpt-7b: the hot-start GA on the card,
    the MILP on the host, a validate-clean schedule no worse than the
    same run's delta-fast."""
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.ga import GAOptions
    from repro_torch.core.milp import MILPOptions, validate_solution

    t_phase = time.perf_counter()
    dag = _gpt7b_milp_dag()
    ga = GAOptions(seed=0, pop_size=16, max_generations=6, patience=60,
                   time_limit=1e9)
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    hot = plan(PlanRequest(dag=dag, method="delta-joint-hotstart",
                           ga_options=ga,
                           milp_options=MILPOptions(time_limit=120,
                                                    mip_rel_gap=2e-3)))
    wall = time.perf_counter() - t0
    c = _counts()
    fast = plan(PlanRequest(dag=dag, method="delta-fast", ga_options=ga))
    sched = hot.details["schedule"]
    errors = validate_solution(dag, sched)
    st = hot.details["stats"]
    log(f"[milp] gpt-7b {dag.num_tasks} tasks, {dag.cluster.num_pods} pods:"
        f" plan(delta-joint-hotstart) {wall:.2f} s, status "
        f"{hot.details['milp_status']}, solve {hot.details['solve_time']:.2f}"
        f" s, hot-start GA {hot.details['hotstart_ga_s']:.2f} s, polish "
        f"{st['hot_time']:.2f} s, K {st['K']}, {st['nvars']} variables, "
        f"{st['nrows']} rows; {c['maxmin']} fill_maxmin launches in "
        f"{c['trips']:.0f} trips")
    log(f"[milp] makespan {hot.makespan!r} ({hot.details['comm_time_source']}"
        f"), delta-fast {fast.makespan!r}; validate_solution "
        f"{errors or 'clean'}")
    if c["maxmin"] == 0 or c["maxmin"] != c["trips"] + c["idle"]:
        fail(f"milp: the hot-start GA made {c['maxmin']} fill_maxmin "
             f"launches in {c['trips']} trips")
    if not hot.feasible or errors \
            or not hot.makespan <= fast.makespan * (1 + 1e-6):
        fail(f"milp: feasible {hot.feasible}, errors {errors}, makespan "
             f"{hot.makespan} vs delta-fast {fast.makespan}")
    log(f"[milp] phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_resilient() -> None:
    """plan() of gpt-7b with a zero MILP budget: the fallback chain's GA
    stage, on the card, gives a validate-clean plan."""
    from repro_torch.core.api import FailureModel, PlanRequest, plan
    from repro_torch.core.ga import GAOptions
    from repro_torch.core.milp import validate_solution

    t_phase = time.perf_counter()
    dag = _gpt7b_milp_dag()
    _reset_counts()             # this path's counts start at 0
    res = plan(PlanRequest(
        dag=dag, failure=FailureModel(resilient=True, budget_s=0),
        ga_options=GAOptions(seed=0, pop_size=16, max_generations=6,
                             patience=60, time_limit=1e9)))
    c = _counts()
    errors = validate_solution(dag, res.details["schedule"])
    log(f"[resilient] gpt-7b budget 0: stage {res.details['fallback_stage']}"
        f", degraded {res.details['degraded']}, makespan {res.makespan!r}, "
        f"{c['maxmin']} fill_maxmin launches in {c['trips']:.0f} trips; "
        f"validate_solution {errors or 'clean'}")
    if res.details["fallback_stage"] != "ga" or c["maxmin"] == 0 \
            or c["maxmin"] != c["trips"] + c["idle"] or errors \
            or not res.feasible:
        fail(f"resilient: stage {res.details['fallback_stage']}, launches "
             f"{c['maxmin']} in {c['trips']} trips, errors {errors}")
    log(f"[resilient] phase wall {time.perf_counter() - t_phase:.1f} s")


def _reset_fleet_counts() -> None:
    from repro_torch.obs import REGISTRY
    _reset_counts()
    REGISTRY.counter("fleet_waterfill_rounds_total").reset()


def _batches(entry: str) -> int:
    """The `des.simulate` spans of one entry point in the tracer."""
    from repro_torch import obs
    return sum(1 for r in obs.TRACER.records if r.name == "des.simulate"
               and r.attrs.get("entry") == entry)


def _certified(module):
    """Wrap `module.simulate` to record every (x, makespan) it returns, so
    a trimming sweep's numpy certifications can be read back."""
    calls: list[tuple] = []
    inner = module.simulate

    def recording(problem, x, *a, **kw):
        res = inner(problem, x, *a, **kw)
        calls.append((x.copy(), res.makespan))
        return res
    module.simulate = recording
    return calls, lambda: setattr(module, "simulate", inner)


def _sweep(tag: str, run, problems, x0):
    """One trimming sweep with the counts at 0 before it: ports, rounds,
    launches == trips, and every accepted drop certified by the numpy DES
    within every member's budget.  Returns the trimmed topology."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import ga

    budgets = [ga.simulate(p, x0).makespan * (1 + 1e-6) for p in problems]
    calls, restore = _certified(ga)
    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    try:
        with obs.enabled():
            out = run(x0)
    finally:
        restore()
    wall = time.perf_counter() - t0
    c = _counts()
    rounds = _batches("batch_x") + _batches("ensemble_genomes")
    drops = (int(x0.sum()) - int(out.sum())) // 2
    # one group of calls per certified topology (a member over its budget
    # ends its group early); the first group is the sweep's own base run,
    # and after it each topology within every member's budget is an
    # accepted drop
    groups: list[tuple] = []
    for xt, ms in calls:
        if groups and len(groups[-1][1]) < len(problems) \
                and np.array_equal(groups[-1][0], xt):
            groups[-1][1].append(ms)
        else:
            groups.append((xt, [ms]))
    certs = groups[1:]
    accepted = [xt for xt, ms in certs if len(ms) == len(problems)
                and all(m <= b for m, b in zip(ms, budgets))]
    final = [ga.simulate(p, out).makespan for p in problems]
    log(f"[trim] {tag} on megatron-462b ({len(problems)} member(s)): ports "
        f"{int(x0.sum())} -> {int(out.sum())} ({drops} circuits dropped) in "
        f"{rounds} rounds, {wall:.2f} s; {len(certs)} numpy "
        f"certifications, {len(accepted)} accepted; makespans {final} "
        f"within budgets {budgets}")
    _trips_and_launches("trim", c, rounds)
    if rounds == 0 or drops == 0 or len(accepted) != drops \
            or not all(m <= b for m, b in zip(final, budgets)) \
            or not (out == out.T).all() or out.sum() > x0.sum():
        fail(f"{tag}: {rounds} rounds, {drops} drops, {len(accepted)} "
             f"certified, makespans {final} vs budgets {budgets}")
    for xt in accepted:
        if not all(ga.simulate(p, xt).makespan <= b
                   for p, b in zip(problems, budgets)):
            fail(f"{tag}: an accepted drop exceeds its budget")
    return out


def _floored_start(dag, x):
    """[plan]'s topology with its TRIM_HEAVY pod pairs of most circuits at
    TRIM_FLOOR, where the sweep from that topology itself leaves them: a
    cut of the sweep's depth.  The floor was read from the full sweep of
    [plan]'s 122-port topology, so any other x fails here."""
    if int(x.sum()) != ROUND_PATH_PORTS:
        fail(f"trim: [plan]'s x has {int(x.sum())} ports; TRIM_FLOOR was "
             f"measured from its {ROUND_PATH_PORTS}-port topology")
    pairs = sorted(dag.undirected_pairs(),
                   key=lambda p: (-int(x[p]), p))[:TRIM_HEAVY]
    start = x.copy()
    for i, j in pairs:
        start[i, j] = start[j, i] = min(int(x[i, j]), TRIM_FLOOR)
    per_pair = {p: (int(x[p]), int(start[p]))
                for p in dag.undirected_pairs()}
    log(f"[trim] start: [plan]'s {int(x.sum())} ports with its {pairs} "
        f"pairs of most circuits at {TRIM_FLOOR}, {int(start.sum())} ports; "
        f"circuits per pair ([plan], start) {per_pair}")
    return start


def phase_trim(dag, x, ens) -> None:
    """trim_ports on [plan]'s megatron-462b topology with its two
    heaviest pairs at their floor (`_floored_start`), then
    trim_ports_ensemble on [robust]'s sequence-length ensemble, both on
    the batched path on the card (every drop-one candidate of a round in
    one batch).  The ensemble sweep starts TRIM_ENSEMBLE_EXTRA circuits
    above the single-DAG sweep's result on each of the ensemble's two pod
    pairs of most volume (a cut of its depth: from [robust]'s winner it
    would repeat the single-DAG sweep's 25 rounds)."""
    from repro_torch.core.des import DESProblem
    from repro_torch.core.ga import trim_ports, trim_ports_ensemble

    t_phase = time.perf_counter()
    trimmed = _sweep("trim_ports", lambda x0: trim_ports(
        dag, x0, backend="torch"), [DESProblem(dag)],
        _floored_start(dag, x))
    vol = sum(m.traffic_matrix() for m in ens.members)
    pairs = sorted(ens.undirected_pairs(),
                   key=lambda p: (-(vol[p] + vol[p[::-1]]), p))[:2]
    start = trimmed.copy()
    for i, j in pairs:
        start[i, j] += TRIM_ENSEMBLE_EXTRA
        start[j, i] += TRIM_ENSEMBLE_EXTRA
    _sweep(f"trim_ports_ensemble (from the single-DAG result + "
           f"{TRIM_ENSEMBLE_EXTRA} circuits on pairs {pairs})",
           lambda x0: trim_ports_ensemble(ens, x0, backend="torch"),
           [DESProblem(m) for m in ens.members], start)
    log(f"[trim] phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_planes(dag) -> None:
    """delta_planes on megatron-462b with 4 planes, LANES genomes and
    PLANES_GENERATIONS per stage (LANES x 5 fabric states = 240 lanes per
    spare-stage batch): the winner's per-plane split and every
    one-plane-dark state against the numpy DES, s/generation and the idle
    share of a batch."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.dag import DagEnsemble
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.des_torch import (EnsembleTorchDES,
                                            plane_state_genomes)
    from repro_torch.core.ga import delta_planes
    from repro_torch.fleet import effective_topology

    t_phase = time.perf_counter()
    ens = DagEnsemble.singleton(dag)
    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    with obs.enabled():
        res = delta_planes(ens, _robust_ga(PLANES_GENERATIONS),
                           num_planes=PLANES)
    wall = time.perf_counter() - t0
    c = _counts()
    gen_s, gens = _evolve_gen_s("delta_planes")
    base_s, base_gens = _evolve_gen_s("delta_robust")
    batches = _batches("ensemble_genomes")
    log(f"[planes] delta_planes megatron-462b, {PLANES} planes, {LANES} "
        f"genomes: {wall:.2f} s; base stage {base_gens} generations at "
        f"{base_s:.3f} s/generation ({LANES} lanes), spare stage {gens} "
        f"generations at {gen_s:.3f} s/generation ({LANES} x "
        f"{PLANES + 1} = {LANES * (PLANES + 1)} lanes); {res.total_ports} "
        f"ports, planes {[int(p.sum()) for p in res.planes]}, worst dark "
        f"regret {res.worst_dark_regret!r}")
    _trips_and_launches("planes", c, batches)
    budgets = np.asarray(res.plane_port_limits)
    usage = np.stack([np.triu(p, 1).sum(0) + np.triu(p, 1).sum(1)
                      for p in res.planes])
    if gens != PLANES_GENERATIONS or not res.feasible \
            or not np.array_equal(res.planes.sum(axis=0), res.x) \
            or (usage > budgets).any():
        fail(f"planes: generations {gens}, feasible {res.feasible}, "
             f"usage {usage.tolist()} vs budgets {budgets.tolist()}")
    # the winner's states: exact numpy DES on each effective topology,
    # and the card's state lanes within DES_RTOL of it
    prob = DESProblem(dag)
    exact = [simulate(prob, effective_topology(res.planes, d)).makespan
             for d in [set()] + [{p} for p in range(PLANES)]]
    want = np.concatenate([res.makespans, res.dark_makespans[:, 0]])
    eu = np.asarray([e[0] for e in res.edges])
    ev = np.asarray([e[1] for e in res.edges])
    eng = EnsembleTorchDES([prob])
    states = plane_state_genomes(res.lane_genomes)
    got, feas = eng.ensemble_genome_makespan(states, eu, ev)
    rel = np.abs(got[:, 0] - want) / want
    log(f"[planes] winner's {PLANES + 1} fabric states: numpy DES "
        f"{want.tolist()}, on the card rel {rel.tolist()}")
    if exact != want.tolist() or not feas.all() or not (rel <= DES_RTOL
                                                          ).all():
        fail(f"planes winner: exact {exact}, recorded {want.tolist()}, "
             f"card rel {rel.tolist()}")
    # one spare-stage batch alone: 240 lanes, wall and device busy time
    genomes = np.random.default_rng(0).integers(
        0, 3, size=(LANES, len(eu)))
    lanes = np.concatenate([np.broadcast_to(
        res.lane_genomes[None, :-1], (LANES, PLANES - 1, len(eu))),
        genomes[:, None]], axis=1)
    batch_states = plane_state_genomes(lanes).reshape(-1, len(eu))

    def batch():
        return eng.ensemble_genome_makespan(batch_states, eu, ev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch()
    wall = time.perf_counter() - t0
    c = _counts()
    busy = _traced_batch("planes", batch)
    log(f"[planes] one spare-stage batch of {len(batch_states)} lanes: "
        f"{wall:.3f} s, {c['trips']:.0f} trips, {c['maxmin']} fill_maxmin "
        f"launches; device busy {busy:.4f} s, idle share "
        + (f"{1.0 - busy / wall:.4f}" if busy else "not measured"))
    if c["maxmin"] != c["trips"] + c["idle"] or c["maxmin"] == 0:
        fail(f"planes batch: {c['maxmin']} launches for {c['trips']} trips")
    log(f"[planes] phase wall {time.perf_counter() - t_phase:.1f} s")


def _fleet_pair(workload: str, microbatches: int, ga, des_options=None):
    """The Fig. 10 pair (benchmarks/fig10_realloc.py:22-45) through the
    port's plan(): a port-minimized donor and its reversed-stage
    co-tenant on the same pods."""
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.api import FleetOptions, PlanRequest, plan
    from repro_torch.fleet import JobArrival
    job = make_job(PAPER_WORKLOADS[workload], microbatches=microbatches)
    pl = job.placement()
    return job, plan(PlanRequest(
        fleet_requests=[JobArrival("model", job, port_min=True),
                        JobArrival("model_t", job, reverse_stages=True)],
        ga_options=ga, des_options=des_options,
        fleet=FleetOptions(num_pods=pl.num_pods,
                           ports_per_pod=2 * max(pl.port_limits()),
                           nic_gbps=100.0)))


def _fleet_run(workload: str, microbatches: int, generations: int,
               realloc: bool):
    """One Fig. 10 pair at Table-I width on the card, with the counts at 0
    before it: the co-tenant's NCT before and after reallocation, the
    donated surplus, the ledger after every event, the report's engine
    cache, one fill_maxmin launch per trip, and (with `realloc`) one
    fill_matvec launch per waterfill round, at least one; the co-tenant's
    certified makespan against the numpy DES and the card.  Returns the
    fill_matvec launches and the operands of the last one."""
    import numpy as np
    import torch
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.ga import GAOptions
    from repro_torch.fleet import ledger, realloc as realloc_mod
    from repro_torch.obs import REGISTRY

    t0 = time.perf_counter()
    checks = []
    inner_check = ledger.PortLedger.check

    def counted(self):
        inner_check(self)
        for acct in self.accounts.values():
            if not (acct.allocated + acct.surplus == acct.limits).all():
                fail(f"fleet {workload}: a tenant's books do not balance")
        checks.append(self.pool().copy())
    operands = []
    inner_mv = realloc_mod.ops.fill_matvec

    def spy(w, rhs, **kw):
        operands.append((w, rhs))
        return inner_mv(w, rhs, **kw)
    ledger.PortLedger.check = counted
    realloc_mod.ops.fill_matvec = spy
    # the GA on the card whatever the DAG's size (a 2,065-task DAG is
    # beyond GAOptions.device_task_limit, which would pick the numpy DES)
    ga = GAOptions(seed=0, pop_size=LANES, max_generations=generations,
                   patience=60, time_limit=1e9, backend="torch")
    _reset_fleet_counts()           # this path's counts start at 0
    try:
        job, res = _fleet_pair(workload, microbatches, ga)
    finally:
        ledger.PortLedger.check = inner_check
        realloc_mod.ops.fill_matvec = inner_mv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    rounds = int(REGISTRY.counter("fleet_waterfill_rounds_total").value())
    planner, report = res
    donor, cot = planner.history[0], planner.history[1]
    model_t = planner.tenants["model_t"]
    dag = model_t.dag
    tag = f"fleet {workload}"
    log(f"[fleet] {workload} x2 at {microbatches} microbatches (model "
        f"port-min, model_t reversed), {dag.num_tasks} tasks and "
        f"{len(dag.undirected_pairs())} pod pairs each, "
        f"{planner.fleet.num_pods} pods x {planner.fleet.ports_per_pod} "
        f"ports, {LANES} genomes x {generations} generations: plan "
        f"{wall:.2f} s")
    log(f"[fleet] donor NCT {float(donor['nct'])!r}, {donor['ports']} "
        f"ports, donated {donor['donated_ports']}; co-tenant NCT before "
        f"{float(cot['nct'])!r} after {float(model_t.plan.nct)!r}, realloc "
        f"{report['realloc']}")
    log(f"[fleet] ledger checked after each of {len(planner.history)} "
        f"events ({len(checks)} checks), pool {checks[-1].tolist()}; "
        f"des_cache {report['des_cache']}; plan cache {report['cache']}")
    log(f"[fleet] fill_matvec {c['launches']} launches in {rounds} "
        f"waterfill rounds; fill_maxmin {c['maxmin']} launches in "
        f"{c['trips']:.0f} trips")
    cert = simulate(DESProblem(dag), model_t.plan.x)
    card = model_t.des().makespan(model_t.plan.x)
    rel = abs(card - cert.makespan) / cert.makespan
    log(f"[fleet] co-tenant certified makespan {model_t.plan.makespan!r}, "
        f"numpy DES {cert.makespan!r}, on the card {card!r} (rel "
        f"{rel:.3e})")
    if c["launches"] != rounds or c["maxmin"] != c["trips"] + c["idle"] \
            or c["maxmin"] == 0 or len(checks) < len(planner.history) \
            or not model_t.plan.nct <= cot["nct"] * (1 + 1e-9) \
            or model_t.plan.makespan != cert.makespan \
            or not rel <= DES_RTOL or donor["donated_ports"] <= 0 \
            or report["des_cache"]["hits"] + report["des_cache"]["misses"] \
            == 0:
        fail(f"{tag}: fill_matvec {c['launches']} launches for {rounds} "
             f"rounds, fill_maxmin {c['maxmin']} for {c['trips']} trips, "
             f"{len(checks)} ledger checks, NCT {cot['nct']} -> "
             f"{model_t.plan.nct}, card rel {rel}")
    if realloc and (rounds == 0 or report["realloc"]["granted_ports"] == 0
                    or not model_t.plan.nct < cot["nct"]):
        fail(f"{tag}: {rounds} waterfill rounds, realloc {report['realloc']}"
             f", NCT {cot['nct']} -> {model_t.plan.nct}")
    log(f"[fleet] {workload} wall {time.perf_counter() - t0:.1f} s")
    return c["launches"], operands[-1] if operands else None


def phase_fleet() -> dict:
    """The Fig. 10 pair through the port's plan(kind="fleet") on the card:
    at megatron-177b's Table-I width, where the reversed co-tenant is
    bandwidth-bottlenecked and the donor's surplus is water-filled into
    it (fill_matvec once per round); at mixtral-8x22b's, whose 2,065-task
    DAG is the largest a tenant's GA runs (n = 2,112 per fill_maxmin
    block; all its traffic is on one pod pair, so the co-tenant is not
    bottlenecked and no surplus pass runs); fill_matvec at the fleet's
    shape against its plain version and torch.matmul; the pair at gpt-7b
    on the card and on the CPU.  Returns fill_matvec's kernel record at
    the fleet's shape, its launches those of the megatron-177b run."""
    import numpy as np
    import torch
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions
    from repro_torch.kernels import waterfill
    from repro_torch.kernels.ref import fill_matvec_ref

    t_phase = time.perf_counter()
    launches, (w, rhs) = _fleet_run("megatron-177b", 48, FLEET_GENERATIONS,
                                    realloc=True)
    _fleet_run("mixtral-8x22b", 64, FLEET_MIXTRAL_GENERATIONS,
               realloc=False)

    # fill_matvec at the fleet's shape: W (P, T*P) @ rhs (T*P, 2)
    got = waterfill.fill_matvec(w, rhs)
    torch.cuda.synchronize()
    max_abs, _ = _check_close(f"fill_matvec fleet shape {tuple(w.shape)} @ "
                              f"{tuple(rhs.shape)}", got,
                              fill_matvec_ref(w, rhs))
    ms = time_ms(lambda: waterfill.fill_matvec(w, rhs))
    plain_ms = time_ms(lambda: fill_matvec_ref(w, rhs))
    library_ms = time_ms(lambda: torch.matmul(w, rhs))
    (c_, n_), r_ = w.shape, rhs.shape[1]
    b_ms, b_by = bound_ms(4.0 * (c_ * n_ + n_ * r_ + c_ * r_),
                          2.0 * c_ * n_ * r_)
    log(f"[fleet] fill_matvec C={c_} N={n_} R={r_}: kernel {ms:.5f} ms/call,"
        f" plain {plain_ms:.5f}, torch.matmul {library_ms:.5f}, bound "
        f"{b_ms:.7f} ms ({b_by}); max abs err {max_abs:.3e} (device time "
        f"per call at this shape: [kernels])")
    if (c_, n_, r_) != FLEET_MATVEC:
        fail(f"fleet: fill_matvec ran at ({c_}, {n_}) @ ({n_}, {r_}), "
             f"[kernels] profiled {FLEET_MATVEC}")

    # the same pair at gpt-7b, on the card and on the CPU
    small = GAOptions(seed=0, pop_size=16, max_generations=6, patience=60,
                      time_limit=1e9)
    _, on_card = _fleet_pair("gpt-7b", 4, small)
    _, on_cpu = _fleet_pair("gpt-7b", 4, small, DESOptions(device="cpu"))
    same = all(np.array_equal(on_card.planner.tenants[n].plan.x,
                              on_cpu.planner.tenants[n].plan.x)
               for n in ("model", "model_t"))
    log(f"[fleet] gpt-7b pair: card NCTs "
        f"{[float(t['nct']) for t in on_card.report['tenants'].values()]}"
        f", CPU "
        f"{[float(t['nct']) for t in on_cpu.report['tenants'].values()]}"
        f", identical x per tenant {same}")
    if not same:
        fail("fleet: the gpt-7b pair plans differently on the card")
    log(f"[fleet] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"name": "waterfill.fill_matvec (fleet waterfill_grants)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def _card_vs_numpy(tag: str, name: str, dag, xs, picked) -> list[float]:
    """The topologies `xs` of `dag` as one batch on the card (an engine of
    their own, the counts at 0 before it: one fill_maxmin launch per trip)
    against the numpy DES for the lanes `picked`, at DES_RTOL.  Returns the
    card's makespans of those lanes."""
    import numpy as np
    import torch
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.des_torch import TorchDES

    prob = DESProblem(dag)
    des = TorchDES(prob)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, feas = des.batch_makespan(np.stack(xs))
    wall = time.perf_counter() - t0
    c = _counts()
    want = [simulate(prob, xs[i]).makespan for i in picked]
    got = [float(ms[i]) for i in picked]
    rel = [abs(g - w) / w for g, w in zip(got, want)]
    log(f"[{tag}] {name}: {len(xs)} topologies as one batch on the card "
        f"(padded to {tuple(des.pad)}), {wall:.2f} s; lanes {list(picked)}: "
        f"card {got}, numpy {want}, rel {rel}")
    _trips_and_launches(tag, c, 1)
    if not all(feas[i] for i in picked) \
            or not all(r <= DES_RTOL for r in rel):
        fail(f"{tag} {name}: feasible {feas.tolist()}, rel to the numpy DES "
             f"{rel}")
    return got


def _no_worse(tag: str, name: str, results) -> None:
    """delta-fast feasible with an NCT no worse than the best baseline's."""
    fast = results.get("delta-fast")
    baseline = min(r.nct for m, r in results.items() if m != "delta-fast")
    if fast is None or not fast.feasible \
            or not fast.nct <= baseline * (1 + 1e-9):
        fail(f"{tag} {name}: delta-fast {fast}, best baseline NCT "
             f"{baseline}")


def _cli_run(arch: str, out: Path) -> None:
    """The control-plane CLI in process on the card at `arch`'s full
    configured width with its default methods, the counts at 0 before
    it: fill_maxmin once per trip of the delta-fast GA, delta-fast no
    worse than the best baseline (at granite, whose port limits leave the
    GA one genome, delta-fast is prop-alloc's topology and this holds
    trivially), the --out topology within the port limits; then every
    method's topology scored on the card against the numpy DES (the
    CLI's printed makespans are the numpy DES's own), and fill_maxmin at
    this DAG's CSR against its plain version."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.configs import ALL_ARCHS, make_job
    from repro_torch.core.schedule import build_comm_dag
    from repro_torch.launch import topo_plan

    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    with obs.enabled():
        results = topo_plan.main(["--arch", arch, "--time-limit",
                                  repr(CLI_TIME_LIMIT), "--out", str(out)])
    wall = time.perf_counter() - t0
    c = _counts()
    spans = obs.TRACER.summary()
    batches = spans.get("ga.fitness_batch", {}).get("count", 0)
    dag = build_comm_dag(make_job(ALL_ARCHS[arch], seq_len=4096), 400.0)
    payload = json.loads(out.read_text())
    x = np.asarray(payload["topology"])
    limits = np.asarray(dag.cluster.port_limits)
    log(f"[cli] {arch}: {dag.num_tasks} tasks, {len(dag.deps)} deps, "
        f"{dag.cluster.num_pods} pods; s per method "
        f"{ {m: round(r.elapsed, 3) for m, r in results.items()} }, "
        f"selected {payload['method']}, wall {wall:.1f} s; row sums "
        f"{x.sum(axis=1).tolist()} within limits {limits.tolist()}")
    fast = results.get("delta-fast")
    gens = fast.details["generations"] if fast else 0
    gen_s = spans.get("ga.generation", {}).get("total_s", 0.0)
    log(f"[cli] {arch} delta-fast: {gens} generations, "
        f"{gen_s / max(gens, 1):.3f} s/generation, "
        f"{fast.details['evaluations'] if fast else 0} evaluations; spans "
        + ", ".join(f"{k} x{v['count']} {v['total_s']:.2f} s"
                    for k, v in spans.items()))
    _trips_and_launches("cli", c, batches)
    _no_worse("cli", arch, results)
    if x.shape != (dag.cluster.num_pods,) * 2 or not (x == x.T).all() \
            or (x.sum(axis=1) > limits).any() \
            or payload["method"] not in results:
        fail(f"cli {arch}: --out topology {x.tolist()} against limits "
             f"{limits.tolist()}, method {payload['method']}")
    xs = [r.x for r in results.values()]
    _card_vs_numpy("cli", f"{arch}'s {len(xs)} method topologies", dag, xs,
                   range(len(xs)))
    _maxmin_at_dag("cli", arch, dag, np.random.default_rng(5))


def _registry_dag(arch: str):
    """`arch`'s DAG at its full configured width (seq 4096)."""
    from repro_torch.configs import ALL_ARCHS, make_job
    from repro_torch.core.schedule import build_comm_dag
    t0 = time.perf_counter()
    dag = build_comm_dag(make_job(ALL_ARCHS[arch], seq_len=4096), 400.0)
    log(f"[dag] {arch}: {dag.num_tasks} tasks, {len(dag.deps)} deps, "
        f"{dag.cluster.num_pods} pods, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return dag


def _cli_ga(dag) -> None:
    """The CLI's default methods on CLI_GA_ARCH, an MoE DAG above the
    GA's device task limit (`auto` would run it on the host), with the GA
    forced onto the card for CLI_GA_GENERATIONS generations and the
    counts at 0 before it: fill_maxmin once per trip, delta-fast no worse
    than the best baseline, and every method's topology scored on the
    card against the numpy DES."""
    from repro_torch import obs
    from repro_torch.core.api import compare
    from repro_torch.core.ga import GAOptions, TopologySpace

    space = TopologySpace(dag)
    log(f"[cli] {CLI_GA_ARCH}: GA space over pod pairs {space.edges}, "
        f"X-bar {space.xbar.tolist()}, port limits "
        f"{sorted(set(space.U.tolist()))}")
    obs.TRACER.clear()
    _reset_counts()             # this path's counts start at 0
    t0 = time.perf_counter()
    with obs.enabled():
        results = compare(dag, methods=CLI_METHODS, ga_options=GAOptions(
            backend="torch", max_generations=CLI_GA_GENERATIONS))
    wall = time.perf_counter() - t0
    c = _counts()
    spans = obs.TRACER.summary()
    batches = spans.get("ga.fitness_batch", {}).get("count", 0)
    fast = results["delta-fast"]
    log(f"[cli] {CLI_GA_ARCH} on the card: s per method "
        f"{ {m: round(r.elapsed, 3) for m, r in results.items()} }, NCT "
        f"{ {m: float(r.nct) for m, r in results.items()} }, ports "
        f"{ {m: r.total_ports for m, r in results.items()} }; delta-fast "
        f"{fast.details['generations']} generations, "
        f"{fast.details['evaluations']} evaluations; wall {wall:.1f} s")
    _trips_and_launches("cli", c, batches)
    _no_worse("cli", CLI_GA_ARCH, results)
    xs = [r.x for r in results.values()]
    _card_vs_numpy("cli", f"{CLI_GA_ARCH}'s {len(xs)} method topologies",
                   dag, xs, range(len(xs)))


def phase_cli(jamba) -> None:
    """`python -m repro_torch.launch.topo_plan` in process at two registry
    architectures that the GA's `auto` backend sends to the card (the MoE
    granite-moe-1b-a400m and the vision-language llama-3.2-vision-11b);
    the CLI's methods on the MoE grok-1-314b with the GA forced onto the
    card; then LANES random genomes of the widest registry DAG, `jamba`,
    as one batch on the card against the numpy DES for two of them."""
    import numpy as np
    from repro_torch.core.ga import TopologySpace
    t_phase = time.perf_counter()
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    for arch in CLI_ARCHS:
        _cli_run(arch, out / f"plan_{arch}.json")
    _cli_ga(_registry_dag(CLI_GA_ARCH))
    space = TopologySpace(jamba)
    genomes = space.random_init_batch(np.random.default_rng(0), LANES)
    _card_vs_numpy("cli", f"{JAMBA}'s random genomes", jamba,
                   [space.to_matrix(g) for g in genomes], (0, LANES - 1))
    log(f"[cli] phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_examples() -> None:
    """The seven planner and fleet examples in process on the card, each
    at its fast setting (plan_topology at gpt-7b) and with the counts at
    0 before it: each returns 0, its GA launches fill_maxmin once per
    trip, and the fleet examples' waterfill launches fill_matvec once per
    round."""
    import contextlib
    import io
    from repro_torch import obs
    from repro_torch.examples import (chaos_fleet, control_plane,
                                      fleet_realloc, plan_topology,
                                      planes_transition, quickstart,
                                      trace_plan)
    from repro_torch.obs import REGISTRY

    t_phase = time.perf_counter()
    out = ROOT / "build" / "chip_smoke" / "trace"
    runs = (("quickstart", lambda: quickstart.main([], fast=True)),
            # its delta-joint MILP (HiGHS, on the host) is most of its time
            ("plan_topology",
             lambda: plan_topology.main(["--arch", "gpt-7b"])),
            ("trace_plan", lambda: trace_plan.main(["--out", str(out)])),
            ("fleet_realloc", lambda: fleet_realloc.main([])),
            ("chaos_fleet", lambda: chaos_fleet.main([])),
            ("control_plane", lambda: control_plane.main([])),
            ("planes_transition", lambda: planes_transition.main([])))
    for name, run in runs:
        _reset_fleet_counts()   # this example's counts start at 0
        text = io.StringIO()
        t0 = time.perf_counter()
        # trace_plan turns the tracer on; the context restores its state
        with obs.enabled(obs.TRACER.is_enabled), \
                contextlib.redirect_stdout(text):
            rc = run() or 0
        wall = time.perf_counter() - t0
        obs.TRACER.clear()
        c = _counts()
        rounds = int(REGISTRY.counter("fleet_waterfill_rounds_total")
                     .value())
        last = text.getvalue().strip().splitlines()[-1]
        log(f"[examples] {name}: rc {rc}, {wall:.2f} s, {c['trips']:.0f} "
            f"trips, {c['maxmin']} fill_maxmin launches, {rounds} waterfill"
            f" rounds, {c['launches']} fill_matvec launches; last line "
            f"{last!r}")
        if rc != 0 or c["maxmin"] != c["trips"] + c["idle"] \
                or c["maxmin"] == 0 \
                or c["launches"] != rounds \
                or (name == "fleet_realloc" and rounds == 0):
            fail(f"example {name}: rc {rc}, {c['maxmin']} fill_maxmin "
                 f"launches for {c['trips']:.0f} trips, {c['launches']} "
                 f"fill_matvec launches for {rounds} waterfill rounds\n"
                 f"{text.getvalue()[-3000:]}")
    log(f"[examples] phase wall {time.perf_counter() - t_phase:.1f} s")


def _rel(got, want) -> float:
    """max |got - want| over max |want|, on the CPU in float32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def _lm_inputs(cfg, b: int, s: int, n: int, seed: int = 0):
    """A prompt (b, s), the modality input of a vlm / encdec model and n
    teacher-forced tokens (b, n), from a seeded CPU generator."""
    import torch
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g)
    xl = cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens
    xkv = torch.randn((b, xl, cfg.d_model), generator=g) if xl else None
    return tokens, xkv, torch.randint(0, cfg.vocab, (b, n), generator=g)


def _serve_main(arch: str, tag: str):
    """`serve.main` at full width on the card at its default shape: its
    two lines, then weight bytes, prefill ms, decode ms per step, tok/s
    and the peak of allocated memory."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = serve.main(["--arch", arch, "--batch", str(SERVE_BATCH),
                          "--prompt-len", str(SERVE_PROMPT),
                          "--decode-steps", str(SERVE_STEPS)])
    peak = torch.cuda.max_memory_allocated()
    for line in text.getvalue().strip().splitlines():
        log(line)
    logits = out["logits"]
    if not logits.is_cuda or not bool(torch.isfinite(logits).all()) or \
            out["tokens"].shape != (SERVE_BATCH, SERVE_STEPS + 1):
        fail(f"serve.main {arch}: logits on {logits.device}, finite "
             f"{bool(torch.isfinite(logits).all())}, tokens "
             f"{tuple(out['tokens'].shape)}")
    log(f"[serve] {arch} ({tag}): {out['param_bytes']} B of float32 "
        f"weights; prefill {SERVE_BATCH}x{SERVE_PROMPT} "
        f"{out['prefill_s'] * 1e3:.3f} ms; decode "
        f"{out['decode_s'] * 1e3 / SERVE_STEPS:.3f} ms per step over "
        f"{SERVE_STEPS} steps, {out['tok_per_s']:.1f} tok/s; peak "
        f"{peak} B allocated")
    return out


def _teacher_forced(cfg, lm, device, tokens, xkv, nxt):
    """Prefill, then one decode step per column of `nxt`: the logits of
    each step."""
    from repro_torch.models import model as M
    from repro_torch.training import train_step as ts
    b, s = tokens.shape
    cache = M.init_cache(cfg, b, s + nxt.shape[1], dtype=lm.embed.dtype,
                         device=device,
                         enc_len=0 if xkv is None else xkv.shape[1])
    out, cache = ts.make_prefill_step(cfg, has_xkv=xkv is not None)(
        lm, cache, tokens.to(device), None if xkv is None else xkv.to(device))
    steps = [out]
    decode = ts.make_decode_step(cfg)
    for t in range(nxt.shape[1]):
        _, out, cache = decode(lm, cache, nxt[:, t:t + 1].to(device))
        steps.append(out)
    return steps


def _decode_vs_full(cfg, lm, b: int, s: int, seed: int) -> float:
    """Prefill s tokens, decode one more; its logits against the full
    forward's last position on the same device."""
    import torch
    from repro_torch.models import model as M
    dev = lm.embed.device
    tokens, xkv, nxt = _lm_inputs(cfg, b, s, 1, seed)
    tokens, nxt = tokens.to(dev), nxt.to(dev)
    xkv = None if xkv is None else xkv.to(dev)
    cache = M.init_cache(cfg, b, s + 1, dtype=lm.embed.dtype, device=dev,
                         enc_len=0 if xkv is None else xkv.shape[1])
    with torch.no_grad():
        _, cache = M.forward(cfg, lm, tokens, xkv=xkv, cache=cache)
        dec, _ = M.forward(cfg, lm, nxt, cache=cache)
        full, _ = M.forward(cfg, lm, torch.cat([tokens, nxt], 1), xkv=xkv)
    if not bool(torch.isfinite(full).all()) or \
            not bool(torch.isfinite(dec).all()):
        fail(f"{cfg.name}: non-finite logits")
    return _rel(dec[:, 0], full[:, -1])


def _decode_trace(cfg, lm, wall_ms: float) -> None:
    """Kernels launched, device busy time and idle share of one decode
    step at serve.main's shape, from a torch.profiler trace; the wall
    time per step is serve.main's."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import train_step as ts
    tokens, _, nxt = _lm_inputs(cfg, SERVE_BATCH, SERVE_PROMPT, 4)
    cache = M.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + 4,
                         dtype=torch.float32, device="cuda")
    _, cache = ts.make_prefill_step(cfg)(lm, cache, tokens.cuda())
    decode = ts.make_decode_step(cfg)
    for t in range(3):
        decode(lm, cache, nxt[:, t:t + 1].cuda())
    prof = _profile(lambda: decode(lm, cache, nxt[:, 3:4].cuda()))
    dev = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(ev.name == "cudaLaunchKernel" for ev in prof.events())
    busy_ms = _busy_s(prof) * 1e3
    log(f"[serve] {cfg.name} one decode step (batch {SERVE_BATCH}): "
        f"{launches} cudaLaunchKernel calls, {len(dev)} device kernels "
        f"and copies, device busy {busy_ms:.3f} ms of serve.main's "
        f"{wall_ms:.3f} ms per step: idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}"
        if dev else f"[serve] {cfg.name} one decode step: {launches} "
        f"cudaLaunchKernel calls; device time not measured (no device "
        f"events in the trace)")


def phase_serve():
    """The LM serving path on the card: `serve.main` at full width for
    SERVE_ARCHS; the same weights on the card and on the CPU; decode
    against the full forward at full width and for all ten registry
    architectures at their reduced size.  Returns the tokens and last
    logits of serve.main's warm qwen3-0.6b run."""
    import copy
    import gc
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    log(f"[serve] card: {_card()}")
    walls = {}
    for arch in SERVE_ARCHS:
        tags = ("cold", "warm") if arch == SERVE_ARCHS[0] else ("",)
        for tag in tags:
            out = _serve_main(arch, tag or "once")
        walls[arch] = out["decode_s"] * 1e3 / SERVE_STEPS
        if arch == SERVE_ARCHS[0]:
            first = (out["tokens"], out["logits"].cpu())
        del out
    for arch in SERVE_ARCHS:
        if arch not in SERVE_CPU_ARCHS + SERVE_DECODE_ARCHS:
            continue
        t0 = time.perf_counter()
        cfg = REGISTRY[arch].config
        lm = M.LM(cfg, dtype=torch.float32, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
        if arch == SERVE_ARCHS[0]:
            _decode_trace(cfg, lm, walls[arch])
        if arch in SERVE_CPU_ARCHS:
            cpu_lm = copy.deepcopy(lm).to("cpu")
            tokens, xkv, nxt = _lm_inputs(cfg, 1, SERVE_PROMPT, 4, seed=1)
            card = _teacher_forced(cfg, lm, torch.device("cuda"), tokens,
                                   xkv, nxt)
            host = _teacher_forced(cfg, cpu_lm, torch.device("cpu"),
                                   tokens, xkv, nxt)
            errs = [_rel(a, b) for a, b in zip(card, host)]
            log(f"[serve] {arch} card vs CPU, same weights, batch 1: "
                f"prefill and 4 teacher-forced decode steps, rel err "
                f"{', '.join(f'{e:.3e}' for e in errs)} (limit "
                f"{SERVE_CPU_REL})")
            if not all(t.is_cuda for t in card) or \
                    max(errs) > SERVE_CPU_REL:
                fail(f"{arch}: card disagrees with the CPU: {errs}")
            del cpu_lm, card, host
        if arch in SERVE_DECODE_ARCHS:
            err = _decode_vs_full(cfg, lm, 2, SERVE_PROMPT, seed=2)
            log(f"[serve] {arch} decode vs full forward on the card, batch"
                f" 2, prompt {SERVE_PROMPT}: rel err {err:.3e} (limit "
                f"{SERVE_DECODE_REL})")
            if err > SERVE_DECODE_REL:
                fail(f"{arch}: decode disagrees with the full forward: "
                     f"{err}")
        del lm
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[serve] {arch} checks {time.perf_counter() - t0:.1f} s")
    errs = {}
    for arch in sorted(REGISTRY):
        cfg = REGISTRY[arch].config.reduced()
        lm = M.LM(cfg, dtype=torch.float32, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
        errs[arch] = _decode_vs_full(cfg, lm, 2, 24, seed=3)
        if errs[arch] > SERVE_DECODE_REL:
            fail(f"{arch} (reduced): decode disagrees with the full "
                 f"forward: {errs[arch]}")
    log(f"[serve] the ten architectures reduced, decode vs full forward "
        f"on the card, rel err: "
        f"{', '.join(f'{a} {e:.3e}' for a, e in errs.items())}")
    log(f"[serve] phase wall {time.perf_counter() - t_phase:.1f} s")
    return first


def _xkv_len(cfg) -> int:
    return cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens


def _train_batch(cfg, step: int, b: int, s: int, device,
                 xkv: bool = False):
    """Batch `step` of the data stream, made on the host with numpy (with
    the modality input of a vlm / encdec model when `xkv`)."""
    import torch
    from repro_torch.training.data import SyntheticLM
    xl = _xkv_len(cfg) if xkv else 0
    batch = SyntheticLM(vocab=cfg.vocab, seed=0).batch(
        step, b, s, (xl, cfg.d_model) if xl else None)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _state_to(state: dict, device) -> dict:
    """A copy of a train state on `device`."""
    import copy
    opt = state["opt"]
    return {"params": copy.deepcopy(state["params"]).to(device),
            "opt": {"m": {n: t.to(device, copy=True)
                          for n, t in opt["m"].items()},
                    "v": {n: t.to(device, copy=True)
                          for n, t in opt["v"].items()},
                    "step": opt["step"].to(device, copy=True)}}


def _state_tensors(state: dict) -> dict:
    """Every tensor of a train state by its name."""
    opt = state["opt"]
    return {**{f"params/{n}": p for n, p in
               state["params"].named_parameters()},
            **{f"m/{n}": t for n, t in opt["m"].items()},
            **{f"v/{n}": t for n, t in opt["v"].items()},
            "step": opt["step"]}


def _train_pair(cfg, b: int, s: int, steps: int, seed: int = 0):
    """`steps` train steps from one initial float32 state on the card and
    on the CPU (a copy), a vlm / encdec model with its modality input:
    (metrics, final state) of each."""
    import torch
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=5)
    card = ts.init_train_state(
        cfg, ocfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    host = _state_to(card, "cpu")
    xkv = bool(_xkv_len(cfg))
    out = []
    for state, dev in ((card, "cuda"), (host, "cpu")):
        step = ts.make_train_step(cfg, ocfg, remat=False, has_xkv=xkv)
        metrics = []
        for i in range(steps):
            state, m = step(state, _train_batch(cfg, i, b, s, dev, xkv))
            metrics.append({k: float(v) for k, v in m.items()})
        out.append((metrics, state))
    return out


def _check_card_vs_cpu(tag: str, card, host) -> list[float]:
    errs = []
    for t, (c, h) in enumerate(zip(card, host)):
        le = abs(c["loss"] - h["loss"]) / abs(h["loss"])
        ge = abs(c["grad_norm"] - h["grad_norm"]) / abs(h["grad_norm"])
        errs += [le, ge]
        if not (math.isfinite(c["loss"]) and le <= TRAIN_LOSS_REL
                and ge <= TRAIN_GNORM_REL):
            fail(f"[train] {tag} step {t}: card loss {c['loss']!r} grad "
                 f"norm {c['grad_norm']!r}, CPU {h['loss']!r} "
                 f"{h['grad_norm']!r} (limits rel {TRAIN_LOSS_REL}, "
                 f"{TRAIN_GNORM_REL})")
    return errs


def _train_main() -> dict:
    """`launch.train.main` at full width on the card (the counts at 0 just
    before it): 40 steps, a checkpoint every 10, a failure at step 25,
    the fabric planned first on the card; then the plan's three
    topologies scored on the card against the numpy DES, and fill_maxmin
    at the job DAG's CSR against its plain version."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    from repro_torch.launch import train
    _reset_counts()
    with tempfile.TemporaryDirectory() as ckdir:
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            out = train.main([
                "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                "--ckpt-every", str(TRAIN_CKPT_EVERY),
                "--simulate-failure", str(TRAIN_FAIL_AT), "--plan-topology",
                "--log-every", "5", "--ckpt-dir", ckdir])
        wall = time.perf_counter() - t0
        ckpts = sorted(p.name for p in Path(ckdir).iterdir())
    c = _counts()
    for line in text.getvalue().strip().splitlines():
        log(line)
    losses = out["losses"]
    first = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    n_replay = TRAIN_FAIL_AT - first
    replay_err = max(abs(a - b) / abs(b) for a, b in zip(
        losses[TRAIN_FAIL_AT:TRAIN_FAIL_AT + n_replay],
        losses[first:TRAIN_FAIL_AT]))
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"[train] main: {out['steps']} steps, {out['restarts']} restarts, "
        f"{len(losses)} steps run ({n_replay} replayed), {wall:.1f} s in "
        f"all, checkpoints {ckpts}; replays vs first run rel err "
        f"{replay_err:.3e} (limit {TRAIN_REPLAY_REL}); loss first 5 "
        f"{head:.4f} -> last 5 {tail:.4f}; --plan-topology: "
        f"{c['trips']:.0f} trips, {c['maxmin']} fill_maxmin launches")
    on_card = all(t.is_cuda for t in _state_tensors(out["state"]).values())
    if out["restarts"] != 1 or out["steps"] != TRAIN_STEPS or \
            len(losses) != TRAIN_STEPS + n_replay:
        fail(f"[train] main: {out['restarts']} restarts (1 injected), "
             f"{out['steps']} steps, {len(losses)} run")
    if replay_err > TRAIN_REPLAY_REL:
        fail(f"[train] replays differ from their first run: {replay_err}")
    if not all(math.isfinite(x) for x in losses) or not tail < head:
        fail(f"[train] losses: first 5 {losses[:5]}, last 5 {losses[-5:]}")
    if not on_card:
        fail("[train] a state tensor left the card")
    if c["maxmin"] != c["trips"] + c["idle"] or c["maxmin"] == 0:
        fail(f"[train] --plan-topology: {c['maxmin']} fill_maxmin launches "
             f"for {c['trips']:.0f} trips")
    out["maxmin"] = c["maxmin"]
    plan = out.pop("plan")
    dag = train.topology_dag(TRAIN_ARCH, TRAIN_SEQ)
    _no_worse("train", TRAIN_ARCH, plan)
    xs = [r.x for r in plan.values()]
    _card_vs_numpy("train", f"{TRAIN_ARCH}'s {len(xs)} method topologies",
                   dag, xs, range(len(xs)))
    _maxmin_at_dag("train", TRAIN_ARCH, dag, np.random.default_rng(7))
    return out


def _train_steady(state: dict) -> None:
    """Steady steps of the trained full-width state (no checkpoint, no
    replay): ms per step by the host clock around synchronize, tokens/s,
    peak allocated memory, the state's bytes, one step's launches, device
    busy time and idle share, the step's bounds; then one checkpoint's
    save and restore seconds."""
    import tempfile
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    cfg = REGISTRY[TRAIN_ARCH].config
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=max(TRAIN_STEPS // 20, 5))
    step = ts.make_train_step(cfg, ocfg, remat=False)
    batches = [_train_batch(cfg, TRAIN_STEPS + i, TRAIN_BATCH, TRAIN_SEQ,
                            "cuda") for i in range(TRAIN_TIMED_STEPS + 2)]
    state, _ = step(state, batches[-1])     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for b in batches[:TRAIN_TIMED_STEPS]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    params = list(state["params"].parameters())
    n_params = sum(p.numel() for p in params)
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    mv_bytes = sum(t.numel() * t.element_size()
                   for t in (*state["opt"]["m"].values(),
                             *state["opt"]["v"].values()))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = sorted(walls)[len(walls) // 2]
    log(f"[train] {TRAIN_ARCH} steady steps (batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, float32): ms per step "
        f"{', '.join(f'{w:.3f}' for w in walls)} (median {ms:.3f}); "
        f"{tokens / ms * 1e3:.1f} tokens/s; peak {peak} B allocated; "
        f"parameters {n_params} ({p_bytes} B), m and v {mv_bytes} B")
    def traced():
        nonlocal state
        state, _ = step(state, batches[TRAIN_TIMED_STEPS])

    prof = _profile(traced)
    syncs = _host_syncs(traced)
    raw = prof.profiler.kineto_results.events()     # see _busy_s
    dev = [ev for ev in raw
           if ev.device_type() == torch.autograd.DeviceType.CUDA]
    launches = sum(ev.name() == "cudaLaunchKernel" for ev in raw)
    busy_ms = _busy_s(prof) * 1e3
    flop_ms = 6 * n_params * tokens / F32_PEAK * 1e3
    hbm_ms = 7 * p_bytes / HBM_RATE * 1e3
    log(f"[train] one step traced: {launches} cudaLaunchKernel calls, "
        f"{len(dev)} device kernels and copies, device busy "
        f"{busy_ms:.3f} ms of the median {ms:.3f} ms: idle share "
        f"{max(0.0, 1 - busy_ms / ms):.4f}; {syncs} host syncs in a step"
        if dev else
        f"[train] one step traced: {launches} cudaLaunchKernel calls; "
        f"device time not measured (no device events in the trace); "
        f"{syncs} host syncs in a step")
    log(f"[train] bounds: 6 x {n_params} parameters x {tokens} tokens at "
        f"{F32_PEAK:.3g} FLOP/s (TF32 off) {flop_ms:.3f} ms; the update's "
        f"7 parameter-sized passes ({7 * p_bytes} B) at {HBM_RATE:.3g} B/s "
        f"{hbm_ms:.3f} ms; the step {ms / max(flop_ms, hbm_ms):.2f}x the "
        f"larger")
    with tempfile.TemporaryDirectory() as ckdir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(ckdir, 0, state)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _, _ = ckpt.restore(path, state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in Path(path).iterdir())
    want, got = _state_tensors(state), _state_tensors(back)
    same = sorted(got) == sorted(want) and all(
        torch.equal(t, want[n]) for n, t in got.items())
    on_card = all(t.is_cuda for t in got.values())
    log(f"[train] full-width checkpoint ({disk} B on disk): save "
        f"{t_save:.3f} s, restore {t_restore:.3f} s, restored state "
        f"{'equal' if same else 'DIFFERENT'}, on the card {on_card}")
    if not same or not on_card:
        fail("[train] the full-width checkpoint did not restore")


def phase_train() -> float:
    """LM training on the card: `launch.train.main` at full width with a
    failure and its replay, steady steps timed, a checkpoint's save and
    restore, the card against the CPU, the other families at full width
    and accumulation; returns main's first loss."""
    import gc
    import torch
    from repro_torch.configs import REGISTRY
    t_phase = time.perf_counter()
    log(f"[train] card: {_card()}")
    out = _train_main()
    first_loss = out["losses"][0]
    state = out.pop("state")
    del out
    _train_steady(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    b, s, n = TRAIN_CPU_SHAPE
    t0 = time.perf_counter()
    (card, _), (host, _) = _train_pair(REGISTRY[TRAIN_ARCH].config, b, s, n)
    errs = _check_card_vs_cpu(TRAIN_ARCH, card, host)
    log(f"[train] {TRAIN_ARCH} full width, card vs CPU from one state, "
        f"batch {b} x seq {s}, {n} steps: loss and grad norm rel err "
        f"{', '.join(f'{e:.3e}' for e in errs)} "
        f"({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    errs = {}
    for arch in sorted(REGISTRY):
        cfg = REGISTRY[arch].config.reduced()
        (card, cs), (host, _) = _train_pair(cfg, 2, 16, TRAIN_REDUCED_STEPS)
        errs[arch] = max(_check_card_vs_cpu(f"{arch} (reduced)", card,
                                            host))
        if not all(t.is_cuda for t in _state_tensors(cs).values()):
            fail(f"[train] {arch}: a state tensor left the card")
    log(f"[train] the ten architectures reduced, card vs CPU, "
        f"{TRAIN_REDUCED_STEPS} steps: max rel err "
        f"{', '.join(f'{a} {e:.3e}' for a, e in errs.items())}")

    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    for arch in TRAIN_FAMILIES:
        cfg = REGISTRY[arch].config
        ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=5)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = ts.init_train_state(
            cfg, ocfg, device="cuda", dtype=torch.float32,
            generator=torch.Generator(device="cuda").manual_seed(0))
        step = ts.make_train_step(cfg, ocfg, remat=False)
        walls, metrics = [], []
        for i in range(TRAIN_FAMILY_STEPS):
            batch = _train_batch(cfg, i, TRAIN_BATCH, TRAIN_SEQ, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        losses = ", ".join(f"{m['loss']:.4f}" for m in metrics)
        norms = ", ".join(f"{m['grad_norm']:.3f}" for m in metrics)
        log(f"[train] {arch} full width, batch {TRAIN_BATCH} x seq "
            f"{TRAIN_SEQ}: losses {losses}; grad norms {norms}; ms per step "
            f"{', '.join(f'{w:.3f}' for w in walls)} (the first cold); "
            f"peak {peak} B allocated")
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for m in metrics):
            fail(f"[train] {arch}: non-finite loss or grad norm {metrics}")
        del state, step
    gc.collect()
    torch.cuda.empty_cache()

    cfg = REGISTRY[TRAIN_ARCH].config.reduced()
    ocfg = O.AdamWConfig(lr=1e-3, grad_clip=0.0)
    base = ts.init_train_state(
        cfg, ocfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(2))
    batch = _train_batch(cfg, 0, 8, 16, "cuda")
    res = {}
    for accum in (1, TRAIN_ACCUM):
        st, m = ts.make_train_step(cfg, ocfg, accum_steps=accum,
                                   remat=False)(_state_to(base, "cuda"),
                                                batch)
        res[accum] = (float(m["loss"]), st["params"].state_dict())
    loss_err = abs(res[1][0] - res[TRAIN_ACCUM][0]) / abs(res[1][0])
    p_err = max(float((res[1][1][k] - v).abs().max())
                for k, v in res[TRAIN_ACCUM][1].items())
    log(f"[train] {cfg.name} on the card, accum_steps {TRAIN_ACCUM} vs 1 "
        f"(batch 8 x seq 16): loss rel err {loss_err:.3e} (limit "
        f"{TRAIN_ACCUM_LOSS_REL}), parameters max abs diff {p_err:.3e} "
        f"(limit {TRAIN_ACCUM_PARAM_ABS})")
    if loss_err > TRAIN_ACCUM_LOSS_REL or p_err > TRAIN_ACCUM_PARAM_ABS:
        fail(f"[train] accumulation: loss {loss_err}, parameters {p_err}")
    log(f"[train] phase wall {time.perf_counter() - t_phase:.1f} s")
    return first_loss


_RING = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, n, xfile, out, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    from repro_torch.distributed.compression import ring_allreduce_int8
    total, res = ring_allreduce_int8(torch.from_numpy(np.load(xfile)[rank]))
    np.savez(f"{out}.{rank}.npz", total=total.numpy(), res=res.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    n = int(sys.argv[1])
    mp.spawn(rank_main, args=(n, *sys.argv[2:5]), nprocs=n)
"""


_SHARDED = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor


def whole(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def rank_main(rank, n, out, store, train_args, serve_args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    from repro_torch.launch import serve, train
    r = train.main(json.loads(train_args))
    s = serve.main(json.loads(serve_args))
    arrays = {f"param/{k}": whole(p)
              for k, p in r["state"]["params"].named_parameters()}
    np.savez(f"{out}.{rank}.npz", losses=np.asarray(r["losses"]),
             tokens=s["tokens"].numpy(), logits=whole(s["logits"]),
             **arrays)
    dist.destroy_process_group()


if __name__ == "__main__":
    n = int(sys.argv[1])
    mp.spawn(rank_main, args=(n, *sys.argv[2:6]), nprocs=n)
"""


def _dist_sharded() -> None:
    """(f): train.main and serve.main with --model-parallel 2 on
    DIST_MP_RANKS gloo ranks of the host against the same entry points
    run alone (the plain path), each rank's results gathered.  Runs with
    no process group in this process."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import serve, train
    mp_args = ["--arch", TRAIN_ARCH, "--model-parallel", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "sharded.py").write_text(_SHARDED)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, str(tmp / "sharded.py"), str(DIST_MP_RANKS),
             str(tmp / "out"), str(tmp / "store"),
             json.dumps([*mp_args, *DIST_MP_TRAIN]),
             json.dumps([*mp_args, *DIST_MP_SERVE])],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"[dist] the sharded launchers failed: "
                 f"{run.stderr[-3000:]}")
        ranks = [dict(np.load(tmp / f"out.{r}.npz"))
                 for r in range(DIST_MP_RANKS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            plain = train.main(["--arch", TRAIN_ARCH, *DIST_MP_TRAIN])
            served = serve.main(["--arch", TRAIN_ARCH, *DIST_MP_SERVE])
    finally:
        torch.set_num_threads(threads)
    params = {k: p.detach().numpy()
              for k, p in plain["state"]["params"].named_parameters()}
    loss_err = max(float(np.abs(r["losses"] - plain["losses"]).max())
                   for r in ranks)
    param_err = max(float(np.abs(r[f"param/{k}"] - p).max())
                    for r in ranks for k, p in params.items())
    same_tok = all(np.array_equal(r["tokens"], served["tokens"].numpy())
                   for r in ranks)
    logit_err = max(float(np.abs(r["logits"] - served["logits"].numpy())
                          .max()) for r in ranks)
    ok = same_tok and all(
        np.allclose(r["losses"], plain["losses"], rtol=DIST_MP_REL,
                    atol=DIST_MP_LOSS_ABS)
        and np.allclose(r["logits"], served["logits"].numpy(),
                        rtol=DIST_MP_REL, atol=DIST_MP_REL)
        and all(np.allclose(r[f"param/{k}"], p, rtol=DIST_MP_REL,
                            atol=DIST_MP_PARAM_ABS)
                for k, p in params.items()) for r in ranks)
    log(f"[dist] train.main and serve.main {TRAIN_ARCH} reduced, "
        f"--model-parallel 2 on {DIST_MP_RANKS} gloo ranks (torch "
        f"{torch.__version__}): losses {ranks[0]['losses'].tolist()} vs "
        f"alone {plain['losses']} (max error {loss_err:.3e}), parameters "
        f"max error {param_err:.3e}, tokens "
        f"{'equal' if same_tok else 'DIFFERENT'}, logits max error "
        f"{logit_err:.3e}; {wall:.1f} s")
    if not ok:
        fail("[dist] the sharded launchers differ from the plain path")


def _dist_serve_train(mesh, serve_first, train_first: float) -> None:
    """(a): serve.main and train.main at full width through the 1 x 1
    mesh against [serve]'s and [train]'s results and a plain step loop."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.launch import serve, train
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve.main(["--arch", TRAIN_ARCH, "--batch", str(SERVE_BATCH),
                          "--prompt-len", str(SERVE_PROMPT),
                          "--decode-steps", str(SERVE_STEPS),
                          "--model-parallel", "1"])
    same_tok = torch.equal(out["tokens"], serve_first[0])
    same_logits = torch.equal(out["logits"].cpu(), serve_first[1])
    log(f"[dist] serve.main {TRAIN_ARCH} through the 1 x 1 mesh: tokens "
        f"{'equal' if same_tok else 'DIFFERENT'}, last logits "
        f"{'equal' if same_logits else 'DIFFERENT'} to [serve]'s, bit for "
        f"bit")
    if not (same_tok and same_logits):
        fail("[dist] serve.main on the mesh differs from [serve]")
    del out
    cfg = REGISTRY[TRAIN_ARCH].config
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run = train.main(["--arch", TRAIN_ARCH, "--steps",
                              str(DIST_TRAIN_STEPS), "--log-every", "100",
                              "--model-parallel", "1"])
        ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=5)
        state = ts.init_train_state(
            cfg, ocfg, device="cuda", dtype=torch.float32,
            generator=torch.Generator(device="cuda").manual_seed(0))
        step = ts.make_train_step(cfg, ocfg, remat=False)
        losses = []
        for i in range(DIST_TRAIN_STEPS):
            state, m = step(state, _train_batch(cfg, i, TRAIN_BATCH,
                                                TRAIN_SEQ, "cuda"))
            losses.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    want = dict(state["params"].named_parameters())
    same_p = all(torch.equal(p, want[n]) and not hasattr(p, "placements")
                 for n, p in run["state"]["params"].named_parameters())
    log(f"[dist] train.main {TRAIN_ARCH} through the 1 x 1 mesh, "
        f"{DIST_TRAIN_STEPS} steps (deterministic kernels): losses "
        f"{run['losses']}; the plain step loop's {losses}; parameters "
        f"{'equal' if same_p else 'DIFFERENT'}; first loss "
        f"{run['losses'][0]!r} vs [train]'s {train_first!r}")
    if run["losses"] != losses or not same_p or \
            run["losses"][0] != train_first:
        fail("[dist] train.main on the mesh differs from the plain step")
    del run, state, step, want


def _dist_ring() -> None:
    """(b): the int8 ring at world size 1 on the card (NCCL), then on
    DIST_RING_RANKS gloo ranks on the host."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import mean_grads_int8
    g = {"w": torch.randn(64, 33, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))}
    means, res = mean_grads_int8(g)
    ok1 = torch.equal(means["w"], g["w"]) and \
        not bool(res["w"].any()) and res["w"].is_cuda
    log(f"[dist] mean_grads_int8 on the card, {dist.get_backend()} world "
        f"of {dist.get_world_size()}: gradients "
        f"{'unchanged' if ok1 else 'CHANGED'}, residual zero {ok1}")
    if not ok1:
        fail("[dist] mean_grads_int8 at world size 1")
    x = np.random.default_rng(0).standard_normal(
        (DIST_RING_RANKS, DIST_RING_SIZE)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "x.npy", x)
        (tmp / "ring.py").write_text(_RING)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, str(tmp / "ring.py"), str(DIST_RING_RANKS),
             str(tmp / "x.npy"), str(tmp / "out"), str(tmp / "store")],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"[dist] the gloo ring failed: {run.stderr[-2000:]}")
        outs = [np.load(tmp / f"out.{r}.npz") for r in range(DIST_RING_RANKS)]
    total = np.stack([o["total"] for o in outs])
    res = np.stack([o["res"] for o in outs])
    scale = np.abs(x).max() * DIST_RING_RANKS / 127
    err = float(np.abs(total - x.sum(axis=0)[None]).max())
    agree = all(np.array_equal(total[0], t) for t in total)
    log(f"[dist] int8 ring on {DIST_RING_RANKS} gloo ranks, x of "
        f"{x.shape} (seed 0): max error to the exact sum {err:.3e} (bound "
        f"{4 * scale + 1e-5:.3e}), ranks agree {agree}, max |residual| "
        f"{float(np.abs(res).max()):.3e} (bound {scale + 1e-6:.3e}); "
        f"{wall:.1f} s")
    if not (err <= 4 * scale + 1e-5 and agree
            and np.abs(res).max() <= scale + 1e-6):
        fail("[dist] the int8 ring misses the reference test's bounds")


def _dist_predict(mesh) -> None:
    """(c): the dry run's prediction for [train]'s step on the 1 x 1 mesh
    against the card."""
    import gc
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import REGISTRY, ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import costanalysis, dryrun
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    arch = REGISTRY[TRAIN_ARCH]
    cfg = arch.config
    shape = ShapeSpec("train_8x128", "train", TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    cell = dryrun.run_cell(TRAIN_ARCH, arch, shape, mesh, "1x1_cuda",
                           dtype=torch.float32)
    if cell["status"] != "ok":
        fail(f"[dist] run_cell: {cell.get('error')}")
    mem = cell["memory"]
    log(f"[dist] run_cell {TRAIN_ARCH} train batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ} float32 on the 1 x 1 mesh "
        f"({time.perf_counter() - t0:.1f}"
        f" s on meta): accum_steps {cell['accum_steps']}, arguments "
        f"{mem['argument_bytes']} B, outputs {mem['output_bytes']} B, "
        f"temporaries {mem['temp_bytes']} B, {cell['flops_per_device']:.0f} "
        f"FLOPs, {cell['bytes_per_device']:.0f} bytes, "
        f"{cell['collectives']['count']:.0f} collectives")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
    ocfg = O.AdamWConfig(state_dtype=dryrun._state_dtype(cfg))
    state = ts.init_train_state(
        cfg, ocfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    state = shd.place(state, shd.named(
        shd.tree_specs(state, mesh, "state", cfg=cfg), mesh))
    batch = {k: v.to(torch.int32) for k, v in
             _train_batch(cfg, 0, TRAIN_BATCH, TRAIN_SEQ, "cuda").items()}
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    req = torch.cuda.memory_stats()["requested_bytes.all.current"] - base_req
    exact = costanalysis.local_bytes((state, batch))
    log(f"[dist] placed on the card: {exact} B in the state's and batch's "
        f"tensors, the allocator's requested bytes {req}, memory_allocated "
        f"{alloc} (its blocks, rounded up); predicted arguments "
        f"{mem['argument_bytes']} B")
    if not mem["argument_bytes"] == exact == req:
        fail(f"[dist] argument bytes: predicted {mem['argument_bytes']}, "
             f"tensors {exact}, requested {req}")
    step = ts.make_train_step(cfg, ocfg, accum_steps=cell["accum_steps"],
                              remat=True, mesh=mesh,
                              data_axes=shd.data_axes(mesh))
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    flops = fc.get_total_flops()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    pred = mem["temp_bytes"] + mem["argument_bytes"]
    log(f"[dist] the step on the card (accum {cell['accum_steps']}, remat):"
        f" FlopCounterMode {flops} FLOPs, predicted "
        f"{cell['flops_per_device']:.0f}: {flops / F32_PEAK * 1e3:.3f} ms "
        f"at {F32_PEAK:.3g} FLOP/s (one step {wall_ms:.3f} ms); peak "
        f"{peak} B allocated above the baseline, predicted temporaries + "
        f"arguments {pred} B, ratio {pred / peak:.4f}")
    if flops != cell["flops_per_device"]:
        fail(f"[dist] FLOPs: card {flops}, predicted "
             f"{cell['flops_per_device']}")
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()


def _dist_dryrun() -> None:
    """(d): the 20 quick cells on the 2 x 16 x 16 mesh, in a process of
    its own (the fake process group is process-global), each cell's
    FLOPs and collective bytes per device against the reference's
    (`DIST_REF`) within DIST_FLOPS_BOUND and DIST_BYTES_BOUND."""
    out_dir = ROOT / "build" / "dist_dryrun"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--quick",
         "--arch", ",".join(DIST_QUICK_ARCHS),
         "--shape", ",".join(DIST_QUICK_SHAPES), "--mesh", "multi",
         "--out", str(out_dir)], capture_output=True, text=True,
        timeout=600, cwd=ROOT, env={**os.environ,
                                    "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    cells = [json.loads((out_dir / f"multi_pod_2x16x16__{a}__{s}.json")
                        .read_text()) for a, s in DIST_REF
             if (out_dir / f"multi_pod_2x16x16__{a}__{s}.json").exists()]
    over = []
    for c in cells:
        if c["status"] != "ok":
            continue
        ref_flops, ref_bytes = DIST_REF[(c["arch"], c["shape"])]
        flops, coll = c["flops_per_device"], c["collectives"]["total"]
        fx, bx = flops / ref_flops, coll / ref_bytes
        log(f"[dist] dry run {c['mesh']} {c['arch']} {c['shape']}: "
            f"{c['devices']} devices, FLOPs/device {flops:.0f} (reference "
            f"{ref_flops}, x{fx:.4f}), collective bytes/device {coll:.0f} "
            f"(reference {ref_bytes}, x{bx:.4f}), arguments "
            f"{c['memory']['argument_bytes']} B, collectives "
            f"{json.dumps(c['collectives'])}")
        if fx > DIST_FLOPS_BOUND or bx > DIST_BYTES_BOUND:
            over.append(f"{c['arch']} {c['shape']} FLOPs x{fx:.4f} bytes "
                        f"x{bx:.4f}")
    errors = sum(c["status"] == "error" for c in cells)
    log(f"[dist] dry run, {len(cells)} quick cells: "
        f"{sum(c['status'] == 'ok' for c in cells)} ok, {errors} errors, "
        f"{len(over)} over the bounds (FLOPs x{DIST_FLOPS_BOUND}, bytes "
        f"x{DIST_BYTES_BOUND} the reference's) ({wall:.1f} s)")
    if run.returncode != 0 or errors or len(cells) != len(DIST_REF) or \
            any(c.get("devices") != 512 for c in cells):
        fail(f"[dist] dry run: rc {run.returncode}: "
             f"{run.stdout[-1500:]} {run.stderr[-1500:]}")
    if over:
        fail(f"[dist] dry run cells over the bounds: {over}")


def _dist_legacy_ga() -> int:
    """(e): the legacy GA at gpt-7b on the card; returns its fill_maxmin
    launches."""
    import numpy as np
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core import _ga_legacy as legacy
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.ga import GAOptions, delta_fast
    from repro_torch.core.schedule import build_comm_dag
    dag = build_comm_dag(make_job(PAPER_WORKLOADS["gpt-7b"]), 400.0)
    kw = dict(seed=0, max_generations=DIST_GA_GENERATIONS, patience=10**9,
              time_limit=1e9)
    _reset_counts()
    t0 = time.perf_counter()
    old = legacy.delta_fast(dag, legacy.GAOptions(**kw))
    wall = time.perf_counter() - t0
    c = _counts()
    new = delta_fast(dag, GAOptions(**kw))
    exact = simulate(DESProblem(dag), old.x).makespan
    log(f"[dist] legacy GA gpt-7b ({dag.num_tasks} tasks), "
        f"{old.generations} generations of {legacy.GAOptions().pop_size} "
        f"genomes on the card: {wall:.1f} s, {old.evaluations} "
        f"evaluations, {c['trips']:.0f} trips, {c['maxmin']} fill_maxmin "
        f"launches; makespan {old.makespan!r} (numpy DES {exact!r}), "
        f"{int(old.x.sum())} ports; the vectorized GA {new.makespan!r}")
    if c["maxmin"] != c["trips"] + c["idle"] or c["maxmin"] == 0:
        fail(f"[dist] legacy GA: {c['maxmin']} fill_maxmin launches for "
             f"{c['trips']:.0f} trips")
    if old.makespan != exact or not new.makespan <= old.makespan * \
            (1 + 1e-9):
        fail(f"[dist] legacy GA makespan {old.makespan} (numpy {exact}), "
             f"vectorized {new.makespan}")
    _card_vs_numpy("dist", "the legacy GA's topology", dag, [old.x], [0])
    return c["maxmin"]


def phase_dist(serve_first, train_first: float) -> int:
    """The distributed tools on the card, (a)-(e) of the module's
    docstring; returns the legacy GA's fill_maxmin launches."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    log(f"[dist] card: {_card()}")
    mesh = make_host_mesh(1, "cuda")
    log(f"[dist] mesh {mesh}: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, axes {shd.axis_sizes(mesh)}")
    if dist.get_backend() != "nccl" or shd.axis_sizes(mesh) != \
            {"data": 1, "model": 1}:
        fail("[dist] make_host_mesh(1, 'cuda') is not a 1 x 1 NCCL mesh")
    _dist_serve_train(mesh, serve_first, train_first)
    _dist_ring()
    _dist_predict(mesh)
    _dist_dryrun()
    launches = _dist_legacy_ga()
    dist.destroy_process_group()
    _dist_sharded()
    log(f"[dist] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def _phase_memory_start() -> int:
    """Zero the peak of the device memory allocated; return what is
    allocated now."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _phase_memory(name: str, before: int) -> None:
    """The phase's peak device memory, what it leaves allocated once its
    garbage is collected, and the trip graphs the engine cache keeps."""
    import gc
    import torch
    from repro_torch.core import des_torch
    gc.collect()
    log(f"[mem] {name}: peak {torch.cuda.max_memory_allocated()} B "
        f"allocated, {before} -> {torch.cuda.memory_allocated()} B "
        f"allocated across the phase, {torch.cuda.memory_reserved()} B "
        f"reserved; {len(des_torch._GRAPHS)} trip graphs kept")


def main() -> int:
    t_start = time.perf_counter()
    walls: dict[str, float] = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        before = _phase_memory_start()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        _phase_memory(name, before)
        return out
    phase_device()
    import torch
    loop_syncs = timed("sentinel", phase_sentinel)
    timed("build", phase_build)
    dag = _megatron_462b()
    dags = (dag, *(_megatron_462b(s) for s in ROBUST_SEQ_LENS[1:]))
    mb_dags = (dag, *(_megatron_462b(microbatches=m)
                      for m in ROBUST_MICROBATCHES[1:]))
    jamba = _registry_dag(JAMBA)
    t0 = time.perf_counter()
    waterfill = kernel_waterfill()
    maxmin = kernel_maxmin(dag, jamba)
    kernel_maxmin_members([("seq-len pair", dags, False),
                           ("microbatch pair", mb_dags, True)])
    tclosure, closure_steps = kernel_tclosure(dag)
    maxplus, paths_steps = kernel_maxplus(dag)
    walls["kernels"] = round(time.perf_counter() - t0, 1)
    timed("des", phase_des, dag, loop_syncs)
    maxmin["launches"], waterfill["launches"], x = timed("plan", phase_plan,
                                                         dag)
    timed("plan gpt-7b", phase_small_parity)
    tclosure["launches"], t_up = timed("xbound", phase_xbound, dag,
                                       closure_steps)
    maxplus["launches"] = timed("paths", phase_paths, dag, t_up,
                                paths_steps)
    ens = timed("robust", phase_robust, dags, mb_dags)
    timed("failsafe", phase_failsafe, dag)
    timed("milp", phase_milp)
    timed("resilient", phase_resilient)
    timed("trim", phase_trim, dag, x, ens)
    timed("planes", phase_planes, dag)
    fleet_matvec = timed("fleet", phase_fleet)
    timed("cli", phase_cli, jamba)
    timed("examples", phase_examples)
    serve_first = timed("serve", phase_serve)
    train_first = timed("train", phase_train)
    maxmin["dist_launches"] = timed("dist", phase_dist, serve_first,
                                    train_first)
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s"
        f", the build included; s per phase {walls}")
    log(json.dumps({"kernels": [waterfill, maxmin, tclosure, maxplus,
                                fleet_matvec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
