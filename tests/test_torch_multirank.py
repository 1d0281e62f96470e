"""The launchers' sharded step on more than one rank: `launch.train.main`
and `launch.serve.main` with `--model-parallel 2` on 4 gloo ranks of the
host, a (data 2, model 2) mesh, as a `torchrun --nproc-per-node 4` launch
runs them (each rank joins the process group before `main`, which then
places the state, the cache and every batch on the mesh by the sharding
rules), against the same entry points in a process of their own (no
process group: the plain step loop).

The ranks run in a process of their own (a process group is
process-global).  Every rank's losses, tokens, logits and final
parameters (gathered) must agree with the plain run's.  Losses within
rel 1e-5 / abs 1e-6 (float32; the mesh sums the batch and the
model-sharded products in another order); tokens exactly; logits within
1e-5.  Parameters within rel 1e-5 / abs `PARAM_ATOL`: AdamW's first
steps move every element by about lr * sign(g), 6e-4 in all over the two
steps here (lr 1e-3 warmed up over 5 steps), so an element whose
gradient is within rounding of 0 can take a step of the other sign; a
shard computed wrongly would move whole rows by that much, and the loss
of the second step would show it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve, train

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["--reduce", "--steps", "2", "--batch", "4", "--seq", "8",
         "--log-every", "100", "--device", "cpu"]
SERVE = ["--reduce", "--batch", "4", "--prompt-len", "8",
         "--decode-steps", "2", "--device", "cpu"]
MP = ["--model-parallel", "2"]
MP4 = ["--model-parallel", "4"]
PARAM_ATOL = 1e-4

_RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.tensor import DTensor

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    def rank_main(rank, out, store, runs):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=4)
        from repro_torch.launch import serve, train
        arrays, meta = {}, {}
        for name, argv in json.loads(runs):
            if name == "train":
                r = train.main(argv)
                meta["losses"] = r["losses"]
                for n, p in r["state"]["params"].named_parameters():
                    arrays[f"param/{n}"] = whole(p)
            else:
                r = serve.main(argv)
                arrays["tokens"] = r["tokens"].numpy()
                arrays["logits"] = whole(r["logits"])
        np.savez(f"{out}.{rank}.npz", **arrays)
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(meta, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=tuple(sys.argv[1:4]), nprocs=4)
""")


def _four_ranks(tmp_path, runs: list) -> list[tuple[dict, dict]]:
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(script), str(out), str(tmp_path / "store"),
         json.dumps(runs)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [(dict(np.load(f"{out}.{r}.npz")),
             json.loads(Path(f"{out}.{r}.json").read_text()))
            for r in range(4)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "mamba2-130m"])
def test_train_main_on_four_ranks_matches_plain_loop(tmp_path, arch):
    """Dense, MoE and SSM training on the (2, 2) mesh: granite
    accumulates two microbatches per step, and qwen3 also serves there
    (prefill and decode through the placed cache)."""
    argv = ["--arch", arch, *TRAIN]
    if arch == "granite-moe-1b-a400m":
        argv += ["--accum", "2"]
    runs = [("train", [*argv, *MP])]
    if arch == "qwen3-0.6b":
        runs.append(("serve", ["--arch", arch, *SERVE, *MP]))
    ranks = _four_ranks(tmp_path, runs)

    torch.set_num_threads(1)
    plain = train.main(argv)
    params = {n: p.detach().numpy()
              for n, p in plain["state"]["params"].named_parameters()}
    for arrays, meta in ranks:
        np.testing.assert_allclose(meta["losses"], plain["losses"],
                                   rtol=1e-5, atol=1e-6)
        assert {k[6:] for k in arrays if k.startswith("param/")} == \
            set(params)
        for n, p in params.items():
            np.testing.assert_allclose(arrays[f"param/{n}"], p, rtol=1e-5,
                                       atol=PARAM_ATOL, err_msg=n)
    if arch == "qwen3-0.6b":
        s = serve.main(["--arch", arch, *SERVE])
        for arrays, _ in ranks:
            np.testing.assert_array_equal(arrays["tokens"],
                                          s["tokens"].numpy())
            np.testing.assert_allclose(arrays["logits"],
                                       s["logits"].numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3",
                                  "llama-3.2-vision-11b", "mamba2-130m"])
def test_serve_main_on_four_model_ranks_matches_plain(tmp_path, arch):
    """Serving on a (data 1, model 4) mesh, where the 2 or 4 KV heads do
    not divide the model axis: the KV cache and the K/V projections of
    self- and cross-attention (whisper's encoder frames, the vision
    model's image patches) fall to head_dim shards, and the table is
    looked up vocab-parallel; mamba2's prefill scans on shards of its 16
    SSM heads and writes its conv and SSM states into the sharded cache
    that the decode steps read."""
    ranks = _four_ranks(tmp_path, [("serve", ["--arch", arch, *SERVE,
                                              *MP4])])
    torch.set_num_threads(1)
    s = serve.main(["--arch", arch, *SERVE])
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["tokens"], s["tokens"].numpy())
        np.testing.assert_allclose(arrays["logits"], s["logits"].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_train_main_on_four_model_ranks_matches_plain(tmp_path):
    """mamba2 training on a (data 1, model 4) mesh: the chunked scan on
    shards of the 16 SSM heads, the chunk scores on shards of the chunk's
    rows, and the tied head over the vocab-parallel table.  136 tokens:
    two chunks of 128 (the state passed between them, the last one
    padded), so every rank's rows of a chunk hold real positions."""
    argv = ["--arch", "mamba2-130m", *TRAIN, "--seq", "136"]
    ranks = _four_ranks(tmp_path, [("train", [*argv, *MP4])])
    torch.set_num_threads(1)
    plain = train.main(argv)
    params = {n: p.detach().numpy()
              for n, p in plain["state"]["params"].named_parameters()}
    for arrays, meta in ranks:
        np.testing.assert_allclose(meta["losses"], plain["losses"],
                                   rtol=1e-5, atol=1e-6)
        for n, p in params.items():
            np.testing.assert_allclose(arrays[f"param/{n}"], p, rtol=1e-5,
                                       atol=PARAM_ATOL, err_msg=n)


_EINSUM = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    # (equation, operand shapes, placements on the (data, model) mesh of
    # each operand: "r" replicate, "p" partial sum, an int: shard that dim)
    CASES = [
        # column-parallel projection, weight on head_dim (heads do not
        # divide the model axis)
        ("bsd,dhk->bshk", (4, 6, 8), (8, 3, 4), (0, "r"), ("r", 2)),
        # its row-parallel partner: head_dim contracted, partial sums
        ("bshk,hkd->bsd", (4, 6, 3, 4), (3, 4, 8), (0, 3), ("r", 1)),
        # attention scores, both operands sequence-sharded on model
        ("bqhd,bshd->bhqs", (4, 6, 2, 4), (4, 10, 2, 4), (0, 1), (0, 1)),
        # an FSDP weight (its input dim on data) meets a batch shard
        ("bsd,df->bsf", (4, 6, 8), (8, 6), (0, "r"), (0, 1)),
        # a partial operand, and a letter of one operand only
        ("bhd,bshd->bhs", (4, 2, 4), (4, 6, 2, 4), ("r", "p"), (0, 3)),
        ("bhpn,bn->bhp", (4, 2, 3, 6), (4, 6), (0, 1), ("r", "r")),
    ]

    def rank_main(rank, store):
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial,
                                              Replicate, Shard)
        from repro_torch.models import layers as L
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def put(t, spec):
            pl = [Replicate() if p in ("r", "p") else Shard(p)
                  for p in spec]
            d = DTensor.from_local(t, mesh, [Replicate()] * 2,
                                   run_check=False).redistribute(mesh, pl)
            if "p" in spec:       # the same values as a pending sum
                local = d.to_local() / 2
                d = DTensor.from_local(local, mesh, [
                    Partial() if p == "p" else q
                    for p, q in zip(spec, pl)], run_check=False)
            return d

        g = torch.Generator().manual_seed(0)
        for eq, sa, sb, pa, pb in CASES:
            a = torch.randn(sa, generator=g, dtype=torch.float64)
            b = torch.randn(sb, generator=g, dtype=torch.float64)
            want = torch.einsum(eq, a, b)
            r = torch.randn(want.shape, generator=g, dtype=torch.float64)
            da = put(a, pa).detach().requires_grad_()
            db = put(b, pb).detach().requires_grad_()
            out = L.einsum(eq, da, db)
            (out * put(r, ("r", "r"))).sum().backward()
            a.requires_grad_()
            b.requires_grad_()
            (torch.einsum(eq, a, b) * r).sum().backward()
            for name, got, ref in (("out", out, want),
                                   ("grad a", da.grad, a.grad),
                                   ("grad b", db.grad, b.grad)):
                got = got.full_tensor()
                if got.shape != ref.shape or not torch.allclose(
                        got, ref, rtol=1e-12, atol=1e-12):
                    raise AssertionError(f"{eq} {pa} {pb}: {name}")
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(sys.argv[1],), nprocs=4)
""")


def test_sharded_einsum_matches_einsum_on_whole_tensors(tmp_path):
    """`layers.einsum` on DTensors of every placement the model's
    products meet (float64, within 1e-12): a shard of a letter both
    operands carry, of a letter only one carries (kept in the output,
    or contracted into a partial sum), two operands sharded on
    different letters of one mesh dim (the smaller gathered), and a
    partial operand (summed first)."""
    script = tmp_path / "einsum.py"
    script.write_text(_EINSUM)
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]


_LOOKUP = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    # (table shape, the table's placement on the model dim of the (data,
    # model) mesh: 0 vocab rows, 1 columns, "r" replicated)
    CASES = [((12, 6), 0), ((13, 6), 1), ((12, 6), "r")]

    def rank_main(rank, store):
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.models import layers as L
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def put(t, pl):
            return DTensor.from_local(t, mesh, [Replicate()] * 2,
                                      run_check=False).redistribute(mesh, pl)

        g = torch.Generator().manual_seed(0)
        for shape, where in CASES:
            table = torch.randn(shape, generator=g, dtype=torch.float64)
            # repeated tokens: their gradients add up in one row
            tokens = torch.randint(0, shape[0], (4, 5), generator=g)
            tokens[0, :2] = tokens[1, 0]
            r = torch.randn((4, 5, shape[1]), generator=g,
                            dtype=torch.float64)
            tp = [Replicate(), Replicate() if where == "r" else Shard(where)]
            dt = put(table, tp).detach().requires_grad_()
            out = L.embed_lookup(put(tokens, [Shard(0), Replicate()]), dt)
            (out * put(r, [Shard(0), Replicate()])).sum().backward()
            table.requires_grad_()
            (table[tokens] * r).sum().backward()
            for name, got, ref in (("rows", out, table[tokens]),
                                   ("grad", dt.grad, table.grad)):
                got = got.full_tensor()
                if got.shape != ref.shape or not torch.allclose(
                        got, ref, rtol=1e-12, atol=1e-12):
                    raise AssertionError(f"{shape} {where}: {name}")
            # on the model dim the gradient stays on the vocab shards (on
            # the data dim it is the batch shards' pending sum)
            if where == 0 and dt.grad.placements[1] != Shard(0):
                raise AssertionError(f"gradient on {dt.grad.placements}")
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(sys.argv[1],), nprocs=4)
""")


def test_sharded_lookup_matches_index_on_whole_tensors(tmp_path):
    """`layers.embed_lookup` on a (data 2, model 2) mesh against indexing
    the whole table (float64, within 1e-12): a vocab-sharded table (each
    rank's rows, a partial sum settled by one all-reduce; the gradient
    stays on the vocab shards), a column-sharded one (13 rows do not
    divide the axis) and a replicated one, with repeated tokens."""
    script = tmp_path / "lookup.py"
    script.write_text(_LOOKUP)
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_launchers_alone_create_no_process_group(tmp_path):
    """In a process of its own (no `torchrun` environment, no process
    group), train.main and serve.main run the plain path and leave no
    process group behind."""
    code = textwrap.dedent(f"""
        import torch.distributed as dist
        from repro_torch.launch import serve, train
        train.main({["--arch", "qwen3-0.6b", *TRAIN]!r})
        serve.main({["--arch", "qwen3-0.6b", *SERVE]!r})
        assert not dist.is_initialized()
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
