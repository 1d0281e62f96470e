"""Batched decode serving entry point (prefill + autoregressive loop).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        [--reduce] --batch 4 --prompt-len 64 --decode-steps 32

Parameters and cache are float32, drawn on `--device` (default cuda;
without a CUDA device, pass --device cpu) from a generator seeded with
`--seed`; the prompt (and the modality input of a vlm / encdec model)
comes from a CPU generator with the same seed.  Parameters, cache and
inputs are placed on a ("data", "model") mesh of the process group's
ranks (`launch.mesh.make_host_mesh(--model-parallel)`, when `torchrun`
started the process or a process group exists) by the sharding rules,
as the reference places them; in a process of its own they stay plain,
which on one device is what every placement would give.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import REGISTRY
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import launch_mesh
from repro_torch.models import model as M
from repro_torch.training import train_step as ts


def main(argv: list[str] | None = None) -> dict:
    """Prefill, then decode; prints the two `[serve]` lines and returns
    {"prefill_s", "decode_s", "tok_per_s", "tokens" (B, 1 + steps) int32,
    "logits" (the last step's), "param_bytes"}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and cache (cuda | cpu)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving runs on a CUDA device and none is "
                           "available; pass --device cpu to serve on the "
                           "CPU")
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    cfg = REGISTRY[args.arch].config
    if args.reduce:
        cfg = cfg.reduced()
    mesh = launch_mesh(args.model_parallel, device)

    def place(tree, kind, **kw):
        return tree if mesh is None else shd.place(tree, shd.named(
            shd.tree_specs(tree, mesh, kind, **kw), mesh))

    params = place(M.LM(cfg, dtype=torch.float32, device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(args.seed)), "params", cfg=cfg)
    max_len = args.prompt_len + args.decode_steps
    xl = cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens
    cache = M.init_cache(cfg, args.batch, max_len, dtype=torch.float32,
                         enc_len=xl, device=device)
    cache = place(cache, "cache")

    has_xkv = bool(xl)
    prefill = ts.make_prefill_step(cfg, has_xkv=has_xkv)
    decode = ts.make_decode_step(cfg)

    host = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=host).to(device)
    xkv = (torch.randn((args.batch, xl, cfg.d_model), generator=host)
           .to(device) if has_xkv else None)
    prompt, xkv = place([prompt, xkv], "batch")
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, prompt, xkv)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)

    t0 = time.perf_counter()
    out = [tok]
    for _ in range(args.decode_steps):
        tok, logits, cache = decode(params, cache, tok)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    total_tok = args.batch * args.decode_steps
    print(f"[serve] {cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{t_prefill*1e3:.0f}ms; decoded {total_tok} tokens in "
          f"{t_decode*1e3:.0f}ms "
          f"({total_tok/max(t_decode,1e-9):.1f} tok/s)")
    seq = _whole(torch.cat(out, dim=1)).cpu()
    logits = _whole(logits)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{cfg.name}: non-finite logits")
    print("[serve] sample token ids:", seq[0, :16].tolist())
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": total_tok / max(t_decode, 1e-9), "tokens": seq,
            "logits": logits,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters())}


def _whole(t: torch.Tensor) -> torch.Tensor:
    """`t`'s full value on every rank (a DTensor's, gathered)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


if __name__ == "__main__":
    main()
