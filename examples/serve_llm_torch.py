"""Batched serving on the PyTorch port: prefill + decode with KV/state
caches.

Serves a reduced-config architecture (any of the 10 via --arch) through
``repro_torch`` (``examples/serve_llm.py`` is the JAX package's): prefills
a batch of prompts, then greedily decodes new tokens, the serve path that
the decode_32k / long_500k dry-run shapes run.  The weights, prompts and
frame embeddings are drawn from seeded ``torch.Generator``s (not the
reference's ``jax.random`` draws).  ``--dtype bfloat16`` serves the smoke
config in bf16 with ``use_flash`` on and 64-wide heads (the bf16 kernel's
narrowest), so an attention arch's prefill launches the flash-attention
kernel on the card; the kernels' launch counts are printed at the end.

  PYTHONPATH=src python examples/serve_llm_torch.py --arch jamba-1.5-large-398b --tokens 16
  PYTHONPATH=src python examples/serve_llm_torch.py --arch qwen3-14b --dtype bfloat16
  PYTHONPATH=src python examples/serve_llm_torch.py --device cpu --tokens 4
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.models import init_params
from repro_torch.models.transformer import decode_step, prefill


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--dtype", default="", help="the smoke config's dtype unless given (bfloat16: flash on)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    if args.dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, dtype=args.dtype, use_flash=True, head_dim=max(64, cfg.d_head))
    elif args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    max_seq = args.prompt_len + args.tokens
    draws = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=draws, device=dev)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.randn((args.batch, cfg.n_audio_frames, cfg.d_model), generator=draws,
                                       device=dev).to(cfg.param_dtype)

    print(f"arch={cfg.name} (smoke variant, {cfg.dtype}) batch={args.batch} "
          f"prompt={args.prompt_len} decode={args.tokens} device={dev}")
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompts, max_seq=max_seq, **kw)
        _sync(dev)
        print(f"prefill: {time.perf_counter()-t0:.2f}s ({args.batch * args.prompt_len} tokens)")
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.tokens - 1):
            pos = torch.full((args.batch,), args.prompt_len + i, device=dev)
            logits, cache = decode_step(params, cfg, tok, cache, pos)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(tok)
        _sync(dev)
        dt = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    print(f"decode: {dt:.2f}s  ({args.batch*(args.tokens-1)/max(dt,1e-9):.1f} tok/s)")
    print("kernel launches:", launch_counts())
    print("generated token ids (row 0):", gen[0].tolist())


if __name__ == "__main__":
    main()
