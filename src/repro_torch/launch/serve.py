"""Serving launcher: batched prefill + decode for a dense --arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tokens 4

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``; without CUDA it raises unless ``--device cpu`` is
given).  It runs through :class:`repro_torch.serving.ServeEngine`, and the
rate it prints comes from the engine's telemetry spans: every emitted
token — the ``prefill`` span's (each prompt's first output token falls out
of the prefill logits) plus the ``decode`` span's — over the combined span
duration.  Prompts are drawn from ``numpy.random.default_rng(1)``, weights
from ``--seed``.  ``--telemetry DIR`` also writes the trace artifacts there.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.telemetry import Telemetry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write trace.json / metrics.json artifacts here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    tel = Telemetry(out_dir=args.telemetry)
    engine = ServeEngine(
        cfg, max_seq=args.prompt_len + args.tokens, seed=args.seed, telemetry=tel,
        device=args.device,
    )
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)
    ).astype(np.int32)
    reqs = [Request(prompt=prompts[i], max_new_tokens=args.tokens) for i in range(args.batch)]
    engine.run(reqs)
    decode = [s for s in tel.tracer.spans if s.name == "decode"][-1]
    prefill = [s for s in tel.tracer.spans if s.name == "prefill"][-1]
    # every emitted token counts: the prefill span holds the first output
    # token per prompt, the decode span the rest
    toks = prefill.attrs.get("tokens", 0) + decode.attrs.get("tokens", 0)
    dur = prefill.duration + decode.duration
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"{cfg.name}: prefill {prefill.duration*1e3:.1f} ms, "
          f"tokens={toks}, {toks/max(dur, 1e-9):.1f} tok/s ({where})")
    if "flops" in decode.attrs:
        print(f"decode step: {decode.attrs['flops']:.3g} flops, "
              f"{decode.attrs['bytes_moved']:.3g} bytes moved (analytic)")
    print("row 0:", reqs[0].out.tolist())
    if args.telemetry:
        for k, p in tel.flush().items():
            print(f"  wrote {k}: {p}")


if __name__ == "__main__":
    main()
