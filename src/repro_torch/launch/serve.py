"""Serving launcher: batched requests through the continuous-batching engine.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \\
      --preset smoke --device cpu --requests 6 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --preset smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --preset smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --preset smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \\
      --preset full                      # on the card, bf16, random weights

PyTorch port of :mod:`repro.launch.serve`, with ``--device`` (default
``cuda``: attention and the selective scan run the CUDA kernels).  It
drives decoder-only architectures and refuses the encoder-decoder, as the
JAX package's launcher does: ``whisper-tiny`` needs encoder frames, and
is served through ``Model.prefill_step`` and ``decode_step``
(``chip_smoke.py``'s ``whisper serve`` phase).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, smoke_config
from ..models import build_model
from ..serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.preset == "smoke" else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("serve CLI drives decoder-only archs; whisper needs "
                         "encoder frames")
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len, temperature=args.temperature,
                      device=model.device)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 16))),
                       max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    eng.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {model.device})")
    for r in reqs[:3]:
        print(f"  req{r.rid}: {list(r.out_tokens)}")
    return reqs


if __name__ == "__main__":
    main()
