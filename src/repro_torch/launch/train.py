"""Training launcher.

``--preset smoke`` runs the reduced same-family config end to end;
``--preset full`` builds the assigned full-size config, which for
``minitron-4b`` (3.40 B parameters, bf16, fp32 AdamW moments: 34.0 GB of
state) fits one 80 GB card.  The loop itself is the fault-tolerant driver:
BigStore checkpoints, membership-derived assignments, straggler sealing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
      --preset smoke --device cpu --steps 5 --crash-at 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --preset smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch falcon-mamba-7b --preset smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-1.5-large-398b --preset smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
      --preset full --steps 3 --global-batch 2 --seq-len 4096

PyTorch port of :mod:`repro.launch.train`, with ``--device`` (default
``cuda``: the forward and backward of attention and of the selective
scan run the CUDA kernels).  Every family trains.  As in the JAX
package, the trainer's batches hold tokens alone, so ``whisper-tiny``
trains its decoder with the cross-attention step skipped and its encoder
untouched (ROADMAP C13).
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS, get_config, smoke_config
from ..runtime.ft import FTConfig, FTTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a host crash+restore at this step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.preset == "smoke" else get_config(args.arch)
    ft = FTConfig(n_hosts=args.hosts, global_batch=args.global_batch,
                  seq_len=args.seq_len, ckpt_every=args.ckpt_every)
    tr = FTTrainer(cfg, ft, device=args.device)
    print(f"arch={cfg.name} preset={args.preset} device={tr.device} "
          f"layers={cfg.n_layers} d_model={cfg.d_model} "
          f"hosts={ft.n_hosts} batch={ft.global_batch}x{ft.seq_len}")

    remaining = args.steps
    if args.crash_at and args.crash_at < args.steps:
        losses = tr.train_steps(args.crash_at)
        print(f"steps 1..{args.crash_at}: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        tr.checkpoint()
        tr.crash_host(min(1, ft.n_hosts - 1))
        step = tr.restore()
        print(f"[fault] crashed host, restored at step {step}, "
              f"dp={tr.elastic.current_assignment().dp_size}")
        remaining = args.steps - args.crash_at
    losses = tr.train_steps(remaining)
    print(f"final loss {losses[-1]:.4f} "
          f"(ckpt store {tr.store.total_bytes() / 1e6:.1f} MB)")
    return losses


if __name__ == "__main__":
    main()
