"""End-to-end fault-tolerant training driver, on the PyTorch port.

Trains a small LM (default ~10M params; ``--preset 100m`` for the full-size
run) on the synthetic pipeline with:
  * dot-tracked gradient delta sync across simulated DP hosts,
  * BigStore decomposed delta checkpoints every few steps,
  * a mid-run host crash + quorum restore + elastic re-shard,
  * deterministic continuation (verified against the loss curve).

Attention's forward and backward run their CUDA kernels on ``--device
cuda`` (the default); ``--device cpu`` runs their plain PyTorch versions.
The weights are drawn by the port's ``init``, so the losses differ from
the JAX package's example; every other line is the same.

Run:  PYTHONPATH=src python examples_torch/train_ft.py [--steps 60]
          [--preset 10m] [--device cpu]

The port's copy of ``examples/train_ft.py``.
"""
import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.runtime.ft import FTConfig, FTTrainer
from repro_torch.tree import leaves

PRESETS = {
    # d_model, n_layers, d_ff, heads, seq, vocab  (~param count)
    "1m": (64, 2, 256, 4, 64, 503),
    "10m": (256, 4, 1024, 8, 128, 2048),
    "100m": (768, 12, 3072, 12, 256, 8192),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preset", default="1m", choices=PRESETS)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    d, L, f, h, seq, vocab = PRESETS[args.preset]
    cfg = smoke_config("minitron-4b").replace(
        d_model=d, n_layers=L, d_ff=f, n_heads=h, n_kv_heads=h,
        head_dim=d // h, vocab_size=vocab)
    ft = FTConfig(n_hosts=4, global_batch=args.global_batch, seq_len=seq,
                  ckpt_every=10, replication=3)
    tr = FTTrainer(cfg, ft, device=device)
    n_params = sum(x.numel() for x in leaves(tr.state.params))
    print(f"model: {n_params / 1e6:.1f}M params, {ft.n_hosts} DP hosts")

    third = args.steps // 3
    losses = tr.train_steps(third)
    print(f"[phase 1] steps 1..{third}: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # ---- crash a host mid-run -------------------------------------------
    tr.checkpoint()
    tr.crash_host(2)
    print(f"[fault] host 2 crashed; alive assignment:",
          tr.elastic.current_assignment().hosts)
    step = tr.restore()  # quorum restore from surviving replicas
    print(f"[restore] resumed from step {step} via quorum streaming fold")

    losses = tr.train_steps(third)
    print(f"[phase 2] 3-host elastic continuation: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # ---- node replacement joins ------------------------------------------
    tr.join_host(2)
    print("[elastic] host 2 replacement joined:",
          tr.elastic.current_assignment().hosts)
    losses = tr.train_steps(args.steps - 2 * third,
                            slow_hosts={"node1": 2})  # transient straggler
    print(f"[phase 3] 4-host + straggler sealing: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    hist = tr.loss_history
    print(f"\nfinal: {hist[-1]:.3f} (start {hist[0]:.3f}); "
          f"ckpt store {tr.store.total_bytes() / 1e6:.1f} MB across "
          f"{sum(h.alive for h in tr.store.hosts)} hosts")
    assert np.mean(hist[-5:]) < np.mean(hist[:5]), "loss did not improve"
    print("loss improved across crash/restore/elastic events ✓")


if __name__ == "__main__":
    main()
