"""Batched serving example: continuous batching with streamed tokens, on
the PyTorch port.

Prefill runs the flash-attention kernel and every decode step the
decode-attention kernel on ``--device cuda`` (the default); ``--device
cpu`` runs their plain PyTorch versions.  The weights are drawn from seed
0 by the port's ``init``, so the streamed tokens differ from the JAX
package's example; the batching schedule is the same.

Run:  PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]

The port's copy of ``examples/serve_batched.py``.
"""
import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = smoke_config("pixtral-12b").replace(
        n_layers=2, kv_cache_dtype="bfloat16")
    model = build_model(cfg, device)
    params = model.init(0)
    eng = ServeEngine(cfg, params, max_batch=4, max_len=96, temperature=0.0,
                      device=device)

    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, rng.integers(4, 12)),
                       max_new_tokens=8) for _ in range(7)]
    print(f"submitted {len(reqs)} requests (queue depth > batch: "
          f"continuous batching kicks in)")

    it = 0
    while eng.queue or any(s is not None for s in eng.slots):
        active = eng.step()
        it += 1
        done = sum(r.done for r in reqs)
        print(f"  iter {it:2d}: {active} active slots, {done}/{len(reqs)} done")
    for r in reqs:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    assert all(r.done for r in reqs)
    print("all requests served ✓")


if __name__ == "__main__":
    main()
