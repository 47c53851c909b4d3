"""A training cell: the program's ``Model.train_step`` on batches drawn
from the seed, then the comparison of its first steps with the plain
reference.

Set-up draws the weights from the seed, builds the one training state
(weights, fp32 AdamW moments) and drives it through its first
``check_steps`` steps, through the same call and feed as the window: it
reads each step's loss, after step 1 the clipped gradient the optimizer
took (its first moment over ``1 - b1``), and after the last the change of
every leaf from the seed's weights, each as a norm per leaf.  The window
then goes on with the same state, a step at a time, until ``seconds`` have
passed, ending at a step's end.
"""
from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Dict

import torch

from . import reference
from .spec import Cell, port_config
from .traffic import train_batch
from .weights import (leaves_with_path, leaf_names, make_block, make_params,
                      n_blocks, block_of)


def _node(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def first_grad_norms(state, spec, b1: float) -> Dict:
    mu = state.opt["mu"]
    out: Dict = {}
    for b, path, _ in leaf_names(spec):
        m = _node(block_of(mu, spec, b), path)["m"]
        out.setdefault(b, {})[path] = float((m.float() / (1 - b1)).norm())
    return out


def change_norms(params, spec, seed: int, device) -> Dict:
    out: Dict = {}
    for b in range(n_blocks(spec)):
        start = dict(leaves_with_path(make_block(spec, seed, b, device)))
        now = block_of(params, spec, b)
        out[b] = {p: float((_node(now, p).float() - p0.float()).norm())
                  for p, p0 in start.items()}
    return out


def optimizer(traffic: dict):
    from repro_torch.train.optimizer import AdamWConfig
    o = traffic["optimizer"]
    return AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"], moments=o["moments"],
                       grad_clip=o["grad_clip"])


def run(cell: Cell, seed: int, seconds: float, tracer, device, clock,
        step_fn=None) -> Dict:
    from repro_torch.models import build_model
    from repro_torch.models.model import TrainState
    from repro_torch.train.optimizer import init_opt_state
    t, spec = cell.traffic, cell.spec
    model = build_model(port_config(spec), device, optimizer(t))
    step = step_fn or model.train_step
    params = make_params(spec, seed, device)
    state = TrainState(params, init_opt_state(params, model.opt_cfg),
                       torch.zeros((), dtype=torch.int32, device=device))
    losses, first = [], None
    print(f"portbench: weights and state at {clock():.1f} s", file=sys.stderr)
    for k in range(int(t["check_steps"])):
        state, met = step(state, {"tokens": train_batch(t, spec.vocab, seed,
                                                         k, device)})
        losses.append(float(met["loss"]))
        if k == 0:
            first = first_grad_norms(state, spec, model.opt_cfg.b1)
        print(f"portbench: step {k + 1} at {clock():.1f} s", file=sys.stderr)
    change = change_norms(state.params, spec, seed, device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    setup_s = clock()

    k = int(t["check_steps"])
    steps = failed = 0
    with tracer:
        t0 = time.perf_counter()
        while True:
            batch = {"tokens": train_batch(t, spec.vocab, seed, k, device)}
            with torch.profiler.record_function("model.train_step"):
                state, met = step(state, batch)
            loss = float(met["loss"])
            end = time.perf_counter()
            steps += 1
            k += 1
            failed += not math.isfinite(loss)
            if end - t0 >= seconds:
                break
        window_s = end - t0
    del state, params, model
    return {"setup_s": setup_s, "window_s": window_s, "attempted": steps,
            "failed": failed, "steps": steps,
            "tokens": steps * int(t["rows"]) * (int(t["seq"]) - 1),
            "losses": losses, "first_grad": first, "change": change}


def leaf_gaps(prog: Dict, ref: Dict, skip=()) -> Dict:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    pairs = {(b, p): (prog[b][p], r) for b, blk in ref.items()
             for p, r in blk.items() if (b, p) not in skip}
    med = statistics.median(r for _, r in pairs.values())
    return {k: abs(a - r) / max(r, med, 1e-30) for k, (a, r) in pairs.items()}


def compare(out: Dict, ref: Dict, detail: bool = False) -> Dict:
    """The numbers compared: each step's loss (the worst relative gap),
    the first gradient and the change after the steps, each by the worst
    leaf.  A leaf whose reference gradient is under a thousandth of the
    median leaf's moves by round-off alone and is left out of the
    change.  With ``detail``, also the worst leaves and the median
    leaf's gaps."""
    g = ref["first_grad"]
    med = statistics.median(v for blk in g.values() for v in blk.values())
    still = {(b, p) for b, blk in g.items() for p, v in blk.items()
             if v < 1e-3 * med}
    loss_gaps = [abs(a - r) / abs(r) for a, r in zip(out["losses"],
                                                     ref["losses"])]
    first = leaf_gaps(out["first_grad"], g)
    change = leaf_gaps(out["change"], ref["change"], still)
    res = {"loss_gap": max(loss_gaps), "first_grad_gap": max(first.values()),
           "change_gap": max(change.values())}
    if detail:
        def worst(gaps):
            (b, p), v = max(gaps.items(), key=lambda kv: kv[1])
            return f"{b}:{'.'.join(p)}={v:.3g}"
        res.update(loss_gaps=loss_gaps, still_leaves=len(still),
                   first_grad_worst=worst(first),
                   change_worst=worst(change),
                   first_grad_median=statistics.median(first.values()),
                   change_median=statistics.median(change.values()))
    return res


def check(cell: Cell, seed: int, out: Dict, device, detail: bool = False
          ) -> Dict:
    t = cell.traffic
    batches = [train_batch(t, cell.spec.vocab, seed, k, device)
               for k in range(int(t["check_steps"]))]
    ref = reference.train_reference(cell.spec, seed, device, batches,
                                    t["optimizer"], "fp32")
    return compare(out, ref, detail)
