"""A serving cell: the program's ``ServeEngine`` under a closed loop of
clients, then the comparison of what it served with the plain reference.

Set-up draws the weights from the seed, builds the engine and serves one
wave of warm-up requests (a stream of their own).  The window then starts
with every client submitting, and steps the engine until ``seconds`` have
passed, ending at a step's end.  A token is delivered when the
``step()`` that made it returns, so a request's time to first token runs
from its submission to the end of the step that prefilled it.  The rate
counts the work of the window: each prompt when its prefill delivers the
first token, and each token delivered.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import reference
from .spec import Cell, port_config
from .traffic import RequestStream
from .weights import make_params


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Probe:
    """The engine's model with the benchmark's spans around its calls; in
    a traced run each decode step is synchronised and timed."""

    def __init__(self, model, timed: bool):
        self.model = model
        self.timed = timed
        self.decode_ms: List[float] = []

    def prefill_step(self, *a, **kw):
        with torch.profiler.record_function("model.prefill_step"):
            return self.model.prefill_step(*a, **kw)

    def decode_step(self, params, cache, tokens, cache_len):
        with torch.profiler.record_function("model.decode_step"):
            if not self.timed:
                return self.model.decode_step(params, cache, tokens, cache_len)
            sync()
            t0 = time.perf_counter()
            out = self.model.decode_step(params, cache, tokens, cache_len)
            sync()
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            return out


def _drain(eng) -> None:
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()


def run(cell: Cell, seed: int, seconds: float, tracer, device, clock) -> Dict:
    """Serve the window; return the window's figures and what the check
    needs (``finished`` requests with their prompts)."""
    from repro_torch.serve.engine import ServeEngine
    t = cell.traffic
    spec = cell.spec
    params = make_params(spec, seed, device)
    eng = ServeEngine(port_config(spec), params, max_batch=t["max_batch"],
                      max_len=t["max_len"], temperature=0.0, seed=seed,
                      device=device)
    print(f"portbench: weights and engine at {clock():.1f} s", file=sys.stderr)
    probe = Probe(eng.model, timed=tracer.on)
    eng.model = probe
    new = int(t["new_tokens"])
    warm = RequestStream(t, spec.vocab, seed, warm=True)
    for _ in range(t["clients"]):
        eng.submit(warm.next(), max_new_tokens=new)
    _drain(eng)
    sync()
    setup_s = clock()
    probe.decode_ms.clear()

    stream = RequestStream(t, spec.vocab, seed)
    live = {}                              # rid -> (req, prompt, submit_t)
    finished = []
    ttft_ms: List[float] = []
    prefill_lens: List[int] = []
    tokens = 0
    attempted = 0
    decode_steps = decode_tokens = 0
    decode_ctx: List[int] = []     # per decode step: keys its tokens attend to

    def submit(now):
        nonlocal attempted
        prompt = stream.next()
        req = eng.submit(prompt, max_new_tokens=new)
        live[req.rid] = (req, prompt, now)
        attempted += 1

    with tracer:
        t0 = time.perf_counter()
        for _ in range(t["clients"]):
            submit(t0)
        end = t0
        while end - t0 < seconds:
            before = {rid: len(v[0].out_tokens) for rid, v in live.items()}
            with torch.profiler.record_function("engine.step"):
                n_active = eng.step()
            end = time.perf_counter()
            ctx = 0
            for rid, (req, prompt, sub_t) in list(live.items()):
                got = len(req.out_tokens) - before[rid]
                if got <= 0:
                    continue
                if before[rid] == 0:
                    ttft_ms.append((end - sub_t) * 1e3)
                    prefill_lens.append(len(prompt))
                    tokens += len(prompt)
                    decode_tokens -= 1
                decode_tokens += got
                # the decode step's token attended to everything before it
                ctx += len(prompt) + len(req.out_tokens) - 1
                tokens += got
                if req.done:
                    finished.append((req, prompt))
                    del live[rid]
                    submit(end)
            if n_active:
                decode_steps += 1
                decode_ctx.append(ctx)
        window_s = end - t0
    del eng, params
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": attempted,
        "failed": 0, "tokens": tokens, "ttft_ms": ttft_ms,
        "prefill_lens": prefill_lens, "decode_steps": decode_steps,
        "decode_tokens": decode_tokens,
        "decode_ms": probe.decode_ms, "decode_ctx": decode_ctx,
        "decode_rows": t["max_batch"], "finished": finished,
    }


def sample(cell: Cell, seed: int, out: Dict):
    """The requests the check reads, drawn from the seed among the
    window's finished ones, the longest first: for each, the tokens the
    reference runs over (the prompt, then every served token but the
    last), the positions whose logits chose a served token, and those
    tokens."""
    fin = out["finished"]
    k = min(len(fin), int(cell.traffic["check_requests"]))
    longest = max(range(len(fin)), key=lambda i: len(fin[i][1]))
    rest = [i for i in range(len(fin)) if i != longest]
    rng = np.random.default_rng([int(seed), 3])
    pick = [longest] + [int(i) for i in rng.choice(rest, k - 1, replace=False)]
    seqs, wanted, served = [], [], []
    for i in pick:
        req, prompt = fin[i]
        toks = list(req.out_tokens)
        seqs.append(torch.as_tensor(np.concatenate(
            [prompt, np.asarray(toks[:-1], np.int32)])))
        wanted.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + len(toks)))
        served.append(torch.as_tensor(toks))
    return seqs, wanted, served


def gaps(logits, tokens) -> torch.Tensor:
    """How far each token's logit lies below the best of its row."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens.to(logits.device).long()[:, None])[:, 0]


def check(cell: Cell, seed: int, out: Dict, device, detail: bool = False
          ) -> Dict:
    """The widest gap by which a served token's logit lies below the
    reference's best, over the sampled requests.  With ``detail``, also
    the mean gap, the share of served tokens that are not the reference's
    first, and the reference's logits (for the control)."""
    if not out["finished"]:
        return {"widest_gap": float("inf")}
    seqs, wanted, served = sample(cell, seed, out)
    logits = reference.served_logits(cell.spec, seed, device, seqs, wanted)
    g = torch.cat([gaps(lg, tok) for lg, tok in zip(logits, served)])
    res = {"widest_gap": float(g.max())}
    if detail:
        res.update(mean_gap=float(g.mean()), off_top=float((g > 0).float().mean()),
                   served_tokens=int(g.numel()), logits=logits,
                   sample=(seqs, wanted, served))
    return res
