"""Plain fp32 references, one per kind of configuration
(``configs/<name>.json`` names its ``reference``), and the model-level
passes over them: the serving check's logits and the training check's
first steps.  They draw their own weights from the seed
(:mod:`portbench.weights`), layer by layer, and import nothing of the
program."""
from __future__ import annotations

import importlib
import sys
import time
from typing import Dict, List, Sequence, Tuple

import torch

from ..weights import EMBED, HEAD, layer_block, make_block
from .common import cross_entropy_sum, exact_fp32, mm, rmsnorm


def kind_module(spec):
    return importlib.import_module(f"{__name__}.{spec.kind}")


def fp32_tree(tree):
    if isinstance(tree, dict):
        return {k: fp32_tree(v) for k, v in tree.items()}
    return tree.float()


def layer_weights(spec, seed: int, i: int, device) -> Dict:
    return fp32_tree(make_block(spec, seed, layer_block(i), device))


def head_logits(head: Dict, x: torch.Tensor, spec, prec: str) -> torch.Tensor:
    y = rmsnorm(x, head["final_norm"]["scale"], spec.norm_eps)
    return mm(y, head["lm_head"], prec)


@torch.no_grad()
def served_logits(spec, seed: int, device, seqs: Sequence[torch.Tensor],
                  wanted: Sequence[torch.Tensor], prec: str = "fp32"
                  ) -> List[torch.Tensor]:
    """For each token sequence ``seqs[j]`` (int ``[T_j]``), the logits
    ``[len(wanted[j]), vocab]`` at the positions ``wanted[j]`` of a full
    forward from position 0.  Layer by layer, each layer's weights drawn
    once and run over every sequence."""
    mod = kind_module(spec)
    with exact_fp32():
        emb = make_block(spec, seed, EMBED, device)["embed"]["tok"]
        xs = [emb[s.to(device).long()].float()[None] for s in seqs]
        del emb
        for i in range(spec.n_layers):
            w = layer_weights(spec, seed, i, device)
            xs = [mod.layer(w, x, spec, prec) for x in xs]
            del w
        head = fp32_tree(make_block(spec, seed, HEAD, device))
        return [head_logits(head, x[0, want.to(device).long()], spec, prec)
                for x, want in zip(xs, wanted)]


# ---------------------------------------------------------------- training
CE_ROWS = 1024


def storage_dtype(path: Tuple[str, ...], spec) -> torch.dtype:
    """The type the configuration keeps a leaf in (``A_log`` and ``D`` in
    fp32, the rest in the model's type)."""
    from ..weights import DTYPES
    return torch.float32 if path[-1] in ("A_log", "Dp") else DTYPES[spec.dtype]


def replay(spec, seed: int, block: int, grads: Sequence[Dict], opt: Dict,
           device) -> Dict:
    """``block``'s leaves (fp32 values) after ``len(grads)`` AdamW steps
    from the seed's weights, each step fed the clipped gradient
    ``grads[k][path]`` and each result stored in the leaf's type, as the
    configuration keeps it (bf16 weights, fp32 moments)."""
    from ..weights import leaves_with_path
    out: Dict = {}
    f32 = torch.float32
    for path, p0 in leaves_with_path(make_block(spec, seed, block, device)):
        dt = storage_dtype(path, spec)
        p = p0.float()
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        for k, g in enumerate(grads, start=1):
            gk = g[path]
            m = m * opt["b1"] + gk * (1 - opt["b1"])
            v = v * opt["b2"] + (gk * gk) * (1 - opt["b2"])
            b1c = 1.0 - torch.pow(torch.tensor(opt["b1"], dtype=f32), float(k))
            b2c = 1.0 - torch.pow(torch.tensor(opt["b2"], dtype=f32), float(k))
            upd = (m / b1c.to(device)) / ((v / b2c.to(device)).sqrt() + opt["eps"])
            upd = (upd + p * opt["weight_decay"]) * opt["lr"]
            p = (p - upd).to(dt).float()
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p
    return out


def _with_grad(tree):
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _grads_of(tree):
    from ..weights import leaves_with_path
    return {path: (leaf.grad if leaf.grad is not None
                   else torch.zeros_like(leaf))
            for path, leaf in leaves_with_path(tree)}


def loss_and_grads(spec, seed: int, device, tokens: torch.Tensor,
                   weights, prec: str = "fp32") -> Tuple[float, Dict]:
    """The mean next-token cross-entropy of ``tokens`` ``[B, T + 1]`` and
    its gradient, ``{block: {path: fp32 grad}}``, at the weights
    ``weights(block)``.  The forward keeps each layer's input; the
    backward runs the layers again, last first, each under autograd on
    its own (so one layer's graph is alive at a time)."""
    mod = kind_module(spec)
    inp, tgt = tokens[:, :-1].long(), tokens[:, 1:].long()
    B, T = inp.shape
    t0 = time.perf_counter()
    table = weights(EMBED)["embed"]["tok"]
    x = table[inp]
    del table
    xs = []
    with torch.no_grad():
        for i in range(spec.n_layers):
            xs.append(x)
            x = mod.layer(weights(layer_block(i)), x, spec, prec)
    grads: Dict = {}
    t_fwd = time.perf_counter() - t0
    head = _with_grad(weights(HEAD))
    xl = x.detach().requires_grad_(True)
    total = 0.0
    flat_x, flat_t = xl.view(B * T, -1), tgt.reshape(-1)
    for lo in range(0, B * T, CE_ROWS):
        hi = min(B * T, lo + CE_ROWS)
        part = cross_entropy_sum(head_logits(head, flat_x[lo:hi], spec, prec),
                                 flat_t[lo:hi]) / (B * T)
        part.backward()
        total += float(part.detach())
    grads[HEAD] = _grads_of(head)
    dx = xl.grad
    del head, xl
    extra = {"checkpoint": True, "scan_channels": 1024} \
        if spec.kind == "mamba1" else {}
    for i in reversed(range(spec.n_layers)):
        w = _with_grad(weights(layer_block(i)))
        xi = xs.pop().requires_grad_(True)
        mod.layer(w, xi, spec, prec, **extra).backward(dx)
        grads[layer_block(i)] = _grads_of(w)
        dx = xi.grad
        del w, xi
    g_tab = torch.zeros((spec.vocab, spec.d_model), dtype=torch.float32,
                        device=device)
    g_tab.index_add_(0, inp.reshape(-1), dx.reshape(B * T, -1))
    grads[EMBED] = {("embed", "tok"): g_tab}
    print(f"portbench: reference forward {t_fwd:.1f} s, with the backward "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return total, grads


def train_reference(spec, seed: int, device, batches: Sequence[torch.Tensor],
                    opt: Dict, prec: str = "fp32") -> Dict:
    """The reference's first ``len(batches)`` steps from the seed's
    weights: each step's loss, the clipped gradient the optimizer takes
    at step 1, and each leaf's change after the last step, as norms per
    leaf ``{block: {path: float}}``."""
    from ..weights import n_blocks
    clipped: List[Dict] = []              # per step: {block: {path: g}}
    losses = []
    t0 = time.perf_counter()
    with exact_fp32():
        for k, tokens in enumerate(batches):
            def weights(block, _k=k):
                return replay(spec, seed, block,
                              [g[block] for g in clipped], opt, device)
            loss, grads = loss_and_grads(spec, seed, device, tokens, weights,
                                         prec)
            losses.append(loss)
            sq = sum(float(torch.linalg.vector_norm(g)) ** 2
                     for blk in grads.values() for g in blk.values())
            clip = min(1.0, opt["grad_clip"] / max(sq ** 0.5, 1e-9))
            for blk in grads.values():
                for g in blk.values():
                    g.mul_(clip)
            clipped.append(grads)
            print(f"portbench: reference step {k + 1} at "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        first = {b: {p: float(g.norm()) for p, g in blk.items()}
                 for b, blk in clipped[0].items()}
        change = {}
        for b in range(n_blocks(spec)):
            after = replay(spec, seed, b, [g[b] for g in clipped], opt, device)
            before = fp32_tree(make_block(spec, seed, b, device))
            from ..weights import leaves_with_path
            bef = dict(leaves_with_path(before))
            change[b] = {p: float((a - bef[p]).norm())
                         for p, a in leaves_with_path(after)}
    return {"losses": losses, "first_grad": first, "change": change}
