"""AdamW with configurable optimizer-state memory policies.

PyTorch port of :mod:`repro.train.optimizer`.  Policies
(``ModelConfig.optimizer_moments``):

* ``fp32``     — m, v in fp32 (12 B/param of state): default for ≤30B archs.
* ``bf16``     — m, v in bf16 (4 B/param): mid-size fallback.
* ``factored`` — m in bf16, v rank-1 factored à la Adafactor (row+col fp32,
  ~0 B/param).

Updates compute in fp32 whatever the storage dtype, with the JAX
package's arithmetic step for step.  Where JAX returns new trees, the port
updates the parameters and moments **in place**, leaf by leaf: the values
are the same, and at ``minitron-4b``'s width (fp32 moments, a 786 M-element
tied embedding whose fp32 temporaries are 3.1 GB each) a second copy of
the state would not fit the card beside the first.  ``opt_state_pspecs``
gives the state's sharding specs (:mod:`~repro_torch.models.sharding`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..tree import leaves, map_tree, subtrees_up_to

F32 = torch.float32


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moments: str = "fp32"          # fp32 | bf16 | factored
    grad_clip: float = 1.0


def _factored(leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2 and leaf.shape[-1] >= 8 and leaf.shape[-2] >= 8


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    mdt = F32 if cfg.moments == "fp32" else torch.bfloat16

    def init_leaf(p):
        st = {"m": torch.zeros(p.shape, dtype=mdt, device=p.device)}
        if cfg.moments == "factored" and _factored(p):
            st["v_row"] = torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
            st["v_col"] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                      device=p.device)
        else:
            vdt = F32 if cfg.moments != "bf16" else torch.bfloat16
            st["v"] = torch.zeros(p.shape, dtype=vdt, device=p.device)
        return st

    device = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": map_tree(init_leaf, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    total = None
    for x in leaves(tree):
        s = torch.sum(x.to(F32, copy=True).square_())
        total = s if total is None else total + s
    return torch.sqrt(total)


def _update_leaf(p: torch.Tensor, g: torch.Tensor, st: Dict, cfg: AdamWConfig,
                 clip, b1c, b2c) -> None:
    """One leaf of AdamW, in place on ``p`` and ``st``."""
    g = g.to(F32, copy=True).mul_(clip)
    m = st["m"].float()                        # fp32 moments: m itself
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    if m is not st["m"]:
        st["m"].copy_(m)
    if "v" in st:
        v = st["v"].float()
        v.mul_(cfg.b2).add_((g * g).mul_(1 - cfg.b2))
        if v is not st["v"]:
            st["v"].copy_(v)
        del g
        v_hat = v / b2c
        del v
    else:
        g.square_()
        v_row, v_col = st["v_row"], st["v_col"]
        v_row.mul_(cfg.b2).add_(g.mean(-1).mul_(1 - cfg.b2))
        v_col.mul_(cfg.b2).add_(g.mean(-2).mul_(1 - cfg.b2))
        del g
        denom = torch.clamp(v_row.mean(-1, keepdim=True), min=1e-30)[..., None]
        v_hat = (v_row[..., None] * v_col[..., None, :]).div_(denom).div_(b2c)
    upd = (m / b1c).div_(v_hat.sqrt_().add_(cfg.eps))
    del m, v_hat
    pf = p.float()                             # fp32 params: p itself
    upd.add_(pf * cfg.weight_decay).mul_(cfg.lr)
    pf.sub_(upd)
    if pf is not p:
        p.copy_(pf)


def adamw_update(
    grads, opt_state, params, cfg: AdamWConfig,
) -> Tuple[Any, Dict[str, Any]]:
    """``(params, opt_state)`` after one step; ``params`` and the moments
    are updated in place and returned."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=step.device),
                          stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=step.device),
                          stepf)
    with torch.no_grad():
        for p, g, st in zip(leaves(params), subtrees_up_to(params, grads),
                            subtrees_up_to(params, opt_state["mu"])):
            _update_leaf(p, g, st, cfg, clip, b1c, b2c)
    return params, {"step": step, "mu": opt_state["mu"]}


def opt_state_pspecs(opt_state, param_pspecs):
    """Optimizer state shardings mirror parameter shardings: ``m`` (and
    ``v``) take the parameter's spec, the factored ``v_row`` / ``v_col``
    drop its last or second-to-last entry."""
    from ..models.sharding import P

    def leaf_spec(ps, st):
        out = {"m": ps}
        if "v" in st:
            out["v"] = ps
        else:
            sub = list(ps) if ps else []
            sub = sub + [None] * (st["m"].dim() - len(sub))
            out["v_row"] = P(*sub[:-1]) if len(sub) > 1 else P()
            out["v_col"] = P(*(sub[:-2] + sub[-1:])) if len(sub) > 1 else P()
        return out

    return {"step": P(), "mu": map_tree(leaf_spec, param_pspecs,
                                        opt_state["mu"])}
