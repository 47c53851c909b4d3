"""Plain PyTorch version of prefill attention (causal / sliding-window, GQA).

Mirrors the JAX package's ``attention_ref`` step for step, so the CPU tests
compare like with like: queries chunked by ``q_chunk``, each chunk slicing
the KV range it can reach, bf16 inputs keeping bf16 score and probability
tensors (fp32 only for the row sums), the P·V product accumulated in fp32.
The wrapper runs it for tensors on the CPU, and the CUDA kernel is held
against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,          # [B, Hq, T, D]
    k: torch.Tensor,          # [B, Hkv, S, D]
    v: torch.Tensor,          # [B, Hkv, S, D]
    *,
    causal: bool = True,
    window: int | None = None,   # sliding window size (None = full)
    scale: float | None = None,
    q_chunk: int = 1024,
) -> torch.Tensor:            # [B, Hq, T, D]
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % {Hkv}")
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    acc_dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    # jnp.repeat along heads: q head h reads kv head h // group
    kq = torch.repeat_interleave(k, group, dim=1).to(acc_dt)
    vq = torch.repeat_interleave(v, group, dim=1).to(acc_dt)

    def one_chunk(qc: torch.Tensor, q0: int) -> torch.Tensor:
        Tc = qc.shape[2]
        off = S - T  # queries occupy the LAST T positions of the context
        k_lo, k_hi = 0, S
        if causal:
            k_hi = min(S, q0 + off + Tc)
        if window is not None:
            k_lo = max(0, q0 + off - window + 1)
        # an empty range (every query before every key) masks the whole row
        k_hi = max(k_hi, k_lo)
        ks = kq[:, :, k_lo:k_hi, :]
        vs = vq[:, :, k_lo:k_hi, :]
        logits = torch.matmul(qc.to(acc_dt), ks.transpose(-1, -2))
        logits = logits * torch.tensor(scale, dtype=acc_dt)
        qpos = q0 + torch.arange(Tc, device=q.device) + off
        kpos = k_lo + torch.arange(k_hi - k_lo, device=q.device)
        mask = torch.ones((Tc, k_hi - k_lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        neg = torch.tensor(NEG_INF, dtype=acc_dt, device=q.device)
        logits = torch.where(mask[None, None], logits, neg)
        if logits.shape[-1]:
            m = torch.amax(logits, dim=-1, keepdim=True)
        else:
            m = torch.zeros(logits.shape[:-1] + (1,), dtype=acc_dt,
                            device=q.device)
        p = torch.exp((logits - m).to(acc_dt))
        p = torch.where(mask[None, None], p, torch.zeros((), dtype=acc_dt,
                                                         device=q.device))
        denom = torch.sum(p.float(), dim=-1, keepdim=True)
        probs = p / torch.clamp(denom, min=1e-30).to(acc_dt)
        return torch.matmul(probs.float(), vs.float())

    if T <= q_chunk:
        return one_chunk(q, 0).to(q.dtype)
    outs = [one_chunk(q[:, :, q0:q0 + q_chunk], q0)
            for q0 in range(0, T, q_chunk)]
    return torch.cat(outs, dim=2).to(q.dtype)
