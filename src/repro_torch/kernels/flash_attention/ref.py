"""Plain PyTorch version of prefill attention (causal / sliding-window, GQA).

Mirrors the JAX package's ``attention_ref`` step for step, so the CPU tests
compare like with like: queries chunked by ``q_chunk``, each chunk slicing
the KV range it can reach, bf16 inputs keeping bf16 score and probability
tensors (fp32 only for the row sums), the P·V product accumulated in fp32.
The wrapper runs it for tensors on the CPU, and the CUDA kernel is held
against it on the card.

Beside it, the plain versions of the training route: :func:`attention_lse_ref`
(each row's log-sum-exp, which the kernels write beside the output) and
:func:`attention_bwd_ref`, the backward from ``lse`` and
``delta = sum(dO * O)`` by the formula the CUDA backward computes
(``csrc/flash_attention_bwd.cu``), in fp32 whatever the input dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _key_range(q0: int, Tc: int, T: int, S: int, causal: bool,
               window: int | None) -> tuple[int, int]:
    """The keys ``[k_lo, k_hi)`` that query rows ``[q0, q0 + Tc)`` can
    reach; the queries occupy the LAST T positions of the context."""
    off = S - T
    k_lo, k_hi = 0, S
    if causal:
        k_hi = min(S, q0 + off + Tc)
    if window is not None:
        k_lo = max(0, q0 + off - window + 1)
    # an empty range (every query before every key) masks the whole row
    return k_lo, max(k_hi, k_lo)


def _visible(q0: int, Tc: int, k_lo: int, k_hi: int, T: int, S: int,
             causal: bool, window: int | None, device) -> torch.Tensor:
    """``bool[Tc, k_hi - k_lo]``: which (query, key) pairs are seen."""
    qpos = q0 + torch.arange(Tc, device=device) + S - T
    kpos = k_lo + torch.arange(k_hi - k_lo, device=device)
    mask = torch.ones((Tc, k_hi - k_lo), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


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
        k_lo, k_hi = _key_range(q0, Tc, T, S, causal, window)
        ks = kq[:, :, k_lo:k_hi, :]
        vs = vq[:, :, k_lo:k_hi, :]
        logits = torch.matmul(qc.to(acc_dt), ks.transpose(-1, -2))
        logits = logits * torch.tensor(scale, dtype=acc_dt)
        mask = _visible(q0, Tc, k_lo, k_hi, T, S, causal, window, q.device)
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


def attention_lse_ref(
    q: torch.Tensor,          # [B, Hq, T, D]
    k: torch.Tensor,          # [B, Hkv, S, D]
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_chunk: int = 1024,
) -> torch.Tensor:            # fp32 [B, Hq, T]
    """Each query row's log-sum-exp of its scaled, visible scores, in fp32;
    ``+inf`` for a row that sees no key (its probabilities are all 0)."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    kq = torch.repeat_interleave(k, Hq // Hkv, dim=1).float()
    out = []
    for q0 in range(0, T, q_chunk):
        Tc = min(q_chunk, T - q0)
        k_lo, k_hi = _key_range(q0, Tc, T, S, causal, window)
        s = torch.matmul(q[:, :, q0:q0 + Tc].float(),
                         kq[:, :, k_lo:k_hi].transpose(-1, -2)) * scale
        mask = _visible(q0, Tc, k_lo, k_hi, T, S, causal, window, q.device)
        s = torch.where(mask, s, torch.tensor(-torch.inf, device=q.device))
        lse = torch.logsumexp(s, dim=-1)
        out.append(torch.where(torch.isneginf(lse),
                               torch.tensor(torch.inf, device=q.device), lse))
    return torch.cat(out, dim=2)


def attention_bwd_ref(
    q: torch.Tensor,          # [B, Hq, T, D]
    k: torch.Tensor,          # [B, Hkv, S, D]
    v: torch.Tensor,          # [B, Hkv, S, D]
    o: torch.Tensor,          # [B, Hq, T, D], the forward's output
    dout: torch.Tensor,       # [B, Hq, T, D]
    lse: torch.Tensor,        # fp32 [B, Hq, T], the forward's
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtype, computed in fp32:
    ``P = exp(s - lse)``, ``dV = P^T dO``, ``dS = P (dO V^T - delta)``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``, dK and dV summed over the
    query heads that share a KV head."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    qf, dof = q.float(), dout.float()
    delta = (dof * o.float()).sum(dim=-1)
    dq = torch.zeros_like(qf)
    dkq = torch.zeros_like(kq)
    dvq = torch.zeros_like(vq)
    zero = torch.zeros((), device=q.device)
    for q0 in range(0, T, q_chunk):
        Tc = min(q_chunk, T - q0)
        k_lo, k_hi = _key_range(q0, Tc, T, S, causal, window)
        ks, vs = kq[:, :, k_lo:k_hi], vq[:, :, k_lo:k_hi]
        qc, doc = qf[:, :, q0:q0 + Tc], dof[:, :, q0:q0 + Tc]
        s = torch.matmul(qc, ks.transpose(-1, -2)) * scale
        mask = _visible(q0, Tc, k_lo, k_hi, T, S, causal, window, q.device)
        p = torch.where(mask, torch.exp(s - lse[:, :, q0:q0 + Tc, None]),
                        zero)
        dp = torch.matmul(doc, vs.transpose(-1, -2))
        ds = p * (dp - delta[:, :, q0:q0 + Tc, None])
        dvq[:, :, k_lo:k_hi] += torch.matmul(p.transpose(-1, -2), doc)
        dkq[:, :, k_lo:k_hi] += torch.matmul(ds.transpose(-1, -2), qc) * scale
        dq[:, :, q0:q0 + Tc] = torch.matmul(ds, ks) * scale
    dk = dkq.reshape(B, Hkv, group, S, D).sum(dim=2)
    dv = dvq.reshape(B, Hkv, group, S, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
