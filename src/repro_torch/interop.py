"""Carry state from the JAX package into the port, as plain data.

The two packages share no objects.  Bigset storage encodes keys and values
identically, so a state built by one can be replayed into the other and
both can answer the same queries; model parameters carry across as numpy
arrays.  The inputs are numpy arrays and ``(key, value)`` byte pairs —
never objects of ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.bigset import BigsetVnode
from .core.vclock import DenseClock
from .device import DeviceLike, resolve_device
from .models.transformer import _plan, layer_kinds
from .storage.lsm import LsmStore


def dense_clock_from_numpy(starts, ends, device: DeviceLike = None) -> DenseClock:
    """A dense interval clock from ``int32[A, R]`` run arrays (for example
    ``np.asarray`` of a JAX ``DenseClock``'s fields), placed on ``device``."""
    dev = resolve_device(device)
    s = np.asarray(starts, dtype=np.int32)
    e = np.asarray(ends, dtype=np.int32)
    if s.ndim != 2 or s.shape != e.shape:
        raise ValueError("starts/ends must share one [A, R] shape")
    # torch.tensor copies: the arrays may be read-only views of JAX buffers
    return DenseClock(torch.tensor(s, device=dev), torch.tensor(e, device=dev))


def vnode_from_items(actor, items: Iterable[Tuple[bytes, bytes]]) -> BigsetVnode:
    """A port vnode holding exactly ``items`` — the ``(key, value)`` pairs
    of another vnode's ``store.scan()`` — written as one atomic batch."""
    store = LsmStore()
    store.put_batch([(bytes(k), bytes(v)) for k, v in items])
    return BigsetVnode(actor, store=store)


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """A copy of array ``a`` on ``device``; bfloat16 arrays (numpy's
    ``ml_dtypes`` type, which torch cannot read) go through their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The port's parameters holding the JAX package's weights.

    ``tree`` is the JAX parameter pytree with numpy leaves (for example
    ``jax.tree.map(np.asarray, params)``).  Its scan-stacked ``groups``
    leaves ``[n_groups, ...]`` are unstacked into one dict per layer, in
    layer order; every matrix keeps JAX's ``[d_in, d_out]`` layout, so
    ``x @ w`` computes the same product.  Every leaf keeps its dtype: the
    Mamba mixers' fp32 ``A_log`` and ``Dp`` and the MoE router stay fp32
    in a bf16 model.  An MoE layer's stacked experts ``[n_groups, E, d,
    f]`` become its own ``[E, d, f]``.  An encoder-decoder's ``encoder``
    subtree (its list of layers, ``pos`` and ``final_norm``) comes across
    as it is; its decoder layers' ``norm_cross`` and ``cross`` come with
    them.
    """
    dev = resolve_device(device)
    n_groups, _, g = _plan(cfg)
    n_layers = len(layer_kinds(cfg))

    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        a = np.asarray(node)
        return tensor_from_numpy(a if index is None else a[index], dev)

    out: Dict[str, Any] = {"embed": conv(tree["embed"]),
                           "final_norm": conv(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = conv(tree["lm_head"])
    layers = []
    for i in range(n_layers):
        if i < n_groups * g:
            grp, j = divmod(i, g)
            layers.append(conv(tree["groups"][j], grp))
        else:
            layers.append(conv(tree["tail"][i - n_groups * g]))
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": [conv(layer) for layer in enc["layers"]],
                          "pos": conv(enc["pos"]),
                          "final_norm": conv(enc["final_norm"])}
    return out


def train_state_from_jax(cfg: ModelConfig, state_tree,
                         device: DeviceLike = None):
    """The port's :class:`~repro_torch.models.model.TrainState` holding a
    JAX ``TrainState`` given as numpy leaves (for example
    ``jax.tree.map(np.asarray, state)``): its parameters, its optimizer
    moments (``opt["mu"]``: ``m`` and ``v``, or ``v_row`` / ``v_col``,
    which share the parameters' structure down to each parameter's dict)
    unstacked as :func:`params_from_jax` unstacks the parameters, and its
    step counters as int32 tensors.  A JAX gradient tree has the
    parameters' structure: :func:`params_from_jax` carries it across."""
    from .models.model import TrainState

    dev = resolve_device(device)
    params, opt, step = state_tree
    out_opt = {"step": tensor_from_numpy(
                   np.asarray(opt["step"], np.int32), dev),
               "mu": params_from_jax(cfg, opt["mu"], dev)}
    return TrainState(params_from_jax(cfg, params, dev), out_opt,
                      tensor_from_numpy(np.asarray(step, np.int32), dev))
