"""State tree ⇄ shard-dict bridging for BigStore checkpoints.

Shard naming uses the tree's key path (ordered, so the restore fold streams
shards in path order — the §4.4 lexicographic property is what lets a
restore begin materialising the state before the fold completes).

PyTorch port of :mod:`repro.checkpoint.manager`, over the port's nests of
dicts, lists and NamedTuples (a :class:`~repro_torch.models.model.TrainState`).
A name is the key path joined by ``/``, as the JAX ``_path_str`` builds it
(``params/embed/tok``, ``opt/mu/layers/0/attn/wq/m``, ``step``).  The port
keeps one dict per layer where JAX stacks each group, so the two packages
name a layer's shards differently.  Shards leave the card as CPU tensors;
:func:`repro_torch.checkpoint.bigstore._pack_shard` writes a bf16 tensor as
its ``uint16`` bit pattern tagged ``"bfloat16"``, as JAX writes its
``bfloat16`` arrays.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..tree import leaves_with_path


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def flatten_state(state) -> Dict[str, torch.Tensor]:
    """``{name: CPU tensor}`` of every leaf."""
    return {_path_str(path): leaf.detach().cpu()
            for path, leaf in leaves_with_path(state)}


def state_shard_names(state) -> List[str]:
    return sorted(flatten_tree_paths(state))


def flatten_tree_paths(state) -> List[str]:
    return [_path_str(p) for p, _ in leaves_with_path(state)]


def unflatten_state(template, shards: Dict[str, Tuple[int, torch.Tensor]]):
    """The ``template`` tree with every leaf's values replaced by its
    restored shard, copied **in place** into the template's tensors (their
    device, dtype and shape); returns ``template``."""
    with torch.no_grad():
        for path, leaf in leaves_with_path(template):
            name = _path_str(path)
            if name not in shards:
                raise KeyError(f"missing shard {name}")
            _step, arr = shards[name]
            leaf.copy_(torch.as_tensor(arr).reshape(leaf.shape))
    return template
