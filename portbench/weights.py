"""Weights made from the seed, on the device, in the type they are served
in, in the program's layout.

The model is cut into blocks: the embedding (block 0), the head and the
final norm (block 1), and each layer (block ``2 + i``).  A block's random
leaves are views of one buffer drawn by one ``randn`` call from a
generator seeded by ``(seed, block)``, each scaled as the program's own
initialisers scale it; its constant leaves are filled.  So the same seed
gives the same bits on the same device, and one block can be drawn again
alone: the plain reference draws the layer it needs when it needs it, and
the training check draws the starting weights again to measure how far the
program moved them.  This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from .spec import ModelSpec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EMBED, HEAD = 0, 1


def block_seed(seed: int, block: int) -> int:
    return (int(seed) * 1_000_003 + block * 7_919 + 17) % (2 ** 63 - 1)


def n_blocks(spec: ModelSpec) -> int:
    return 2 + spec.n_layers


def layer_block(i: int) -> int:
    return 2 + i


def _random_leaves(spec: ModelSpec, block: int
                   ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, scale) of each N(0, 1) leaf of ``block``."""
    d, v = spec.d_model, spec.vocab
    if block == EMBED:
        return [(("embed", "tok"), (v, d), 1.0)]
    if block == HEAD:
        return [] if spec.tie_embeddings else \
            [(("lm_head",), (d, v), 1.0 / math.sqrt(d))]
    if spec.kind == "decoder":
        h, hk, dh, f = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_ff
        s = 1.0 / math.sqrt(d)
        return [(("attn", "wq"), (d, h * dh), s),
                (("attn", "wk"), (d, hk * dh), s),
                (("attn", "wv"), (d, hk * dh), s),
                (("attn", "wo"), (h * dh, d), 1.0 / math.sqrt(h * dh)),
                (("ffn", "wi_gate"), (d, f), s),
                (("ffn", "wi_up"), (d, f), s),
                (("ffn", "wo_ff"), (f, d), 1.0 / math.sqrt(f))]
    di, n, r, kw = spec.d_inner, spec.ssm_state, spec.dt_rank, spec.ssm_conv
    return [(("mamba", "in_proj"), (d, 2 * di), 1.0 / math.sqrt(d)),
            (("mamba", "conv_w"), (kw, di), 1.0 / math.sqrt(kw)),
            (("mamba", "x_proj"), (di, r + 2 * n), 1.0 / math.sqrt(di)),
            (("mamba", "dt_w"), (r, di), 1.0 / math.sqrt(r)),
            (("mamba", "out_proj"), (di, d), 1.0 / math.sqrt(di))]


def _constant_leaves(spec: ModelSpec, block: int):
    """(path, shape, fill) of each leaf of ``block`` that is not drawn:
    norm scales 0 (applied as ``1 + scale``), the conv bias 0, the step
    size's bias -4.6 (softplus gives 0.01), ``A_log`` = log(1..N) and
    ``D`` = 1, both fp32, as the program's initialisers make them."""
    d = spec.d_model
    if block == EMBED:
        return []
    if block == HEAD:
        return [(("final_norm", "scale"), (d,), 0.0)]
    out = [(("norm1", "scale"), (d,), 0.0)]
    if spec.kind == "decoder":
        return out + [(("norm2", "scale"), (d,), 0.0)]
    di, n = spec.d_inner, spec.ssm_state
    return out + [(("mamba", "conv_b"), (di,), 0.0),
                  (("mamba", "dt_b"), (di,), -4.6),
                  (("mamba", "A_log"), (di, n), "A_log"),
                  (("mamba", "Dp"), (di,), "ones_fp32")]


def _put(tree: Dict, path: Tuple[str, ...], leaf: torch.Tensor) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def make_block(spec: ModelSpec, seed: int, block: int, device,
               dtype: torch.dtype = None) -> Dict:
    """The leaves of ``block`` as a nested dict (a layer's dict as the
    program keeps it in ``params["layers"][i]``; the embedding's and the
    head's under their top-level keys)."""
    dtype = dtype or DTYPES[spec.dtype]
    out: Dict = {}
    leaves = _random_leaves(spec, block)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    if total:
        gen = torch.Generator(device=device)
        gen.manual_seed(block_seed(seed, block))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        at = 0
        for path, shape, scale in leaves:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            if scale != 1.0:
                leaf.mul_(scale)
            _put(out, path, leaf)
            at += n
    for path, shape, fill in _constant_leaves(spec, block):
        if fill == "A_log":
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            leaf = torch.log(a)[None, :].repeat(shape[0], 1)
        elif fill == "ones_fp32":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            leaf = torch.full(shape, float(fill), dtype=dtype, device=device)
        _put(out, path, leaf)
    return out


def make_params(spec: ModelSpec, seed: int, device,
                dtype: torch.dtype = None) -> Dict:
    """The whole model in the program's layout."""
    params: Dict = {"embed": make_block(spec, seed, EMBED, device, dtype)["embed"]}
    head = make_block(spec, seed, HEAD, device, dtype)
    params.update(head)
    params["layers"] = [make_block(spec, seed, layer_block(i), device, dtype)
                        for i in range(spec.n_layers)]
    return params


def block_of(params: Dict, spec: ModelSpec, block: int) -> Dict:
    """The program's leaves of ``block``, in :func:`make_block`'s layout."""
    if block == EMBED:
        return {"embed": params["embed"]}
    if block == HEAD:
        out = {"final_norm": params["final_norm"]}
        if "lm_head" in params:
            out["lm_head"] = params["lm_head"]
        return out
    return params["layers"][block - 2]


def leaves_with_path(tree, path=()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def leaf_names(spec: ModelSpec) -> Iterator[Tuple[int, Tuple, str]]:
    """(block, path in the block, a name for reports) of every leaf, in
    the order of :func:`leaves_with_path` within each block."""
    for b in range(n_blocks(spec)):
        tree: Dict = {}
        for path, _, _ in _random_leaves(spec, b) + _constant_leaves(spec, b):
            _put(tree, path, None)
        for path, _ in leaves_with_path(tree):
            prefix = f"layers.{b - 2}." if b >= 2 else ""
            yield b, path, prefix + ".".join(path)
