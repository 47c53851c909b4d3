"""Logical-axis sharding: MaxText-style rules mapping logical names to mesh
axes, applied to :class:`~torch.distributed.tensor.DTensor`\\ s.

PyTorch port of :mod:`repro.models.sharding`.  Model code annotates
activations with *logical* axes (``batch``, ``seq``, ``embed``, ``heads``,
``ff``, ``vocab``, ``kv_seq``, ``experts``…); the launcher installs a
:class:`ShardingRules` context binding them to the axes of a
:class:`~torch.distributed.device_mesh.DeviceMesh` per cell (e.g.
``batch → ('pod','data')`` for training, ``kv_seq → 'data'`` for
long-context decode).  With no context installed every annotation is a
no-op, and so it is for a plain tensor: the same model code runs
everywhere, and a run without DTensors is bit for bit the run it was.

A spec (:class:`P`) mirrors JAX's ``PartitionSpec``: one entry a tensor
dim, each a mesh-axis name, a tuple of names (major to minor), or None.
:func:`placements` turns it into DTensor placements: each mesh dim named
for tensor dim ``i`` is ``Shard(i)``, every other mesh dim ``Replicate()``.
Where JAX's ``with_sharding_constraint`` lets GSPMD propagate, ``constrain``
redistributes the DTensor there and then, so the collectives it takes are
DTensor's choice, op by op.

Parameter shardings use the same rules via :func:`param_pspec`, which maps
leaf *path names* to logical axis tuples and degrades gracefully when a
dimension does not divide the mesh axis (falls back to replication for that
dim — e.g. whisper's 51865 vocab over a 16-way model axis).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from ..tree import map_tree_with_path

Axis = Union[str, Tuple[str, ...], None]


class P:
    """A partition spec: one entry a tensor dim (JAX's ``PartitionSpec``;
    a one-name tuple is that name, as there).  Not a tuple, so the port's
    tree walks take it as a leaf; it compares equal to a tuple of the same
    entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Axis):
        self.entries = tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                             else a for a in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.entries == other.entries
        if isinstance(other, tuple):
            return self.entries == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh (or anything with
    ``mesh_dim_names`` and ``shape``): JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _flat(a: Axis) -> Tuple[str, ...]:
    return a if isinstance(a, tuple) else (a,) if a else ()


@dataclass
class ShardingRules:
    mesh: Any
    rules: Dict[str, Axis] = field(default_factory=dict)

    def axis(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, *logical: Optional[str]) -> P:
        return P(*[self.axis(l) for l in logical])

    def mesh_axis_size(self, axis: Axis) -> int:
        sizes = mesh_axes(self.mesh)
        n = 1
        for a in _flat(axis):
            n *= sizes[a]
        return n


_CTX = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_CTX, "rules", None)


@contextmanager
def sharding_rules(rules: Optional[ShardingRules]):
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield rules
    finally:
        _CTX.rules = prev


def guard(shape: Sequence[int], spec: Sequence[Axis],
          rules: ShardingRules) -> P:
    """``spec`` for trailing dims ``shape`` with the JAX package's two
    guards: a dim that does not divide its axis is replicated, and a mesh
    axis shards at most one dim (earlier dims win)."""
    out = []
    used: set = set()
    for dim, a in zip(shape, spec):
        if a is not None and dim % rules.mesh_axis_size(a) != 0:
            a = None
        flat = _flat(a)
        if any(f in used for f in flat):
            a = None
        used.update(flat)
        out.append(a)
    return P(*out)


def logical_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 rules: ShardingRules) -> P:
    """The guarded spec of a tensor of ``shape`` annotated ``logical``."""
    if len(shape) != len(logical):
        raise ValueError(
            f"axis annotation arity mismatch: {tuple(shape)} vs {tuple(logical)}")
    return guard(shape, [rules.axis(l) for l in logical], rules)


def placements(spec: Sequence[Axis], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim named for tensor dim ``i``, ``Replicate()`` elsewhere.  A
    tuple entry names its mesh dims major to minor, which must be the
    mesh's own order (DTensor shards a dim over mesh dims in that order).
    A mesh dim of size 1 replicates (one shard is the whole), so a 1×1
    mesh never needs a collective."""

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for i, a in enumerate(spec):
        flat = _flat(a)
        idx = [names.index(f) for f in flat]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {a!r} is not in the mesh's axis order {names}")
        for j in idx:
            if sizes[j] > 1:
                out[j] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: a DTensor is
    redistributed to the rules' placements; without a context, or for a
    plain tensor, a no-op."""
    r = current_rules()
    if r is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(
            f"axis annotation arity mismatch: {tuple(x.shape)} vs {logical}")
    if not is_dtensor(x):
        return x
    spec = logical_spec(x.shape, logical, r)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x [..., n*d]`` as ``[..., n, d]`` (heads).  A DTensor whose last
    dim is cut into shards that do not hold whole heads (24 heads over a
    16-way axis) is gathered on that dim first: DTensor cannot split a
    dim whose shards straddle the new one."""
    if is_dtensor(x):
        last = Shard(x.dim() - 1)
        k = 1
        for j, p in enumerate(x.placements):
            if p == last:
                k *= x.device_mesh.size(j)
        if n % k:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == last else p for p in x.placements])
    return x.reshape(*x.shape[:-1], n, d)


class _MergeLast(torch.autograd.Function):
    """``[..., n, d]`` → ``[..., n*d]`` whose gradient is split back into
    heads after :func:`split_last`'s gather where its shards would
    straddle them."""

    @staticmethod
    def forward(ctx, x, n, d):
        ctx.nd = (n, d)
        return x.reshape(*x.shape[:-2], n * d)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, *ctx.nd), None, None


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n, d]`` as ``[..., n*d]`` (heads back into features).  For
    a DTensor the gradient, which the next product may shard on the
    features, is gathered before it is split into heads
    (:func:`split_last`)."""
    n, d = x.shape[-2:]
    if is_dtensor(x):
        return _MergeLast.apply(x, n, d)
    return x.reshape(*x.shape[:-2], n * d)


def local_rows(x: torch.Tensor, parts: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``parts`` of a DTensor batch, cut from each rank's own
    rows (no collective): a microbatch holds every rank's share of the
    rows, where a plain batch's part ``i`` is the ``i``-th run of rows."""

    local = x.to_local()
    part = local.reshape((parts, local.shape[0] // parts)
                         + tuple(local.shape[1:]))[i]
    return DTensor.from_local(part, x.device_mesh, x.placements,
                              run_check=False)


def _folds(shape: Sequence[int], target: Sequence[int]):
    """The runs of ``shape``'s dims that ``reshape(target)`` folds into one
    (each as a list of its dims larger than 1)."""
    runs, i = [], 0
    for o in target:
        run, p = [], 1
        while i < len(shape) and (p < o or (shape[i] == 1 and p == o)):
            p *= shape[i]
            if shape[i] > 1:
                run.append(i)
            i += 1
        if p != o:
            return []  # a split, not a fold
        runs.append(run)
    return runs


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  DTensor folds a run of dims into one only
    where the run's first dim alone is sharded: a DTensor has the later
    dims of each folded run gathered first."""
    if is_dtensor(x):
        later = {Shard(d) for run in _folds(tuple(x.shape), shape)
                 for d in run[1:]}
        if any(p in later for p in x.placements):
            x = x.redistribute(x.device_mesh, [
                Replicate() if p in later else p for p in x.placements])
    return x.reshape(*shape)


def reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending partial sums reduced (all-reduced to replicas
    on those mesh dims); a plain tensor as it is."""
    if not is_dtensor(x):
        return x

    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)``; a DTensor (torch 2.11 has no
    sharding strategy for it) rolls each rank's shard, ``dim`` gathered
    whole first."""
    if not is_dtensor(x):
        return torch.roll(x, shift, dims=dim)
    pl = tuple(Replicate() if p == Shard(dim) else p for p in x.placements)
    return local_map(lambda t: torch.roll(t, shift, dims=dim),
                     out_placements=list(pl), in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def _gather_middle(x: torch.Tensor) -> torch.Tensor:

    middle = {Shard(i) for i in range(1, x.dim() - 1)}
    if not any(p in middle for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p in middle else p for p in x.placements])


class _RowsWholeGrad(torch.autograd.Function):
    """The identity, whose gradient comes with its rows whole."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _gather_middle(g) if is_dtensor(g) and g.dim() >= 3 else g


def rows_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a product's left operand: a DTensor whose middle dims
    (``seq`` between ``batch`` and the features) are sharded has them
    gathered first, as sequence parallelism gathers the sequence before a
    column-parallel product.  A product folds ``[B, T, ...]`` into rows,
    which DTensor cannot do across dims sharded on different mesh axes
    (torch 2.11 refuses it; later versions redistribute all the same)."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    return _gather_middle(x)


def rows_whole_grad(y: torch.Tensor) -> torch.Tensor:
    """``y`` (a product's output) whose gradient reaches the product with
    its rows whole, as :func:`rows_whole` gives its input: the product's
    backward folds the gradient into rows too."""
    if not is_dtensor(y) or y.dim() < 3 or not y.requires_grad:
        return y
    return _RowsWholeGrad.apply(y)


# --------------------------------------------------------------- param rules
# leaf-name -> logical axes of the LAST ndim dims (leading stack dims -> None)
PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "tok": ("vocab", "embed_shard"),
    "pos": (None, None),
    "lm_head": ("embed_shard", "vocab"),
    "wq": ("embed_shard", "heads"),
    "wk": ("embed_shard", "heads"),
    "wv": ("embed_shard", "heads"),
    "wo": ("heads", "embed_shard"),
    "q_norm": (None,),
    "k_norm": (None,),
    "wi_gate": ("embed_shard", "ff"),
    "wi_up": ("embed_shard", "ff"),
    "wo_ff": ("ff", "embed_shard"),
    "router": ("embed_shard", None),
    "e_gate": ("experts", "embed_shard", "ff"),
    "e_up": ("experts", "embed_shard", "ff"),
    "e_down": ("experts", "ff", "embed_shard"),
    "in_proj": ("embed_shard", "ff"),
    "conv_w": (None, "ff"),
    "conv_b": ("ff",),
    "x_proj": ("ff", None),
    "dt_w": (None, "ff"),
    "dt_b": ("ff",),
    "A_log": ("ff", None),
    "Dp": ("ff",),
    "out_proj": ("ff", "embed_shard"),
    "scale": (None,),
    "bias": (None,),
}

# default logical -> physical binding used by the launcher; per-cell overrides
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    # Megatron-style sequence parallelism: residuals / norms / elementwise
    # work and the scan-saved activations are seq-sharded over 'model';
    # the port's constrain redistributes around attention and back after
    # (the collective cost shows up in the roofline's collective term).
    "seq": "model",
    "embed": None,            # activation embed dim: replicated
    "embed_shard": "data",    # parameter embed dim: FSDP-sharded over data
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "experts": None,          # TP-MoE baseline: experts replicated, ff sharded
    "kv_heads": "model",
    "kv_seq": None,
    "ssm_state": None,
    "ce_seq": "model",        # CE chunk sequence dim (distributes logits)
    "attn_q": "model",        # attention q-chunk dim (fallback when heads
                              # don't divide the axis; deduped otherwise)
    "moe_cap": "model",       # MoE expert-capacity dim (dispatch buffers)
    "moe_slots": "model",     # MoE token-slot dim ([B, T·K, D] tensors)
}


def make_rules(mesh, **overrides: Axis) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    names = set(mesh.mesh_dim_names)

    # drop axes the mesh doesn't have (e.g. 'pod' on the single-pod mesh)
    def filter_axis(a: Axis) -> Axis:
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(x for x in a if x in names)
            return kept if kept else None
        return a if a in names else None

    rules.update(overrides)
    rules = {k: filter_axis(v) for k, v in rules.items()}
    return ShardingRules(mesh=mesh, rules=rules)


def param_pspec(path: str, ndim: int, shape: Tuple[int, ...],
                rules: ShardingRules) -> P:
    """Spec for a parameter leaf by its path name."""
    name = path.split("/")[-1]
    logical = PARAM_RULES.get(name)
    if logical is None:
        return P()
    spec = [None] * (ndim - len(logical)) + [rules.axis(l) for l in logical]
    # replicate non-divisible dims; a mesh axis shards at most one dim
    # (earlier logical axes win — e.g. EP: experts take 'model', ff yields)
    return guard(tuple(shape)[-len(spec):], spec, rules)


def path_name(path) -> str:
    return "/".join(str(k) for k in path)


def tree_pspecs(params, rules: ShardingRules):
    """Map a parameter tree to a same-structure tree of specs."""
    return map_tree_with_path(
        lambda path, leaf: param_pspec(path_name(path), leaf.dim(),
                                       tuple(leaf.shape), rules), params)


def tree_shardings(params, rules: ShardingRules):
    """The tree of DTensor placements of :func:`tree_pspecs`."""
    return map_tree_with_path(
        lambda _, s: placements(s, rules.mesh), tree_pspecs(params, rules))


def distribute(tree, specs, mesh):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec in
    ``specs`` (a same-structure tree).  Every rank holds the whole tree
    and takes its own shard: no collective."""

    return map_tree_with_path(
        lambda _, t, s: distribute_tensor(t, mesh, placements(s, mesh),
                                          src_data_rank=None),
        tree, specs)


# ------------------------------------------------------ kernels on DTensors
def shard_index(mesh, axis: Axis) -> int:
    """This rank's coordinate along ``axis`` (a name, or names major to
    minor) of ``mesh``."""
    sizes = mesh_axes(mesh)
    idx = 0
    for a in _flat(axis):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _grad_placements(pl: tuple, split: set) -> tuple:
    """An input's gradient placements when each rank's kernel sees only
    its share of the work: replicated over a mesh dim that splits the
    work, the local gradient is a partial sum there."""

    return tuple(Partial() if (j in split and isinstance(p, Replicate))
                 else p for j, p in enumerate(pl))


def local_kernel(fn, args: Sequence, in_logical: Sequence,
                 outs: Sequence, *, split_by: Optional[int] = None):
    """``fn`` (a kernel wrapper) over the local shards of DTensor ``args``
    through ``local_map``: each arg placed by its logical axes under the
    installed rules (all replicated without rules), each output
    ``(shape, logical)`` likewise.  ``split_by`` names the arg whose
    sharded mesh dims split the work (a scan's rows and channels): an arg
    replicated over one of them gets a partial-sum gradient there."""

    rules = current_rules()
    mesh = next(a.device_mesh for a in args if is_dtensor(a))

    def pl(shape, logical) -> tuple:
        if rules is None:
            return placements(P(), mesh)
        return placements(logical_spec(shape, logical, rules), mesh)

    in_pl = tuple(pl(a.shape, l) for a, l in zip(args, in_logical))
    grad_pl = None
    if split_by is not None:
        split = {j for j, p in enumerate(in_pl[split_by])
                 if isinstance(p, Shard)}
        grad_pl = tuple(_grad_placements(p, split) for p in in_pl)
    out_pl = tuple(pl(shape, l) for shape, l in outs)
    # one output's placements go as a list (a tuple means one per output)
    return local_map(fn, out_placements=out_pl if len(outs) > 1 else list(out_pl[0]),
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def attention_map(fn, q, k, v, *extra):
    """``fn(q, k, v, *extra)`` (an attention kernel wrapper) over local
    shards through ``local_map``: q ``[B, Hq, ...]`` placed by
    ``("batch", "heads")``, k / v ``[B, Hkv, S, D]`` by ``("batch",
    "kv_heads")`` with S whole, each extra (``cache_len``) by ``"batch"``.
    Where the rules shard q's heads and not k / v's (GQA whose KV heads do
    not divide the axis: the guard replicates them), each rank cuts k / v
    to the KV heads of its own q heads, and their gradient is a partial
    sum over that axis."""

    rules = current_rules()
    mesh = q.device_mesh
    if rules is None:
        qs, ks = P(), P()
    else:
        qs = logical_spec(q.shape, ("batch", "heads") + (None,) * (q.dim() - 2),
                          rules)
        ks = logical_spec(k.shape, ("batch", "kv_heads", None, None), rules)
    q_ax = qs[1] if len(qs) > 1 else None
    kv_ax = ks[1] if len(ks) > 1 else None
    cut = q_ax is not None and kv_ax is None
    if kv_ax is not None and kv_ax != q_ax:
        raise ValueError(f"kv heads on {kv_ax!r} but q heads on {q_ax!r}")
    Hq, Hkv = q.shape[1], k.shape[1]
    q_pl, kv_pl = placements(qs, mesh), placements(ks, mesh)
    kv_grad = kv_pl
    if cut:
        names = tuple(mesh.mesh_dim_names)
        on = {names.index(a) for a in _flat(q_ax)}
        kv_grad = tuple(Partial() if j in on else p
                        for j, p in enumerate(kv_pl))
    ex_pl = tuple(placements(P(qs[0]) if len(qs) else P(), mesh)
                  for _ in extra)

    def local(ql, kl, vl, *ex):
        if cut:
            group, hq = Hq // Hkv, ql.shape[1]
            first = shard_index(mesh, q_ax) * hq
            lo, hi = first // group, (first + hq - 1) // group + 1
            if hq % (hi - lo) or (hq >= group and hq % group):
                raise ValueError(
                    f"{hq} local q heads do not cover whole KV groups of "
                    f"{group}")
            kl, vl = kl[:, lo:hi].contiguous(), vl[:, lo:hi].contiguous()
        return fn(ql, kl, vl, *ex)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl) + ex_pl,
                     in_grad_placements=(q_pl, kv_grad, kv_grad) + ex_pl,
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v,
                                                                 *extra)
