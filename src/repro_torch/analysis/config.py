"""bigset-lint configuration: which rules run, and where.

Every scoping decision the rule pack makes is data here, not code in the
rules: the deterministic layers BS001 patrols, the protected field sets
BS003 guards, the storage entry points BS005 forbids, the import
allowlist BS006 grants kernel launchers.  Paths are matched against the
location of a file *inside* the ``repro_torch`` package (``core/clock.py``,
``kernels/dot_seen/kernel.py``), so the same config lints the installed
tree and the test fixtures alike.

PyTorch port of :mod:`repro.analysis.config`: the same layers, since the
port keeps the reference's layout, with BS006's scope read for the port's
split of a kernel package (``kernel.py`` launches ``csrc/*.cu``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import FrozenSet, Mapping, Optional, Tuple


@dataclass(frozen=True)
class LintConfig:
    # ----------------------------------------------------------- rule choice
    #: run only these rule ids (None = every registered rule)
    select: Optional[FrozenSet[str]] = None
    #: never run these rule ids
    ignore: FrozenSet[str] = frozenset()

    # ------------------------------------------------------------ BS001 scope
    #: layers whose behaviour must be reproducible from injected inputs:
    #: identical seeds/clocks must yield identical traffic, trees, and bytes
    deterministic_layers: Tuple[str, ...] = (
        "core/", "cluster/", "query/", "storage/", "obs/", "serve/",
    )

    # ------------------------------------------------------------ BS002 types
    #: receiver types whose ``.send`` must bill explicit wire bytes
    network_types: FrozenSet[str] = frozenset({"Network"})
    #: receiver *names* treated as networks when the type cannot be resolved
    network_attr_hints: FrozenSet[str] = frozenset({"net", "network"})

    # ----------------------------------------------------------- BS003 fields
    #: type -> fields that only ``mutation_home`` may attribute-assign
    protected_fields: Mapping[str, Tuple[str, ...]] = field(
        default_factory=lambda: {
            "Clock": ("base", "cloud", "runs"),
            "SetDigest": ("bucket_limit", "fences", "buckets", "counts",
                          "limits", "_total", "_pend_add", "_pend_sub",
                          "_surv"),
        })
    #: the one layer allowed to mutate those fields (their defining home)
    mutation_home: str = "core/"

    # ------------------------------------------------------------ BS004 scope
    #: paths where bare ``assert`` is tolerated (test support only)
    assert_exempt: Tuple[str, ...] = ("testing/",)

    # ------------------------------------------------------------ BS005 scope
    #: layers bound by invariant 4 ("queries seek, never fold")
    seek_only_layers: Tuple[str, ...] = ("query/", "serve/")
    #: full-fold entry points those layers must never call
    fold_denylist: FrozenSet[str] = frozenset(
        {"fold", "fold_values", "read_full", "value"})

    # ----------------------------------------------------------- BS006 scope
    #: glob (against the package-relative path) naming the kernel
    #: launchers: each binds and launches its package's ``csrc/*.cu``
    kernel_glob: str = "kernels/*/kernel.py"
    #: top-level modules a launcher may import; everything else —
    #: numpy, jax — belongs in the sibling ``ref.py``/``ops.py``
    kernel_allowed_roots: FrozenSet[str] = frozenset(
        {"__future__", "torch", "ctypes", "functools", "typing", "math",
         "pathlib", "collections"})
    #: relative imports a launcher may make (regexes, full match against
    #: the dotted spec, ``..build`` or ``..flash_attention.kernel``): the
    #: build loader and another kernel's launcher.  A sibling ``ref`` or
    #: ``ops`` is how the plain version would cross into the card's path
    kernel_allowed_relative: Tuple[str, ...] = (
        r"\.\.build", r"\.\.\w+\.kernel")

    # ----------------------------------------------------------- BS007 scope
    #: the layer whose memtables are WAL-guarded (invariant 11)
    memtable_layer: str = "storage/"
    #: functions allowed to mutate a ``memtable``: the WAL-billed write
    #: path, the flush/recovery lifecycle, and construction — everything
    #: else would apply state a crash could not replay
    memtable_entrypoints: FrozenSet[str] = frozenset(
        {"__init__", "put_batch", "flush", "recover"})

    # ----------------------------------------------------------- BS008 scope
    #: Clock members that materialise the raw per-dot cloud; outside
    #: ``mutation_home`` only the run-granular surface is sanctioned
    dot_enumeration_fields: FrozenSet[str] = frozenset({"cloud"})
    #: Clock methods that enumerate every dot (``diff_dots`` stays allowed:
    #: it materialises only the actual divergence)
    dot_enumeration_calls: FrozenSet[str] = frozenset({"all_dots"})

    # ----------------------------------------------------------- BS009 scope
    #: the one module allowed to turn positions into vnode identities
    placement_home: str = "cluster/placement.py"
    #: collection names whose literal-int subscripts are placement
    #: decisions (``self.vnodes[0]`` hardwires an owner the ring may move)
    vnode_collections: FrozenSet[str] = frozenset(
        {"vnodes", "actors", "stores"})
    #: routing helpers that must not be fed literal vnode positions
    vnode_route_calls: FrozenSet[str] = frozenset({"_actor", "_coordinator"})

    # ------------------------------------------------------------------ misc
    def runs(self, rule_id: str) -> bool:
        if rule_id in self.ignore:
            return False
        return self.select is None or rule_id in self.select

    def with_rules(self, select: Optional[FrozenSet[str]] = None,
                   ignore: Optional[FrozenSet[str]] = None) -> "LintConfig":
        kw = {}
        if select is not None:
            kw["select"] = frozenset(select)
        if ignore is not None:
            kw["ignore"] = frozenset(ignore)
        return replace(self, **kw)


DEFAULT_CONFIG = LintConfig()
