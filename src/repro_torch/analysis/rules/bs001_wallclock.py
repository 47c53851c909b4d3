"""BS001 — no wall clocks or ambient randomness in deterministic layers.

The simulation, the property tests, and invariant 10's "identical runs
emit identical trees / byte-identical traffic" claims all rest on the
deterministic layers reading **only injected** clocks and RNGs.  A
``time.time()`` or module-level ``random.random()`` sneaking into
``core/``/``cluster/``/``query/``/``storage/``/``obs/``/``serve/``
breaks reproducibility invisibly: tests still pass, but two runs stop
being comparable.

Flagged: references to wall/monotonic clock functions (``time.time``,
``time.monotonic``, ``time.perf_counter``, ``datetime.now`` …), the
process-global RNGs (``random.*``, ``numpy.random.*``), ambient entropy
(``os.urandom``, ``uuid.uuid1/4``, ``secrets.*``), and seeded-RNG
factories called with **no** seed (``random.Random()``).  From torch:
its samplers (``torch.rand``, ``randn``, ``randint``, ``randperm``,
``normal``, ``bernoulli``, ``multinomial``, ``poisson``, the ``*_like``
ones) called without a ``generator=``, which draw from the process-global
generator, and every reseeding of that generator (``torch.seed``,
``torch.manual_seed``, their ``torch.random`` and ``torch.cuda`` forms).

Allowed: seeded factories — ``random.Random(seed)``,
``numpy.random.default_rng(seed)`` — a torch sampler handed its
``generator=`` (explicit by construction, as a key-passing RNG is), and
``torch.Generator(...)``, whose initial seed is fixed.

PyTorch port of :mod:`repro.analysis.rules.bs001_wallclock`, with
torch's process-global RNG as the counterpart of ``numpy.random.*``.
"""
from __future__ import annotations

import ast

from .base import Rule, register

WALL_CLOCK = frozenset({
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.clock_gettime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

AMBIENT_ENTROPY = frozenset({"os.urandom", "uuid.uuid1", "uuid.uuid4"})
ENTROPY_PREFIXES = ("secrets.",)

#: factories that *capture* a seed: fine when called with one
SEEDED_FACTORIES = frozenset({
    "random.Random",
    "numpy.random.default_rng", "numpy.random.RandomState",
})

GLOBAL_RNG_PREFIXES = ("random.", "numpy.random.")

#: torch samplers: they draw from the process-global generator unless
#: called with an explicit ``generator=``
TORCH_SAMPLERS = frozenset(
    f"torch.{name}" for name in (
        "rand", "randn", "randint", "randperm", "normal", "bernoulli",
        "multinomial", "poisson", "rand_like", "randn_like",
        "randint_like"))

#: calls that (re)seed torch's process-global generators
TORCH_GLOBAL_SEEDING = frozenset({
    "torch.seed", "torch.manual_seed",
    "torch.random.seed", "torch.random.manual_seed",
    "torch.cuda.seed", "torch.cuda.seed_all",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
})


def _passes_generator(call: ast.Call) -> bool:
    """``generator=`` given, and not as a literal ``None``."""
    return any(kw.arg == "generator"
               and not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
               for kw in call.keywords)


@register
class WallClockRule(Rule):
    id = "BS001"
    title = "deterministic layers read only injected clocks/RNGs"
    invariant = "determinism substrate (invariants 9–10, cluster sim)"

    def __init__(self, ctx):
        super().__init__(ctx)
        self._consumed = set()  # func nodes already judged by visit_Call

    def applies(self) -> bool:
        return self.ctx.rel.startswith(
            tuple(self.ctx.config.deterministic_layers))

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self.ctx.resolver.dotted(node.func)
        if dotted in SEEDED_FACTORIES:
            self._consumed.add(id(node.func))
            if not node.args and not node.keywords:
                self.report(node, f"unseeded {dotted}() — pass an explicit "
                                  f"seed so runs are reproducible")
        elif dotted in TORCH_SAMPLERS:
            self._consumed.add(id(node.func))
            if not _passes_generator(node):
                self.report(node, f"{dotted}() without generator= draws "
                                  f"from torch's process-global RNG — pass "
                                  f"an injected, seeded torch.Generator")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._check(node)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        self._check(node)

    def _check(self, node: ast.AST) -> None:
        if id(node) in self._consumed:
            return
        dotted = self.ctx.resolver.dotted(node)
        if dotted is None:
            return
        if dotted in WALL_CLOCK:
            self.report(node, f"wall-clock read {dotted} in a deterministic "
                              f"layer — inject a clock instead")
        elif dotted in AMBIENT_ENTROPY or dotted.startswith(ENTROPY_PREFIXES):
            self.report(node, f"ambient entropy {dotted} in a deterministic "
                              f"layer — inject a seeded Rng instead")
        elif (dotted.startswith(GLOBAL_RNG_PREFIXES)
                and dotted not in SEEDED_FACTORIES) \
                or dotted in TORCH_SAMPLERS:
            self.report(node, f"process-global RNG {dotted} in a "
                              f"deterministic layer — use an injected, "
                              f"seeded Random/Generator instance")
        elif dotted in TORCH_GLOBAL_SEEDING:
            self.report(node, f"{dotted} reseeds torch's process-global RNG "
                              f"in a deterministic layer — seed an injected "
                              f"torch.Generator instead")
