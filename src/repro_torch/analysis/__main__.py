"""``python -m repro_torch.analysis [paths...]`` — run bigset-lint on the
port.

Exit status: 0 clean, 1 findings, 2 usage error.  ``--json-out`` writes
the machine-readable report beside whatever lands in the log, so CI gets
both the human lines and the artifact from one invocation.

PyTorch port of :mod:`repro.analysis.__main__`; the default path is the
port's package, ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .config import DEFAULT_CONFIG
from .engine import run_lint
from .report import render_human, render_json_text, render_rule_list
from .rules import RULES


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="bigset-lint: AST-level enforcement of the architecture "
                    "invariants (docs/ARCHITECTURE.md § Static analysis).")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directory trees to lint "
                             "(default: src/repro_torch)")
    parser.add_argument("--format", choices=("human", "json"), default="human")
    parser.add_argument("--json-out", metavar="PATH",
                        help="also write the JSON report to PATH")
    parser.add_argument("--select", metavar="IDS",
                        help="comma list of rule ids to run (default: all)")
    parser.add_argument("--ignore", metavar="IDS", default="",
                        help="comma list of rule ids to skip")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule pack and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(render_rule_list())
        return 0

    def _ids(spec: str):
        ids = frozenset(s.strip() for s in spec.split(",") if s.strip())
        unknown = ids - set(RULES)
        if unknown:
            parser.error(f"unknown rule id(s): {', '.join(sorted(unknown))}")
        return ids

    config = DEFAULT_CONFIG.with_rules(
        select=_ids(args.select) if args.select else None,
        ignore=_ids(args.ignore) if args.ignore else frozenset())

    result = run_lint(args.paths, config)
    print(render_json_text(result) if args.format == "json"
          else render_human(result))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(render_json_text(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
