"""Decode-step times of the port's serve paths, compared across checkouts on
one card.

    python3 serve_decode_ab.py DIR [DIR ...]

Each DIR is the root of a checkout of this repository (its
``chip_smoke.py`` and ``src/``).  For each, in the order given, a fresh
process builds the kernels and runs ``chip_smoke.py``'s three serve phases
(``gemma3-27b``, ``falcon-mamba-7b``, ``granite-moe-1b-a400m``: each
serves its prompts and decodes 30 steps, with every attention and scan
call checked on the kernels, then profiles a few decode steps), and each
arch's ``ms_per_decode_step`` and ``prefill_tok_per_s`` (the served
line) and the profiled decode step's ``traced_wall_ms_per_call`` and
``device_ms_per_call`` are read back.  Alternate the parent and the
change (``PARENT CHANGE CHANGE PARENT ...``) so that drift on the card
shows.  The last line of the output is one JSON object: the card's name
and power limit, and ``runs``, a list of ``{"dir", arch: {...}}`` in run
order.  Needs a CUDA card.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

PHASES = """
import sys
sys.path.insert(0, "src")
import numpy as np
import torch
import chip_smoke as cs
cs.phase_device(torch)
cs.phase_build()
cs.phase_model(torch, np)
cs.phase_ssm_model(torch, np)
cs.phase_moe_model(torch, np)
"""
SERVED = re.compile(r"^\[model (\S+)\] served: (\{.*\})$")
PROFILED = re.compile(r"^\[model profile\] decode step: (\{.*\})$")


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", PHASES], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out, arch = {"dir": str(root)}, None
    for line in proc.stdout.splitlines():
        m = SERVED.match(line)
        if m:
            arch, stats = m.group(1), json.loads(m.group(2))
            out[arch] = {k: stats[k] for k in ("ms_per_decode_step",
                                               "prefill_tok_per_s")}
        m = PROFILED.match(line)
        if m and arch is not None:
            stats = json.loads(m.group(1))
            out[arch].update({k: stats[k] for k in (
                "traced_wall_ms_per_call", "device_ms_per_call")})
    if len(out) != 4 or any(len(v) != 4 for k, v in out.items()
                            if k != "dir"):
        raise SystemExit(f"{root}: the three serve phases not all read")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = []
    for d in sys.argv[1:]:
        runs.append(run(Path(d).resolve()))
        print(json.dumps(runs[-1]), flush=True)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
