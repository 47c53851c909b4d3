#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles every CUDA kernel of the port (``dot_seen``,
   ``flash_attention`` and its backward, ``decode_attention``,
   ``mamba_scan`` and its backward, ``clock_ops``) from the checkout's
   sources with ``nvcc``, one process per source, started together, and
   beside them prints what ``nvcc -Xptxas -v`` reports (registers, shared
   memory, spills) for the attention kernels' tensor-core and split-KV
   routes, both routes of the attention backward, the scan and its
   backward, ``dot_seen`` and the clock merge and popcount;
3. kernels — holds each kernel against its plain PyTorch version on the
   card: ``dot_seen`` bit for bit at the bigset serve path's shape and a
   stress shape, beside an empty launch's device time (the floor a launch
   can reach); ``flash_attention`` (bf16 on its tensor-core route, fp32
   on its SIMT route) and ``decode_attention`` (split-KV) in bf16 and fp32
   at the model serve path's shapes (global and local layers: a window of
   1,024 in prefill, a ring of 1,024 slots in decode), the MoE serve
   paths' (16 over 8 heads of 64, 48 over 8 of 128), the hybrid's (64
   over 8 of 128), the dense family's last two (``pixtral-12b``'s 32 over
   8 and ``mistral-large-123b``'s 96 over 8 of 128; the latter's decode
   on the chunked grid, as the launcher reports the grid it launched),
   the encoder-decoder's (6 heads of 64, not causal:
   a decode step's cross-attention, one query against 1,500 encoder
   positions, a training microbatch's cross-attention, 448 against 1,500,
   and its encoder, 1,500 against 1,500; decode at 448 slots) and a stress
   shape (head dim 256, MHA, ragged lengths), within the CPU tests'
   tolerances.
   It times the wrapper and the device (a CUDA graph of launches) with
   CUDA events, the plain version, and, beside each attention kernel,
   PyTorch's ``scaled_dot_product_attention`` on the same inputs and mask
   (a yardstick the port never calls); ``mamba_scan``, ``y`` and the
   final state, at the SSM prefill's shape (T = 1,536, D = 8,192, N = 16)
   in fp32 and in bf16 (the path's type), the hybrid's (D = 16,384, bf16),
   a stress shape (B = 4, ragged
   T = 777), N = 8 at D = 64 and a long prompt (T = 8,192), each timed
   beside its byte bound and the floor of its exps on the special-function
   units; the clock
   lattice's merge (``join``, ``subtract``, ``intersect``: the kernel's
   canonical rows against the plain version's, sorted) and ``popcount``
   bit for bit at the bigset path's tombstone shape (one actor of 2,000
   runs), at 512 actors of 128 and of 1,024 runs, at 4 actors of 8,192 runs
   (too wide for shared memory: the merge's global-memory route) and at an
   edge case (counters at 2^31 - 1 and -2^31, unsorted, overlapping and
   duplicated runs, popcounts that wrap), with each op's wrapper and
   device time at every shape;
4. main path — the bigset serve flow on ``cuda`` through the port's
   public entry points (``BigsetCluster`` → ``BigsetService`` →
   ``BigsetClient``): 3 replicas, 100,000 eight-byte elements, 2,000
   context-less removes, a full paginated Scan, the backpressure demo, a
   membership → context-remove round trip and a Count, every answer held
   against a Python set; the ``dot_seen`` counts are zeroed just before
   and read just after;
5. clock lattice — the ``clock_ops`` entry point on the clocks the main
   path left: every replica's set clock and tombstone, dense on the card,
   joined, subtracted and intersected pairwise and counted, every answer
   equal to the sparse ``Clock``'s own; the ``clock_ops`` counts are zeroed
   just before and read just after;
6. parity — the same flow at 20,000 elements and 400 removes on ``cpu``
   (the plain versions) and on ``cuda`` must give identical pages;
7. cluster — the main path through a partitioned, durable, lossy
   cluster on ``cuda``: 8 vnodes on a ring of 64 partitions, factor 3, a
   network that drops, duplicates and reorders, WAL group commit of 8;
   50,000 eight-byte elements (cut from 100,000) with 16-byte values
   written over the wire from rotating coordinators, 500 context-less
   removes, a seeded kill
   point tearing ``v0``'s WAL mid-batch, its crash and replay (every
   write durable at the barrier before must survive), anti-entropy in
   whole sweeps until quiet, a ninth vnode joining with handoff until it
   drains, anti-entropy again, 500 more removes and anti-entropy, then
   a full Scan at page size 1,000 and r=2, a Count and a membership
   context round trip through the service, every answer held against a
   Python model; the
   ``dot_seen`` counts are zeroed just before and read just after, and
   the clock lattice runs on every partition's healed clocks;
8. cluster parity — the same flow at 10,000 elements and 200 removes
   (cut from 20,000 and 400) on ``cpu`` and on ``cuda``: identical pages, network traffic,
   anti-entropy ledger, ring state, recovery and handoff;
9. model — the model serve path: the full 62-layer ``gemma3-27b`` in
   bf16 with random weights (seed 0) on ``cuda`` through ``ServeEngine``
   (``max_batch=4, max_len=2048``), 6 seeded requests (four prompts of
   4–16 tokens, one of 1,280 and one of 1,536), 16 new tokens each; the
   attention counts are zeroed just before and read just after, and every
   dispatch must have launched the CUDA kernels: every prefill on the
   flash kernel's tensor-core route, every decode step on the split-KV
   kernels;
10. model parity — the smoke ``gemma3-27b`` (fp32) served on ``cpu`` (the
   plain versions) and on ``cuda`` (the kernels) gives identical greedy
   token streams and logits within 1e-4; the smoke ``pixtral-12b`` (fp32)
   with seeded ``patch_embeds`` gives identical greedy streams and logits
   within 1e-4 on both, and other logits without the patches;
11. SSM model — the SSM serve path, after the ``gemma3-27b`` model is
   freed: the full 64-layer ``falcon-mamba-7b`` in bf16 with random
   weights (seed 0) through the same engine and the same six prompts; the
   ``mamba_scan`` counts are zeroed just before and read just after, and
   every one of the 64 x 6 prefill scans must have launched the kernel on
   the model's bf16 activations;
12. SSM parity — the smoke ``falcon-mamba-7b`` (fp32) on ``cpu`` and on
    ``cuda``: identical greedy token streams and logits within 1e-4; in
    bf16 (its scans read bf16), logits within 2e-2;
13. MoE model — the MoE serve path: the full 24-layer
    ``granite-moe-1b-a400m`` (32 experts, top 8) in bf16 with random
    weights (seed 0) through the same engine and six prompts, with the
    same launch checks as the model phase, the share of token-slots that
    capacity dropped in each prefill (decode must drop none) and peak
    memory;
14. grok model — ``grok-1-314b`` at full width (d_model 6,144, 48 over 8
    heads of 128, 8 experts top 2 of d_ff 32,768, its int8 KV cache) with
    its depth cut from 64 to 6 layers (60.7 GB of bf16 weights), after
    every earlier model is freed, through the same engine and prompts;
    every decode step reads the dequantised int8 cache through the decode
    kernel;
15. hybrid model — ``jamba-1.5-large-398b`` at full width (d_model
    8,192, 64 over 8 heads of 128, d_inner 16,384, 16 experts top 2 of
    d_ff 24,576, its int8 KV cache) with its depth cut from 72 to 5 layers
    (4 Mamba and 1 attention mixer; 48.1 GB of bf16 weights), after every
    earlier model is freed, through the same engine and prompts; the
    launch checks count mixers: a flash launch an attention layer and
    prompt, a decode launch an attention layer and step, a scan launch (in
    bf16) a Mamba layer and prompt;
16. dense model — ``mistral-large-123b`` at full width (d_model 12,288,
    96 over 8 heads of 128, d_ff 28,672, its int8 KV cache) with its depth
    cut from 88 to 12 layers (34.8 GB of bf16 weights), after every
    earlier model is freed, through the same engine and prompts: every
    decode step reads the dequantised int8 cache through the decode
    kernel on its chunked grid (a group of 12 query heads cut into two
    blocks of 6); decode ms a step beside the floor of its weight reads;
17. MoE parity — the smoke ``granite-moe-1b-a400m`` and the smoke
    ``grok-1-314b`` (fp32; grok's int8 cache kept) on ``cpu`` and on
    ``cuda``: identical greedy streams and logits within 1e-4;
18. dense parity — a narrow model at ``mistral-large-123b``'s head ratio
    (24 query heads over 2, head dim 16, fp32, int8 cache) on ``cpu`` and
    on ``cuda``: identical greedy streams and logits within 1e-4, every
    cuda decode launch on the chunked grid;
19. attention backward — the backward kernel (``flash_attention_bwd.cu``)
    against its plain version from the same forward output and
    log-sum-exps, and against autograd of the plain attention in fp32, at
    the training path's shape (24 over 8 heads, T = S = 4,096, D = 128,
    causal, bf16), a ``gemma3-27b`` local layer (window 1,024), MHA at
    D = 256, T = 63, the MoE training shape (16 over 8 heads, T = 4,096,
    D = 64), the encoder-decoder's training microbatch (64 rows, 6 heads
    of 64, not causal: cross-attention at 448 against 1,500 positions,
    the encoder at 1,500), the dense family's training shapes (32 and 96
    over 8 heads, T = S = 4,096, in bf16 and in fp32) (bf16, all on the
    tensor-core route) and fp32 (the SIMT route), each shape's route
    printed and counted (rtol 1e-4 /
    atol 1e-5 in fp32; in bf16
    rtol 1.6e-2 / atol 1e-3 and 1e-3 in norm against the plain version,
    1e-2 in norm against autograd), with two calls bit-identical; at the
    path shape two wrong gradients (dK/dV without one query head of each
    group over the later half of the keys, and an lse one bf16 step
    high) must fail both checks; device, wrapper, plain
    and SDPA backward ms beside the bound; then the forward at the serve
    shape of the attention phase with and without the log-sum-exp output;
20. mamba backward — the scan's backward (``mamba_scan_bwd.cu``: a
    carry launch across T's segments, the gradient, the fixed-order sums)
    from the forward's train variant's edges (a state every 16 steps),
    against its plain version at the SSM training path's shape
    (``falcon-mamba-7b``: T = 4,096, D = 8,192, N = 16), at
    ``jamba-1.5-large-398b``'s width (D = 16,384), a ragged T = 63 and
    N = 8 at B = 2, each in fp32 and bf16 (``MAMBA_BWD_TOL``), with two
    calls bit-identical and the train variant's ``y`` and ``h_T`` equal to
    the serve launch's; the plain version against fp32 autograd of the
    plain scan; at every shape two wrong gradients (the carry
    ``a_{t+1} g_{t+1}`` dropped at the first chunk edge, and at the first
    segment's end) must fail the check; device ms of each launch (from a
    profiler trace), wrapper and plain ms beside the bound (FLOPs, an FMA
    as two), the floor of the exps, the plan's exps a state and step (its
    arithmetic, not a measurement), the resident warps an SM and the
    train variant's and serve launch's device ms;
21. train — the training path: ``FTTrainer`` on the full 32-layer
    ``minitron-4b`` (bf16, fp32 AdamW moments, remat) with random weights
    (seed 0), two simulated hosts of one 4,096-token sequence each, 4
    steps (the global batch cut from ``train_4k``'s 256 to 2); the flash
    counts are zeroed just before and read just after: every forward
    (twice a layer under remat) and backward launched the kernels, all on
    the tensor-core routes; step
    ms, tokens/s and ``mfu`` over the two warm unprofiled steps (2 and 3)
    with their spread, peak memory, the last step's device busy share
    from ``torch.profiler``;
22. MoE train — the same on the full ``granite-moe-1b-a400m`` (bf16, fp32
    AdamW moments, remat): ``mfu`` counts the parameters a token reaches
    (``ModelConfig.n_active_params``), checked against a count of the
    held leaves; the profiled step's device time by class (attention
    kernels, matmuls, the MoE dispatch: top-k, sort, searchsorted,
    scatters and gathers);
23. SSM train — the same on ``falcon-mamba-7b`` at full width (d_model
    4,096, d_inner 8,192, vocab 65,024, bf16, fp32 moments, remat) with its
    depth cut from 64 to ``SSM_TRAIN_LAYERS``: every scan forward (twice
    a layer under remat) and backward on the kernels, in bf16; the
    profiled step's device time by class (matmuls, scan forward, scan
    backward); then two deterministic ``grad_step``s of the model at full
    width and 2 layers, bit-equal;
24. dense train — ``FTTrainer`` on ``mistral-large-123b`` at full width
    (bf16, factored second moment, remat) with its depth cut from 88 to 4
    layers, as the train phase: every attention forward and backward on
    the kernels' tensor cores at a group of 12, the factored ``v_row`` /
    ``v_col`` updated (finite, above 0 somewhere), the state's memory
    reckoned before the first step beside the peak;
25. vlm train — ``Model.train_step`` on ``pixtral-12b`` at full width
    (bf16, fp32 moments, remat) with its depth cut from 40 to 10 layers, a
    batch of 2 rows of 4,097 tokens, each with 256 seeded patch
    embeddings, a warm-up step, two timed and one profiled: every
    attention forward and backward on the kernels; step ms, ``mfu``, peak
    memory beside the reckoned state, busy share;
26. fault tolerance — at full width and 2 layers, ``test_ft.py``'s
    crash-restore flow at 4,096 tokens: train 2 steps, checkpoint, a
    checkpoint host crashes, a restarted fleet restores from the surviving
    replicas and trains 2 more, with losses equal to an uninterrupted
    4-step run's within rtol 1e-5; save and restore seconds, the store's
    bytes, peak RSS;
27. train parity — one ``train_step`` of the smoke ``minitron-4b`` (fp32)
    from one state on ``cpu`` and on ``cuda``: loss within 1e-4,
    parameters within rtol 1e-4 / atol 1e-5;
28. MoE train parity — the same for the smoke ``granite-moe-1b-a400m``,
    then two of its ``grad_step``s on ``cuda`` under the trainer's
    enforced deterministic algorithms, whose gradients must be bit-equal;
29. hybrid parity — the smoke ``jamba-1.5-large-398b`` (fp32, int8 cache,
    one mixed group of 8 layers and one in the tail) served on ``cpu`` and
    on ``cuda``: identical greedy streams and logits within 1e-4; then
    ``train parity`` and two deterministic ``grad_step``s bit-equal, which
    run the scan's backward, attention's and the MoE dispatch's together;
30. whisper serve — the full ``whisper-tiny`` (4 encoder and 4 decoder
    layers, d_model 384, 6 heads of 64) in bf16 with random weights
    through ``Model.prefill_step`` and ``decode_step``: 32 requests of a
    4-token prompt and 1,500 seeded bf16 frames, one prefill, 444 greedy
    decode steps to position 447; the attention counts are zeroed just
    before and read just after: prefill attention by kind (encoder,
    decoder self-attention, cross-attention, the latter also in every
    decode step), all on the tensor-core route, and the decode kernel a
    decoder layer and step; prefill ms split into encoder and decoder,
    decode ms a step beside the floor of its reads, peak memory;
31. whisper train — ``Model.train_step`` on the full ``whisper-tiny``
    (bf16, fp32 moments, remat, 4 microbatches) at a global batch of 256
    rows of 449 tokens and 1,500 frames, a warm-up step, two timed and one
    profiled: every attention forward and backward on the kernels' tensor
    cores; step ms, decoder tokens/s, ``mfu`` with the encoder-decoder's
    terms, peak memory, busy share;
32. whisper parity — the smoke ``whisper-tiny`` (fp32) on ``cpu`` and on
    ``cuda``: a prefill with frames and 12 greedy decode steps give
    identical tokens and logits within 1e-4; one ``train_step`` with
    frames as ``train parity``;
33. dryrun host — the port's dry run (``repro_torch.launch.dryrun``) on
    this machine's host: ``gemma-7b`` ``train_4k`` on the 16x16 production
    mesh over a fake 256-rank group, on meta tensors (a prediction, not a
    measurement): the record's roofline terms, per-device bytes and
    collective census; FLOPs, argument bytes and collectives above zero,
    the argument bytes equal to the rules' local shard bytes;
34. dryrun card — ``gemma-7b`` at full size (28 layers, bf16, random
    weights) on ``make_host_mesh()``, a 1x1 mesh on this card:
    ``prefill_32k`` at a global batch of 1 (cut from 32) and
    ``decode_32k`` at 2 (cut from 128; 3 steps at cache length 32,767),
    each traced on meta over the same mesh and rules, then run with the
    parameters, batch and cache as DTensors under the rules; predicted
    and measured argument bytes equal, predicted peak beside
    ``max_memory_allocated``, the roofline's time beside the step's;
    logits bit-equal to the same model's without rules; every attention
    call on the kernels (prefill on the tensor-core route); then B4 and B5
    alone at head dim 256 and 32,768 keys beside their bounds and SDPA;
35. vlm model — ``pixtral-12b`` at full size (40 layers, d_model 5,120,
    32 over 8 heads of 128, 12.25 B parameters, bf16, random weights)
    served through ``Model.prefill_step`` and ``decode_step``: 4 prompts
    of 1,536 tokens, each with 256 seeded patch embeddings, and 16 greedy
    decode steps, every attention call on the kernels; then its dry-run
    cells as the dryrun card phase runs gemma-7b's: ``prefill_32k`` at a
    global batch of 1 with its 256 patch embeddings (and, once more,
    without them: other logits) and ``decode_32k`` at as many rows as fit
    beside the weights (cut from 128);
36. examples — the port's four examples (``examples_torch/``:
    ``quickstart``, ``bigset_cluster``, ``serve_batched``, ``train_ft``)
    and its query cookbook (``docs_torch/run_cookbook.py``), in this
    process on ``cuda`` through each one's ``main``, its output captured:
    every line CI greps the reference's for; the attention counts zeroed
    just before each driver and read just after, ``serve_batched``'s
    prefills and decode steps and ``train_ft``'s forwards and backwards
    all on the kernels; every bigset cluster of the demos and the
    cookbook on the card, every ``dot_seen`` dispatch (none: their
    batches are below ``MIN_BATCH``) on the kernel, 19 cookbook blocks
    (the last lints ``src/repro_torch`` with the port's linter).

Each phase prints its seconds (``[time]``); the dry-run phases and the
dense family's print their expected seconds before they run.  The line before the last is
one JSON object with every kernel's numbers (the attention kernels' and
the scan's launches summed over the serve and training paths, with each
path's count beside; the encoder-decoder's as ``whisper-tiny serve`` and
``whisper-tiny train``, the dry-run cells' as ``gemma-7b prefill_32k`` and
``gemma-7b decode_32k``, pixtral-12b's as ``pixtral-12b serve``,
``pixtral-12b prefill_32k``, ``pixtral-12b decode_32k`` and
``pixtral-12b train``, mistral-large-123b's as ``mistral-large-123b`` and
``mistral-large-123b train``, the examples' as ``serve_batched example``
and ``train_ft example``, and ``dot_seen``'s as ``main``, ``cluster`` and
``examples``); the last line is
``{"ok": true, "device": {...}}``.  The script imports
neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, as tabulated in the repo's measurement
# notes): HBM bandwidth, the non-tensor 32-bit rate, and the dense bf16
# tensor-core rate.  The int32 compares of dot_seen issue on no more lanes
# than float32 does, so a bound taken against this rate is a lower bound on
# the card's time; fp32 attention has no tensor-core path at fp32 precision.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
# The special-function units that evaluate ex2: 16 a clock on each of the
# 132 SMs at the SXM part's 1,980 MHz boost clock (NVIDIA's CUDA
# programming guide, arithmetic throughput for compute capability 9.0).
SFU_EX2_PER_S = 132 * 16 * 1.98e9

SET = b"smoke"
PATH_SHAPE = dict(n_actors=1, n_runs=2000, n_dots=1024)
STRESS_SHAPE = dict(n_actors=64, n_runs=4096, n_dots=1 << 20)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phases
def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    card = proc.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return card


# The kernels of the serve paths (the attention kernels' routes, the scan,
# dot_seen), of the clock lattice and of the backwards of attention (both
# routes) and of the scan whose registers, shared memory and spills the
# build phase reports.
PTXAS_KERNELS = ("flash_attention_kernel_tc", "decode_attention_kernel_split",
                 "decode_attention_kernel_combine", "mamba_scan_kernel",
                 "dot_seen_kernel", "clock_merge_kernel",
                 "clock_popcount_kernel", "attn_bwd_dkdv", "attn_bwd_dq",
                 "attn_bwd_dkdv_tc", "attn_bwd_dq_tc",
                 "mamba_scan_bwd_kernel", "mamba_scan_bwd_carry_kernel",
                 "mamba_scan_bwd_reduce_kernel")
_PTXAS_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32"}


def _kernel_of(mangled: str):
    """``name<args>`` of a mangled entry of PTXAS_KERNELS, else None."""
    for name in sorted(PTXAS_KERNELS, key=len, reverse=True):
        at = mangled.find(name)
        if at >= 0:
            rest = mangled[at + len(name):]
            m = re.match(r"I((?:Li\d+E|Lb[01]E|13__nv_bfloat16|f)+)E", rest)
            args = re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|f)",
                              m.group(1)) if m else []
            return name + ("<" + ",".join(
                n or {"0": "false", "1": "true"}.get(b) or _PTXAS_TYPES[t]
                for n, b, t in args) + ">" if args else "")
    return None


def ptxas_report(source):
    """``nvcc -Xptxas -v`` on ``source`` (a cubin into the build directory):
    registers, static shared memory, stack and spills of each entry of
    PTXAS_KERNELS."""
    from repro_torch.kernels import build

    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = build.build_dir() / f"{Path(source).stem}.ptxas.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build.find_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(out),
         str(source)], capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc -Xptxas -v {Path(source).name} "
          f"failed:\n{proc.stdout}{proc.stderr}")
    reports, cur = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_of(m.group(1))
            cur = dict(kernel=name) if name else None
            if cur:
                reports.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       smem_bytes=int(smem.group(1)) if smem else 0)
    return reports


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.clock_ops import kernel as clock_kernel
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.dot_seen import kernel as dot_seen_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as mamba_kernel

    modules = [dot_seen_kernel, flash_kernel, decode_kernel, mamba_kernel,
               clock_kernel]
    sources = [m.SOURCE for m in modules] + [flash_kernel.BWD_SOURCE,
                                             mamba_kernel.BWD_SOURCE]
    reported = [flash_kernel.SOURCE, flash_kernel.BWD_SOURCE,
                decode_kernel.SOURCE, mamba_kernel.SOURCE,
                mamba_kernel.BWD_SOURCE, dot_seen_kernel.SOURCE,
                clock_kernel.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + len(reported)) as pool:
        reports = pool.map(ptxas_report, reported)
        list(pool.map(build.load, sources))
        reports = [r for rep in reports for r in rep]
    for m in modules:
        m.library()
    flash_kernel.bwd_library()
    mamba_kernel.bwd_library()
    dt = time.perf_counter() - t0
    say(f"[build] {len(sources)} CUDA source(s) built for sm_90a in "
        f"{dt:.2f}s -> {build.build_dir()}")
    check({r["kernel"].split("<")[0] for r in reports} == set(PTXAS_KERNELS),
          f"ptxas reported {[r['kernel'] for r in reports]}")
    say(f"[build] ptxas -v (static shared memory only): {json.dumps(reports)}")


def _canonical_runs(rng, n_actors, n_runs, hi, fill, np):
    """Disjoint sorted runs per row inside [1, hi], ``fill`` of the slots
    used, the rest the empty sentinel (1, 0)."""
    starts = np.ones((n_actors, n_runs), np.int64)
    ends = np.zeros((n_actors, n_runs), np.int64)
    used = max(1, int(n_runs * fill))
    for a in range(n_actors):
        edges = np.unique(rng.integers(1, hi + 1, 2 * used + 256,
                                       dtype=np.int64))
        edges = np.sort(rng.choice(edges, 2 * used, replace=False))
        starts[a, :used] = edges[0::2]
        ends[a, :used] = edges[1::2]
    return starts.astype(np.int32), ends.astype(np.int32)


def kernel_inputs(torch, np, shape: str, device: str = "cuda"):
    """Seeded inputs at one of the two shapes, on ``device``."""
    if shape == "path":
        # the serve path: one actor's tombstone of 2,000 single-dot runs
        # (every 50th of 100,000 elements removed), scanned 1,024 dots at a
        # time; padding dots carry the sentinel counter 0
        a, r, n = (PATH_SHAPE[k] for k in ("n_actors", "n_runs", "n_dots"))
        starts = np.arange(r, dtype=np.int32)[None, :] * 50 + 1
        ends = starts.copy()
        counters = np.arange(1, n + 1, dtype=np.int32) + 40_000
        counters[-24:] = 0
        actors = np.zeros(n, np.int32)
    else:
        # the stress shape: unsorted rows, counters up to 2^31 - 1, and
        # actors outside [0, A)
        rng = np.random.default_rng(11)
        a, r, n = (STRESS_SHAPE[k] for k in ("n_actors", "n_runs", "n_dots"))
        starts, ends = _canonical_runs(rng, a, r, 2**31 - 1, 0.9, np)
        perm = np.argsort(rng.random((a, r)), axis=1)
        starts = np.take_along_axis(starts, perm, axis=1)
        ends = np.take_along_axis(ends, perm, axis=1)
        actors = rng.integers(-3, a + 3, n).astype(np.int32)
        pick = rng.integers(0, r, n)
        row = np.clip(actors, 0, a - 1)
        edge = rng.integers(0, 5, n)
        base = np.where(edge < 2, starts[row, pick], ends[row, pick]).astype(np.int64)
        base += np.choose(edge, [-1, 0, 0, 1, 0])
        uniform = rng.integers(0, 2**31 - 1, n, dtype=np.int64)
        counters = np.where(rng.random(n) < 0.5, base, uniform)
        counters = np.clip(counters, 0, 2**31 - 1).astype(np.int32)
        counters[:4] = [2**31 - 1, 0, 1, 2**31 - 2]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (starts, ends, actors, counters)]


CHUNK = 1 << 16


def plain_chunked(torch, ref, starts, ends, actors, counters):
    """The plain version over N in chunks: its [N, R] gather would not fit
    the card at the stress shape in one piece."""
    return torch.cat([
        ref(starts, ends, actors[lo:lo + CHUNK], counters[lo:lo + CHUNK])
        for lo in range(0, actors.shape[0], CHUNK)])


def runs_scanned(torch, starts, ends, actors, counters) -> int:
    """Runs the kernel walks for these inputs: up to each dot's first hit,
    all R on a miss, none for an actor outside [0, A)."""
    total = 0
    n_actors, r = starts.shape
    for lo in range(0, actors.shape[0], CHUNK):
        a = actors[lo:lo + CHUNK]
        c = counters[lo:lo + CHUNK]
        known = (a >= 0) & (a < n_actors)
        rows = torch.where(known, a, torch.zeros_like(a)).long()
        hit = (starts[rows] <= c[:, None]) & (c[:, None] <= ends[rows])
        first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                            torch.full_like(a, r))
        total += int(torch.where(known, first, torch.zeros_like(first)).sum())
    return total


def time_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of ``fn``'s launches alone: ``iters`` calls captured in
    one CUDA graph and replayed, so host launch cost is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return time_ms(torch, g.replay, 5, warmup=1) / iters


def phase_kernels(torch, np):
    from repro_torch.core.vclock import DenseClock
    from repro_torch.kernels.dot_seen import dot_seen, dot_seen_ref
    from repro_torch.kernels.dot_seen.kernel import dot_seen_cuda

    # the floor a launch can reach: an empty kernel, timed as dot_seen's
    # device time is (launches in one CUDA graph)
    empty_ms = graph_ms(torch, lambda: torch.cuda._sleep(0), 200)
    results = {}
    for shape in ("path", "stress"):
        starts, ends, actors, counters = kernel_inputs(torch, np, shape)
        clock = DenseClock(starts, ends)
        got = dot_seen(clock, actors, counters)
        torch.cuda.synchronize()
        want = plain_chunked(torch, dot_seen_ref,
                             starts, ends, actors, counters)
        mismatches = int((got != want).sum())
        max_abs_err = int((got.int() - want.int()).abs().max())
        check(mismatches == 0,
              f"dot_seen at the {shape} shape: {mismatches} mismatches")
        a, r = starts.shape
        n = actors.shape[0]
        nbytes = 2 * a * r * 4 + n * 4 * 2 + n * 1
        # two compares per run walked, up to the first hit
        ops = 2 * runs_scanned(torch, starts, ends, actors, counters)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        iters = 200 if shape == "path" else 5
        ms = time_ms(torch, lambda: dot_seen(clock, actors, counters), iters)
        device_ms = graph_ms(
            torch, lambda: dot_seen_cuda(starts, ends, actors, counters),
            iters)
        if shape == "path":
            plain_ms = time_ms(
                torch, lambda: dot_seen_ref(starts, ends, actors, counters),
                iters)
        else:
            plain_ms = time_ms(
                torch, lambda: plain_chunked(torch, dot_seen_ref, starts, ends,
                                             actors, counters), 1, warmup=1)
        res = dict(shape=f"A={a},R={r},N={n}", mismatches=mismatches,
                   max_abs_err=max_abs_err, ms=ms, device_ms=device_ms,
                   plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   empty_launch_ms=empty_ms, bytes=nbytes, ops=ops,
                   seen=int(got.sum()))
        results[shape] = res
        say(f"[kernel] dot_seen {shape}: {json.dumps(res)}")
    return results


# ------------------------------------------------------- attention kernels
# The model serve path's shapes (gemma3-27b: 32 query heads over 16 KV
# heads, head dim 128): a prefill of 1,536 tokens in a global layer and in
# a local one (window 1,024), and a decode step of 4 rows of a 2,048-slot
# cache with ragged lengths and of a local layer's 1,024-slot ring.  The
# MoE serve paths' shapes: granite-moe-1b-a400m's 16 over 8 heads of 64 and
# grok-1-314b's 48 over 8 heads of 128; the hybrid's, jamba-1.5-large-398b's
# 64 over 8 heads of 128.  The stress shapes take head dim 256, MHA and
# ragged lengths.  The encoder-decoder's (whisper-tiny: 6 heads of 64, 1,500
# encoder positions, not causal): a decode step's cross-attention (32 rows,
# one query each), a training microbatch's cross-attention (64 rows of 448
# decoder positions) and its encoder self-attention, and a decode step of
# its 448-slot self-attention cache.  The dense family's last two:
# pixtral-12b's 32 over 8 heads of 128 (a group of 4) and
# mistral-large-123b's 96 over 8 (a group of 12, which the decode kernel
# cuts into two chunks of 6 heads a block).
FLASH_SHAPES = {
    "path": dict(B=1, Hq=32, Hkv=16, T=1536, S=1536, D=128, window=None,
                 causal=True),
    "path-local": dict(B=1, Hq=32, Hkv=16, T=1536, S=1536, D=128,
                       window=1024, causal=True),
    "path-moe": dict(B=1, Hq=16, Hkv=8, T=1536, S=1536, D=64, window=None,
                     causal=True),
    "path-grok": dict(B=1, Hq=48, Hkv=8, T=1536, S=1536, D=128, window=None,
                      causal=True),
    "path-jamba": dict(B=1, Hq=64, Hkv=8, T=1536, S=1536, D=128,
                       window=None, causal=True),
    "path-pixtral": dict(B=1, Hq=32, Hkv=8, T=1536, S=1536, D=128,
                         window=None, causal=True),
    "path-mistral": dict(B=1, Hq=96, Hkv=8, T=1536, S=1536, D=128,
                         window=None, causal=True),
    "stress": dict(B=2, Hq=8, Hkv=8, T=777, S=1000, D=256, window=None,
                   causal=True),
    "cross-1": dict(B=32, Hq=6, Hkv=6, T=1, S=1500, D=64, window=None,
                    causal=False),
    "cross": dict(B=64, Hq=6, Hkv=6, T=448, S=1500, D=64, window=None,
                  causal=False),
    "encoder": dict(B=64, Hq=6, Hkv=6, T=1500, S=1500, D=64, window=None,
                    causal=False),
}
DECODE_SHAPES = {
    "path": dict(B=4, Hq=32, Hkv=16, S=2048, D=128, window=None,
                 lens=[1537, 1281, 9, 700]),
    # a local layer's ring of 1,024 slots, the same rows' lengths clamped
    "path-local": dict(B=4, Hq=32, Hkv=16, S=1024, D=128, window=None,
                       lens=[1024, 1024, 9, 700]),
    "path-moe": dict(B=4, Hq=16, Hkv=8, S=2048, D=64, window=None,
                     lens=[1537, 1281, 9, 700]),
    "path-grok": dict(B=4, Hq=48, Hkv=8, S=2048, D=128, window=None,
                      lens=[1537, 1281, 9, 700]),
    "path-jamba": dict(B=4, Hq=64, Hkv=8, S=2048, D=128, window=None,
                       lens=[1537, 1281, 9, 700]),
    "path-pixtral": dict(B=4, Hq=32, Hkv=8, S=2048, D=128, window=None,
                         lens=[1537, 1281, 9, 700]),
    "path-mistral": dict(B=4, Hq=96, Hkv=8, S=2048, D=128, window=None,
                         lens=[1537, 1281, 9, 700]),
    "stress": dict(B=3, Hq=8, Hkv=8, S=4096, D=256, window=1000,
                   lens=[1, 2500, 4096]),
    # whisper-tiny's decoder: 32 rows of 448 slots, lengths 5..439
    "whisper": dict(B=32, Hq=6, Hkv=6, S=448, D=64, window=None,
                    lens=list(range(5, 449, 14))),
}
ATTN_TOL = {"flash_attention": {"bfloat16": 2e-2, "float32": 2e-5},
            "decode_attention": {"bfloat16": 3e-2, "float32": 2e-5}}


def _allclose(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol * |want| everywhere (atol = rtol = tol)."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


def _bound(nbytes: int, ops: int, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    peak = PEAK_BF16_OPS_PER_S if dtype_name == "bfloat16" else PEAK_OPS_PER_S
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_ms(torch, q, k, v, mask, iters):
    """PyTorch's fused attention on the same inputs: the library yardstick
    (never called by the port).  Returns (ms, its output)."""
    import torch.nn.functional as F

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return time_ms(torch, call, iters), call()


def phase_attention_kernels(torch):
    """Both attention kernels against their plain versions, in bf16 and
    fp32, at the path's and the stress shapes; timings of the bf16 runs."""
    from repro_torch.kernels.decode_attention import (LAUNCHES,
                                                      decode_attention,
                                                      decode_attention_cuda,
                                                      decode_attention_ref,
                                                      decode_work)
    from repro_torch.kernels.flash_attention import (ROUTE_LAUNCHES,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_work,
                                                     flash_route)

    results = {}
    gen = torch.Generator(device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for shape, s in FLASH_SHAPES.items():
            gen.manual_seed(7)
            q = torch.randn((s["B"], s["Hq"], s["T"], s["D"]), generator=gen,
                            device="cuda", dtype=dtype)
            k = torch.randn((s["B"], s["Hkv"], s["S"], s["D"]), generator=gen,
                            device="cuda", dtype=dtype)
            v = torch.randn(k.shape, generator=gen, device="cuda", dtype=dtype)
            w, c = s["window"], s["causal"]
            scale = s["D"] ** -0.5
            route = flash_route(dtype, s["D"])
            before = ROUTE_LAUNCHES[route]
            got = flash_attention(q, k, v, causal=c, window=w)
            torch.cuda.synchronize()
            check(ROUTE_LAUNCHES[route] == before + 1,
                  f"flash_attention {shape} {dname}: not on the {route} route")
            want = attention_ref(q, k, v, causal=c, window=w)
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL["flash_attention"][dname]
            check(_allclose(got, want, tol),
                  f"flash_attention {shape} {dname}: max abs err {err}")
            ops, nbytes = flash_work(q, k, c, w)
            bound_ms, bound_by = _bound(nbytes, ops, dname)
            res = dict(shape=f"B={s['B']},Hq={s['Hq']},Hkv={s['Hkv']},"
                       f"T={s['T']},S={s['S']},D={s['D']},window={w},"
                       f"causal={c}",
                       dtype=dname, route=route, max_abs_err=err,
                       bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                       bytes=nbytes)
            if dtype == torch.bfloat16:
                iters = 10
                res["ms"] = time_ms(torch, lambda: flash_attention(
                    q, k, v, causal=c, window=w), iters)
                res["device_ms"] = graph_ms(torch, lambda: flash_attention_cuda(
                    q, k, v, causal=c, window=w, scale=scale), iters)
                res["plain_ms"] = time_ms(torch, lambda: attention_ref(
                    q, k, v, causal=c, window=w), iters)
                qpos = torch.arange(s["T"], device="cuda")[:, None] + s["S"] - s["T"]
                kpos = torch.arange(s["S"], device="cuda")[None, :]
                mask = kpos <= qpos if c else None
                if w is not None:
                    mask &= kpos > qpos - w
                res["library_ms"], lib = _sdpa_ms(torch, q, k, v, mask, iters)
                res["library_err"] = float((lib.float() - want.float()).abs().max())
            results[("flash_attention", shape, dname)] = res
            say(f"[kernel] flash_attention {shape} {dname}: {json.dumps(res)}")

        for shape, s in DECODE_SHAPES.items():
            gen.manual_seed(8)
            q = torch.randn((s["B"], s["Hq"], s["D"]), generator=gen,
                            device="cuda", dtype=dtype)
            k = torch.randn((s["B"], s["Hkv"], s["S"], s["D"]), generator=gen,
                            device="cuda", dtype=dtype)
            v = torch.randn(k.shape, generator=gen, device="cuda", dtype=dtype)
            lens = torch.tensor(s["lens"], dtype=torch.int32, device="cuda")
            w = s["window"]
            scale = s["D"] ** -0.5
            G = s["Hq"] // s["Hkv"]
            n_chunks = -(-G // 8)
            before = collections.Counter(LAUNCHES)
            got = decode_attention(q, k, v, lens, window=w)
            torch.cuda.synchronize()
            # the grid the launcher reports: a group above 8 query heads
            # (mistral-large-123b's 12) cut into ceil(G / 8) chunks
            grid = LAUNCHES - before
            check(len(grid) == 1 and sum(grid.values()) == 1
                  and [(g.grid[1], g.chunk_heads, g.n_chunks) for g in grid]
                  == [(s["Hkv"] * n_chunks, -(-G // n_chunks), n_chunks)],
                  f"decode_attention {shape} {dname}: G = {G} launched "
                  f"{dict(grid)}, not {n_chunks} chunk(s) a kv head")
            grid = next(iter(grid))._asdict()
            want = decode_attention_ref(q, k, v, lens, window=w)
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL["decode_attention"][dname]
            check(_allclose(got, want, tol),
                  f"decode_attention {shape} {dname}: max abs err {err}")
            valid = [min(n, s["S"]) - (max(0, n - w) if w else 0)
                     for n in s["lens"]]
            ops, nbytes = decode_work(q, k, sum(valid))
            bound_ms, bound_by = _bound(nbytes, ops, dname)
            res = dict(shape=f"B={s['B']},Hq={s['Hq']},Hkv={s['Hkv']},"
                       f"S={s['S']},D={s['D']},window={w},lens={s['lens']}",
                       dtype=dname, max_abs_err=err, bound_ms=bound_ms,
                       bound_by=bound_by, ops=ops, bytes=nbytes,
                       launched=dict(grid, route="chunked" if n_chunks > 1
                                     else "whole"))
            if dtype == torch.bfloat16:
                iters = 50
                res["ms"] = time_ms(torch, lambda: decode_attention(
                    q, k, v, lens, window=w), iters)
                res["device_ms"] = graph_ms(torch, lambda: decode_attention_cuda(
                    q, k, v, lens, window=w, scale=scale), iters)
                res["plain_ms"] = time_ms(torch, lambda: decode_attention_ref(
                    q, k, v, lens, window=w), iters)
                pos = torch.arange(s["S"], device="cuda")[None, :]
                mask = pos < lens[:, None]
                if w is not None:
                    mask &= pos >= lens[:, None] - w
                res["library_ms"], lib = _sdpa_ms(
                    torch, q[:, :, None, :], k, v, mask[:, None, None, :], iters)
                res["library_err"] = float(
                    (lib[:, :, 0].float() - want.float()).abs().max())
            results[("decode_attention", shape, dname)] = res
            say(f"[kernel] decode_attention {shape} {dname}: {json.dumps(res)}")
    return results


# ------------------------------------------------------------ mamba scan
# The SSM serve path's prefill scan (falcon-mamba-7b: d_inner 8,192, state
# 16) over the 1,536-token prompt, in fp32 and in bf16 (the model's type,
# which the path runs), and the hybrid's (jamba-1.5-large-398b: d_inner
# 16,384) in bf16; a stress shape with B > 1 and ragged T; the smoke
# model's state of 8 at a narrow width; and a long prompt of 8,192 tokens.
MAMBA_SHAPES = {
    "path": dict(B=1, T=1536, D=8192, N=16),
    "path-bf16": dict(B=1, T=1536, D=8192, N=16, dtype="bfloat16"),
    # the hybrid serve path's: jamba-1.5-large-398b's d_inner
    "path-jamba": dict(B=1, T=1536, D=16384, N=16, dtype="bfloat16"),
    "stress": dict(B=4, T=777, D=8192, N=16),
    "n8": dict(B=2, T=333, D=64, N=8),
    "long": dict(B=1, T=8192, D=8192, N=16),
}
# the scan's tolerances in the CPU tests: 2e-4 in fp32 (y and h_T) and for
# h_T from bf16 inputs (both versions widen them and run in fp32); 2e-2 on
# a bf16 y, which both round once from fp32 sums taken in another order
MAMBA_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def mamba_inputs(torch, s, seed: int):
    """Seeded inputs on the card: step sizes and decays as the model draws
    them (softplus of ~-4.6, A = -(1..N)), normal x, B, C and D; x, delta,
    B and C in the shape's type, A and D in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, s.get("dtype", "float32"))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    B, T, D, N = s["B"], s["T"], s["D"], s["N"]
    x = normal(B, T, D)
    delta = torch.nn.functional.softplus(normal(B, T, D) - 4.6)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").repeat(D, 1)
    A = A * torch.exp(0.1 * normal(D, N))
    Bm, Cm = normal(B, T, N), normal(B, T, N)
    return (x.to(dtype), delta.to(dtype), A, Bm.to(dtype), Cm.to(dtype),
            normal(D))


def phase_mamba_kernel(torch):
    """The selective-scan kernel against its plain version, ``y`` and the
    final state, at every shape of MAMBA_SHAPES; timings at each."""
    from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_cuda,
                                                mamba_scan_ref, scan_work)

    results = {}
    for shape, s in MAMBA_SHAPES.items():
        dname = s.get("dtype", "float32")
        args = mamba_inputs(torch, s, seed=9)
        y, hT = mamba_scan(*args)
        torch.cuda.synchronize()
        y_want, h_want = mamba_scan_ref(*args)
        check(y.dtype == args[0].dtype and hT.dtype == torch.float32,
              f"mamba_scan {shape}: y {y.dtype}, h_T {hT.dtype}")
        err_y = float((y.float() - y_want.float()).abs().max())
        err_h = float((hT - h_want).abs().max())
        check(_allclose(y, y_want, MAMBA_TOL[dname]) and
              _allclose(hT, h_want, MAMBA_TOL["float32"]),
              f"mamba_scan {shape}: max abs err y {err_y}, h_T {err_h}")
        B, T, D, N = s["B"], s["T"], s["D"], s["N"]
        ops, nbytes = scan_work(args[0], N)
        bound_ms, bound_by = _bound(nbytes, ops, "float32")
        # one ex2 per state element and step on the special-function units
        sfu_ms = B * T * D * N / SFU_EX2_PER_S * 1e3
        iters = 20 if shape.startswith("path") else 10
        res = dict(shape=f"B={B},T={T},D={D},N={N}", dtype=dname,
                   max_abs_err=max(err_y, err_h), max_abs_err_y=err_y,
                   max_abs_err_h=err_h, max_abs_y=float(y_want.abs().max()),
                   max_abs_h=float(h_want.abs().max()), bound_ms=bound_ms,
                   bound_by=bound_by, sfu_ms=sfu_ms, ops=ops, bytes=nbytes)
        res["ms"] = time_ms(torch, lambda: mamba_scan(*args), iters)
        res["device_ms"] = graph_ms(torch, lambda: mamba_scan_cuda(*args),
                                    iters)
        # the plain version loops over T on the host: few iterations
        res["plain_ms"] = time_ms(torch, lambda: mamba_scan_ref(*args), 2,
                                  warmup=1)
        results[shape] = res
        say(f"[kernel] mamba_scan {shape}: {json.dumps(res)}")
    return results


# ------------------------------------------------------------- clock ops
# The interval clock lattice (join, subtract, intersect: the boundary-sweep
# merge; popcount) at the bigset path's tombstone shape (one actor of 2,000
# single-dot runs, every 50th of 100,000 counters, as the main path leaves
# it), at 512 actors of 128 runs ("a heavily churned clock",
# benchmarks/bench_kernels.py) and of 1,024 runs (the Pallas kernel's stated
# limit, "A <= 512 hosts, R <= 1024 runs"), at rows too wide for a block's
# shared memory (the merge's global-memory route) and at an edge case.
CLOCK_SHAPES = {"tomb": dict(A=1, R=2000), "churn": dict(A=512, R=128),
                "stress": dict(A=512, R=1024), "wide": dict(A=4, R=8192)}
CLOCK_ITERS = {"tomb": 20, "churn": 20, "stress": 3, "wide": 2, "edge": 50}
CLOCK_OPS = {"join": "or", "subtract": "andnot", "intersect": "and"}
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def clock_edge_inputs(np):
    """Rows at 2^31 - 1 and at -2^31, unsorted, overlapping and duplicated
    runs, empty slots mid-row, and popcounts that wrap (A = 6, Ra = 6,
    Rb = 5)."""
    E = (1, 0)
    top, low = INT32_MAX, INT32_MIN
    a = [[(top - 10, top), (5, 9), E, (top - 30, top - 25), E, E],
         [(low, top - 3), E, E, E, E, E],
         [(50, 80), (10, 20), E, (15, 60), (10, 20), (200, 200)],
         [(1, 7), (9, 12), (9, 12), E, E, E],
         [E, E, E, E, E, E],
         [(0, top - 5), (10, top), (0, top), E, E, E]]
    b = [[(top - 3, top), (top - 20, top - 12), E, (6, 6), E],
         [(low, -5), (0, 2), (top - 1, top), E, (low, low)],
         [(70, 90), E, (1, 5), (19, 19), (81, 199)],
         [(1, 7), (9, 12), E, (8, 8), E],
         [(3, 4), E, E, E, (top, top)],
         [(0, 0), (top, top), E, E, E]]

    def arrays(rows):
        s = np.array([[r[0] for r in row] for row in rows], np.int64)
        e = np.array([[r[1] for r in row] for row in rows], np.int64)
        return s.astype(np.int32), e.astype(np.int32)
    return arrays(a), arrays(b)


def clock_inputs(torch, np, shape: str):
    """Two clocks (A's and B's run pairs) on the card, and the events each
    holds per row (int64, from the drawn runs)."""
    rng = np.random.default_rng(13)
    if shape == "edge":
        a, b = clock_edge_inputs(np)
    elif shape == "tomb":
        # the tombstone the main path leaves, against 2,000 drawn runs
        starts = (np.arange(2000, dtype=np.int32) * 50 + 1)[None, :]
        a = (starts, starts.copy())
        b = _canonical_runs(rng, 1, 2000, 100_000, 1.0, np)
    else:
        size = CLOCK_SHAPES[shape]
        a = _canonical_runs(rng, size["A"], size["R"], INT32_MAX, 0.9, np)
        b = _canonical_runs(rng, size["A"], size["R"], INT32_MAX, 0.9, np)
    events = [np.maximum(hi.astype(np.int64) - lo.astype(np.int64) + 1, 0)
              .sum(axis=1) for lo, hi in (a, b)]
    return [torch.from_numpy(x).to("cuda") for x in (*a, *b)], events


def plain_merge(torch, ref, sort_runs, a_s, a_e, b_s, b_e):
    """The plain version of a merge op (merge, then sort) on the card, over
    the rows in chunks: its [A, P, P] masks would not fit in one piece."""
    p = a_s.shape[1] + b_s.shape[1]
    rows = max(1, (1 << 27) // (p * p))  # about 1 GiB of int64 masks
    outs = [sort_runs(*ref(a_s[lo:lo + rows], a_e[lo:lo + rows],
                           b_s[lo:lo + rows], b_e[lo:lo + rows]))
            for lo in range(0, a_s.shape[0], rows)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def phase_clock_kernels(torch, np):
    """Both clock-lattice kernels, through the entry points, against their
    plain versions on the card at every shape, bit for bit (the merge's
    canonical rows against the plain version's, sorted); lattice identities
    and the drawn event counts check the answers.  Then each shape's
    timings: the wrapper, the device (a CUDA graph of bare launches), the
    plain version and the bound."""
    from repro_torch.core.vclock import DenseClock, sort_runs
    from repro_torch.kernels import clock_ops as co
    from repro_torch.kernels.clock_ops.kernel import staged

    refs = {"join": co.join_ref, "subtract": co.subtract_ref,
            "intersect": co.intersect_ref}
    card = torch.device("cuda", torch.cuda.current_device())
    results = {}
    for shape in (*CLOCK_SHAPES, "edge"):
        (a_s, a_e, b_s, b_e), events = clock_inputs(torch, np, shape)
        A, ra, rb = a_s.shape[0], a_s.shape[1], b_s.shape[1]
        route = "shared" if staged(ra, rb, card) else "global"
        check(route == ("global" if shape == "wide" else "shared"),
              f"clock_ops {shape}: the merge took the {route} route")
        a, b = DenseClock(a_s, a_e), DenseClock(b_s, b_e)
        merged = {op: getattr(co, op)(a, b) for op in CLOCK_OPS}
        counts = {"a": co.popcount(a), "b": co.popcount(b)}
        counts.update({op: co.popcount(c) for op, c in merged.items()})
        torch.cuda.synchronize()
        err = 0
        for op in CLOCK_OPS:
            want = plain_merge(torch, refs[op], sort_runs, a_s, a_e, b_s, b_e)
            for g, w in zip(merged[op], want):
                err = max(err, int((g.long() - w.long()).abs().max()))
            check(all(torch.equal(g, w) for g, w in zip(merged[op], want)),
                  f"clock_ops {op} {shape}: the kernel and the plain version "
                  f"differ (max abs err {err})")
        for name, (s, e) in (("a", (a_s, a_e)), ("b", (b_s, b_e)),
                             *((op, merged[op]) for op in CLOCK_OPS)):
            want = co.popcount_ref(s, e)
            err = max(err, int((counts[name].long() - want.long()).abs().max()))
            check(torch.equal(counts[name], want),
                  f"clock_ops popcount {shape} ({name}): kernel != plain")
        if shape != "edge":
            # no row reaches 2^31 events here, so the int32 counts are exact
            pc = {k: v.long() for k, v in counts.items()}
            check(int(pc["a"].sum()) == int(events[0].sum())
                  and int(pc["b"].sum()) == int(events[1].sum()),
                  f"clock_ops popcount {shape}: the counts miss drawn events")
            check(torch.equal(pc["join"], pc["a"] + pc["b"] - pc["intersect"])
                  and torch.equal(pc["subtract"], pc["a"] - pc["intersect"]),
                  f"clock_ops {shape}: a lattice identity fails")

        P = ra + rb
        # each of the four inputs read once and both outputs written once;
        # sorted rows (every shape but edge) need a linear merge, one
        # compare an edge, and the edge shape's a sort, P log2 P compares
        merge_bytes = 8 * A * (ra + rb) + 2 * A * P * 4
        merge_ops = A * P * (int(np.ceil(np.log2(P))) if shape == "edge"
                             else 1)
        bound_ms, bound_by = _bound(merge_bytes, merge_ops, "int32")
        iters = CLOCK_ITERS[shape]
        plain_iters = 1 if shape in ("stress", "wide") else iters
        res = dict(shape=f"A={A},Ra={ra},Rb={rb}", route=route,
                   max_abs_err=err, bytes=merge_bytes, ops=merge_ops,
                   bound_ms=bound_ms, bound_by=bound_by)
        for op, mode in CLOCK_OPS.items():
            fn = getattr(co, op)
            res[op] = dict(
                ms=time_ms(torch, lambda: fn(a, b), iters),
                device_ms=graph_ms(torch, lambda: co.clock_merge_cuda(
                    mode, a_s, a_e, b_s, b_e), iters),
                plain_ms=time_ms(torch, lambda: plain_merge(
                    torch, refs[op], sort_runs, a_s, a_e, b_s, b_e),
                    plain_iters, warmup=1))
        pop_bytes = 2 * A * ra * 4 + A * 4
        pop_bound, pop_by = _bound(pop_bytes, 4 * A * ra, "int32")
        res["popcount"] = dict(
            ms=time_ms(torch, lambda: co.popcount(a), 200),
            device_ms=graph_ms(torch, lambda: co.clock_popcount_cuda(a_s, a_e),
                               200),
            plain_ms=time_ms(torch, lambda: co.popcount_ref(a_s, a_e), 200),
            bound_ms=pop_bound, bound_by=pop_by, bytes=pop_bytes)
        results[shape] = res
        say(f"[kernel] clock_ops {shape}: {json.dumps(res)}")
    return results


def _events_by_actor(clock, actors):
    """Events per actor of a sparse clock, in the order of ``actors``."""
    n = dict.fromkeys(actors, 0)
    for actor, lo, hi in clock.iter_runs():
        n[actor] += hi - lo + 1
    return [n[a] for a in actors]


def phase_clock_entry(torch, cluster, groups=None):
    """The clock lattice's entry point on the clocks a bigset path left.

    ``groups`` lists replica groups, each a list of ``(vnode, storage
    set)``; by default one group, every replica's ``SET``.  Within a group
    each replica's set clock and tombstone, dense on the card, is merged
    with every replica's and counted; the ``clock_ops`` counts are zeroed
    just before and read just after.  Every answer is held against the
    sparse ``Clock``'s own join, subtract_clock, intersect and events."""
    from repro_torch.core.vclock import from_clock, to_clock
    from repro_torch.kernels import clock_ops as co

    actors = list(cluster.actors)
    index = {a: i for i, a in enumerate(actors)}
    if groups is None:
        groups = [[(cluster.vnodes[a], SET) for a in actors]]
    sparse, pairs = {}, []
    for g, members in enumerate(groups):
        for r, (vnode, set_name) in enumerate(members):
            sparse[f"set{g}.{r}"] = vnode.read_clock(set_name)
            sparse[f"tomb{g}.{r}"] = vnode.read_tombstone(set_name)
        # every replica's set clock with every replica's tombstone and set
        # clock, and every tombstone with every tombstone
        n = len(members)
        pairs += [(f"{x}{g}.{i}", f"{y}{g}.{j}")
                  for i in range(n) for j in range(n)
                  for x, y in (("set", "tomb"), ("set", "set"),
                               ("tomb", "tomb"))]
    dense = {name: from_clock(c, index, len(actors), device="cuda")
             for name, c in sparse.items()}
    sparse_ops = {"join": "join", "subtract": "subtract_clock",
                  "intersect": "intersect"}

    for ledger in co.DISPATCHES:
        ledger.reset()
    t0 = time.perf_counter()
    merged = {(op, x, y): getattr(co, op)(dense[x], dense[y])
              for x, y in pairs for op in CLOCK_OPS}
    counts = {name: co.popcount(c) for name, c in dense.items()}
    counts.update({key: co.popcount(c) for key, c in merged.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {name: ledger.snapshot()
                for name, ledger in zip(co.DISPATCHES._fields, co.DISPATCHES)}

    for (op, x, y), got in merged.items():
        want = getattr(sparse[x], sparse_ops[op])(sparse[y])
        check(to_clock(got, actors) == want,
              f"clock_ops {op}({x}, {y}) on the path's clocks differs from "
              f"the sparse Clock")
        check(counts[(op, x, y)].tolist() == _events_by_actor(want, actors),
              f"clock_ops popcount of {op}({x}, {y}) differs from the sparse "
              f"Clock's events")
    for name, c in sparse.items():
        check(counts[name].tolist() == _events_by_actor(c, actors),
              f"clock_ops popcount of {name} differs from the sparse Clock")
    check(all(c.kernel_launches == c.launches > 0 for c in launched.values()),
          "a clock_ops dispatch on the path's clocks missed the CUDA kernel")
    widest = max(c.n_runs for c in dense.values())
    say(f"[clock_ops] entry point on the path's clocks ({len(groups)} "
        f"group(s) of {len(groups[0])} replicas, {len(actors)} actors; "
        f"widest row {widest} runs; events of the first set clock "
        f"{sparse['set0.0'].n_events()}, tombstone "
        f"{sparse['tomb0.0'].n_events()}): {len(merged)} merges and "
        f"{len(counts)} popcounts in {wall:.3f}s, all equal to the sparse "
        f"Clock; dispatches "
        f"{json.dumps({k: vars(v) for k, v in launched.items()})}")
    return launched


def drive(torch, device: str, n_elements: int, n_removes: int,
          page_size: int = 1000, timed: bool = False, demo: bool = False):
    """The serve flow on ``device``; returns the scan's pages as plain data
    and the cluster.

    Every answer is held against a Python set of what was written."""
    from repro_torch.cluster import BigsetCluster
    from repro_torch.query.plan import Count, Scan
    from repro_torch.serve.bigset_service import (Backpressure, BigsetClient,
                                                  BigsetService, ServiceConfig)

    cluster = BigsetCluster(3, device=device)
    client = BigsetClient(BigsetService(cluster))
    elements = [b"%08d" % i for i in range(n_elements)]
    model = set(elements)
    tag = f"[main {device} {n_elements}]"

    t0 = time.perf_counter()
    for base in range(0, n_elements, 1000):
        res = client.batch(SET, [["add", e] for e in elements[base:base + 1000]])
        check(all("dot" in r for r in res), "an insert returned no dot")
    t_insert = time.perf_counter() - t0
    step = max(1, n_elements // n_removes)
    doomed = elements[::step][:n_removes]
    t0 = time.perf_counter()
    for base in range(0, len(doomed), 1000):
        res = client.batch(SET, [["remove", e] for e in doomed[base:base + 1000]])
        check(all(r.get("removed") for r in res), "a ctx-less remove missed")
    t_remove = time.perf_counter() - t0
    model.difference_update(doomed)
    tomb = cluster.vnodes[cluster.actors[0]].read_tombstone(SET)
    runs = sum(1 for _ in tomb.iter_runs())
    if timed:
        say(f"{tag} write: {n_elements} inserts in {t_insert:.3f}s "
            f"({n_elements / t_insert:.0f} el/s), {len(doomed)} ctx-less "
            f"removes in {t_remove:.3f}s; tombstone {runs} runs")

    t0 = time.perf_counter()
    pages, members = [], []
    for page in client.pages(Scan(SET, page_size=page_size)):
        members.extend(page.members)
        pages.append(([(e, tuple(tuple(d) for d in ds))
                       for e, ds in page.entries], dict(page.stats)))
    t_scan = time.perf_counter() - t0
    check(members == sorted(model),
          f"scan returned {len(members)} elements, the model holds {len(model)}")
    launches = sum(p[1]["kernel_launches"] for p in pages)
    if timed:
        say(f"{tag} scan: {len(members)} elements in {len(pages)} pages, "
            f"{t_scan:.3f}s ({len(members) / t_scan:.0f} el/s)")
        say(f"{tag} dot_seen launches per page: "
            f"{launches / len(pages):.2f} ({launches} over {len(pages)} pages)")

    if demo:
        retries = [0]

        def backoff(seconds: float) -> None:
            retries[0] += 1
            time.sleep(seconds)

        tight = BigsetClient(BigsetService(cluster, ServiceConfig(
            byte_budget=1, budget_window=0.5, lease_ttl=60.0)))
        slow = []
        for page in tight.pages(Scan(SET, page_size=page_size), sleep=backoff):
            slow.extend(page.members)
            if len(slow) >= 3 * page_size or page.cursor is None:
                break
        check(slow == sorted(model)[:len(slow)], "backpressured pages drifted")
        check(retries[0] > 0, "backpressure never engaged")
        say(f"{tag} backpressure: {len(slow)} elements, {retries[0]} retries, "
            f"no element re-emitted or skipped")

        def ride_out(fn, *args):
            while True:
                try:
                    return fn(*args)
                except Backpressure as bp:
                    time.sleep(bp.retry_after)

        victim = min(model)
        present, ctx = ride_out(client.membership, SET, victim)
        check(present and bool(ctx), "membership missed a live element")
        client.remove(SET, victim, ctx=ctx)
        model.discard(victim)
        present, _ = ride_out(client.membership, SET, victim)
        check(not present, "element visible after its ctx remove")
        gone, _ = ride_out(client.membership, SET, doomed[-1])
        check(not gone, "a removed element is visible")
        count = ride_out(client.query, Count(SET)).count
        check(count == len(model), f"count {count} != model {len(model)}")
        say(f"{tag} membership ctx round trip ok; count {count}")
    client.close()
    return pages, cluster


def phase_main(torch):
    from repro_torch.kernels.dot_seen import DISPATCHES

    DISPATCHES.reset()
    t0 = time.perf_counter()
    _, cluster = drive(torch, "cuda", 100_000, 2_000, timed=True, demo=True)
    torch.cuda.synchronize()
    launched = DISPATCHES.snapshot()
    say(f"[main] done in {time.perf_counter() - t0:.3f}s; dispatches "
        f"{json.dumps(vars(launched))}")
    check(launched.kernel_launches > 0, "the main path launched no kernel")
    check(launched.kernel_launches == launched.launches,
          "a dot_seen dispatch on the main path missed the CUDA kernel")
    return launched, cluster


def phase_parity(torch):
    cpu, _ = drive(torch, "cpu", 20_000, 400)
    cuda, _ = drive(torch, "cuda", 20_000, 400)
    check(len(cpu) == len(cuda), "cpu and cuda page counts differ")
    for i, (a, b) in enumerate(zip(cpu, cuda)):
        check(a == b, f"page {i} differs between cpu and cuda")
    say(f"[parity] cpu and cuda agree on {len(cpu)} pages at 20000 elements")


# ------------------------------------------------------------ cluster path
# The main path through a partitioned ring on a lossy network, durable with
# group commit, through a crash and a restart, a ring change and
# anti-entropy: the layout of benchmarks/bench_placement.py (8 vnodes,
# factor 3, 64 partitions) and benchmarks/bench_recovery.py (a seeded kill
# point tearing a vnode's WAL mid-batch).
CLUSTER_VNODES, CLUSTER_FACTOR, CLUSTER_GROUP_DEPTH = 8, 3, 8
CLUSTER_NET = dict(seed=1, drop_prob=0.1, dup_prob=0.05, reorder=True)
CLUSTER_VALUE_BYTES = 16
# anti-entropy is quiet after this many whole sweeps in a row ship no key
# and sync no pull
CLUSTER_QUIET_SWEEPS = 2
CLUSTER_SWEEP_CAP = 40
CLUSTER_HANDOFF_CAP = 200
# elements and context-less removes of the cluster path on the card and of
# its cpu / cuda parity run: cut from 100,000 / 2,000 and 20,000 / 400 to
# keep the whole script near half of its time limit (the path's seconds
# are host time and grow with the elements)
CLUSTER_ELEMENTS, CLUSTER_REMOVES = 50_000, 1_000
CLUSTER_PARITY_ELEMENTS, CLUSTER_PARITY_REMOVES = 10_000, 200


def until_quiet(cluster, tag: str) -> dict:
    """Anti-entropy in whole sweeps (one tick of every (partition, owner
    pair) round, its traffic then delivered) until ``CLUSTER_QUIET_SWEEPS``
    sweeps in a row ship no key and sync no pull; fails at the cap."""
    ring = cluster.ring
    sweep = ring.n_partitions * ring.factor * (ring.factor - 1) // 2
    ae = cluster.ae_stats()
    shipped0, digest0 = ae.keys_shipped, ae.digest_bytes
    sweeps, quiet = 0, 0
    t0 = time.perf_counter()
    while quiet < CLUSTER_QUIET_SWEEPS:
        check(sweeps < CLUSTER_SWEEP_CAP,
              f"{tag} anti-entropy not quiet after {sweeps} sweeps")
        before = (ae.keys_shipped, ae.rounds_synced)
        cluster.tick(budget=sweep)
        cluster.settle()
        sweeps += 1
        quiet = quiet + 1 if (ae.keys_shipped, ae.rounds_synced) == before \
            else 0
    cluster.settle()
    return {"sweeps": sweeps, "rounds_per_sweep": sweep,
            "keys_shipped": ae.keys_shipped - shipped0,
            "digest_bytes": ae.digest_bytes - digest0,
            "seconds": time.perf_counter() - t0}


def drive_cluster(torch, device: str, n_elements: int, n_removes: int,
                  page_size: int = 1000, timed: bool = False):
    """The bigset path on ``device`` through a partitioned, durable, lossy
    cluster; returns what the run shows (pages, ledgers, ring, recovery)
    as plain data, and the cluster.

    Writes go over the service's wire protocol (the ``batch`` and
    ``insert`` ops, each with its ``coordinator``), in batches of 1,000
    from rotating coordinators, each batch's replication then delivered by
    the lossy network.  Every answer is held against a Python model of the
    writes the client made: a context-less remove goes through a replica
    sure to hold every dot of its element (the dot's coordinator, or any
    owner once anti-entropy is quiet), and a write whose durability the
    crash left unconfirmed is retried by the client through a live
    owner."""
    import msgpack
    from repro_torch.cluster.clusters import BigsetCluster, Ring
    from repro_torch.cluster.sim import Network
    from repro_torch.query.plan import Count, Scan
    from repro_torch.serve.bigset_service import (STATUS_OK, WIRE_VERSION,
                                                  BigsetClient, BigsetService)
    from repro_torch.storage import CrashError, CrashPoint

    actors = [f"v{i}" for i in range(CLUSTER_VNODES)]
    cluster = BigsetCluster(
        ring=Ring.build(actors, factor=CLUSTER_FACTOR),
        net=Network(**CLUSTER_NET), sync=False, durable=True,
        group_depth=CLUSTER_GROUP_DEPTH, device=device)
    service = BigsetService(cluster)
    client = BigsetClient(service)
    tag = f"[cluster {device} {n_elements}]"
    out = {}

    def wire(op, body):
        body = dict(body, set=SET, session=client.session)
        raw = service.handle(msgpack.packb([WIRE_VERSION, op, body]))
        _version, status, reply = msgpack.unpackb(raw)
        check(status == STATUS_OK, f"{tag} {op} refused: {reply}")
        return reply

    def value(el):
        return b"val:" + el.rjust(CLUSTER_VALUE_BYTES - 4, b"0")

    def entry(el):
        """A live owner of the element's partition, as a coordinator."""
        owners = cluster.ring.preference_list(SET, el).owners
        live = [a for a in owners if a not in cluster.crashed]
        return cluster.actors.index(live[0])

    # ---- writes: rotating coordinators, replication over the lossy net
    elements = [b"%08d" % i for i in range(n_elements)]
    model = set(elements)
    coord_of = {}
    t0 = time.perf_counter()
    for b, base in enumerate(range(0, n_elements, 1000)):
        chunk = elements[base:base + 1000]
        coordinator = b % CLUSTER_VNODES
        res = wire("batch", {"coordinator": coordinator,
                             "ops": [["add", e, value(e)] for e in chunk]})
        check(all("dot" in r for r in res["results"]),
              f"{tag} an insert returned no dot")
        coord_of.update(dict.fromkeys(chunk, coordinator))
        cluster.settle()
    t_insert = time.perf_counter() - t0

    # ---- context-less removes, in two halves: one now, each through the
    # coordinator that minted its element's dot (the one replica sure to
    # hold it), and one after the ring change (see below)
    step = max(1, n_elements // n_removes)
    doomed = elements[::step][:n_removes]
    early, late = doomed[:len(doomed) // 2], doomed[len(doomed) // 2:]

    def remove(group, coordinator):
        for base in range(0, len(group), 1000):
            res = wire("batch", {"coordinator": coordinator, "ops": [
                ["remove", e] for e in group[base:base + 1000]]})
            check(all(r.get("removed") for r in res["results"]),
                  f"{tag} a context-less remove missed")
            cluster.settle()

    by_coord = {}
    for e in early:
        by_coord.setdefault(coord_of[e], []).append(e)
    t0 = time.perf_counter()
    for coordinator, group in sorted(by_coord.items()):
        remove(group, coordinator)
    t_remove = time.perf_counter() - t0
    model.difference_update(early)

    # ---- a seeded kill point tears v0's WAL mid-batch
    cluster.settle()
    cluster.sync_all()  # the acknowledgement barrier
    v0 = cluster.vnodes["v0"]
    v0_psets = [cluster.ring.storage_set(SET, pid)
                for pid in cluster.ring.partitions()
                if "v0" in cluster.ring.owners(pid)]
    durable = {ps: v0.value(ps) for ps in v0_psets}
    media = cluster.media["v0"]
    media.schedule_crash(
        CrashPoint(wal_bytes=len(media.wal) + media.wal_pending() + 40))
    window, crashed_at = [], None
    j = 0
    while crashed_at is None and j < 100_000:
        el = b"w%07d" % j
        j += 1
        if "v0" not in cluster.ring.preference_list(SET, el).owners:
            continue
        window.append(el)
        try:
            wire("insert", {"element": el, "value": value(el),
                            "coordinator": 0})
        except CrashError:
            crashed_at = el
    check(crashed_at is not None, f"{tag} the kill point never fired")
    acked_seq = v0.store.commit_seq
    cluster.crash("v0")
    # the client cannot tell which window writes reached a disk: it
    # retries each through a live owner of its partition
    for el in window:
        wire("insert", {"element": el, "value": value(el),
                        "coordinator": entry(el)})
    cluster.settle()
    model.update(window)
    t0 = time.perf_counter()
    rec = cluster.restart("v0")
    t_replay = time.perf_counter() - t0
    check(rec.batches_replayed > 0, f"{tag} recovery replayed nothing")
    check(rec.torn_bytes > 0, f"{tag} the torn record went unnoticed")
    check(rec.last_seq >= acked_seq,
          f"{tag} replay stopped at batch {rec.last_seq}, before the "
          f"acknowledged {acked_seq}")
    lost = sum(len(els - cluster.vnodes["v0"].value(ps))
               for ps, els in durable.items())
    check(lost == 0, f"{tag} {lost} elements durable before the crash "
                     f"were lost in replay")
    out["recovery"] = vars(rec)

    # ---- anti-entropy heals the restarted vnode's lost tail (and what
    # the network dropped) before the ring changes: handoff pulls from a
    # surviving owner, and a leaver's copy is retired only once the joiner
    # holds all of it (ROADMAP C11)
    out["heal"] = until_quiet(cluster, tag)

    # ---- a ring change: v8 joins, handoff until it drains
    net = cluster.net
    bytes0, shipped0 = net.bytes_sent, cluster.ae_stats().keys_shipped
    t0 = time.perf_counter()
    delta = cluster.add_vnode(f"v{CLUSTER_VNODES}")
    handoff_ticks = 0
    while (cluster.ring_state()["handoffs_pending"]
           or cluster.ring_state()["retires_pending"]):
        check(handoff_ticks < CLUSTER_HANDOFF_CAP,
              f"{tag} handoff did not drain in {CLUSTER_HANDOFF_CAP} ticks")
        cluster.tick(budget=0)
        cluster.settle()
        handoff_ticks += 1
    t_handoff = time.perf_counter() - t0
    out["handoff"] = {"moves": len(delta.moves), "ticks": handoff_ticks,
                      "bytes": net.bytes_sent - bytes0,
                      "keys": cluster.ae_stats().keys_shipped - shipped0}

    # ---- anti-entropy over the new ring until quiet
    out["antientropy"] = until_quiet(cluster, tag)

    # ---- the later removes.  A retire compacts the leaver, and compaction
    # shrinks its tombstones by the dots it discarded (paper section 4.3.3),
    # so the earlier removes leave little for a read to filter: these keep
    # the tombstones the read's dot_seen filter works on.  The owners
    # agree now, so any coordinator holds every dot of what it removes.
    t0 = time.perf_counter()
    for b, base in enumerate(range(0, len(late), 1000)):
        remove(late[base:base + 1000], b % len(cluster.actors))
    t_remove += time.perf_counter() - t0
    model.difference_update(late)
    out["removes"] = until_quiet(cluster, tag)

    # ---- the read: a full Scan, a Count, a membership ctx round trip
    t0 = time.perf_counter()
    pages, members = [], []
    for page in client.pages(Scan(SET, page_size=page_size), r=2):
        members.extend(page.members)
        pages.append(([(e, tuple(tuple(d) for d in ds))
                       for e, ds in page.entries], dict(page.stats)))
    t_scan = time.perf_counter() - t0
    check(members == sorted(model),
          f"{tag} scan returned {len(members)} elements, the model holds "
          f"{len(model)}")
    count = client.query(Count(SET), r=2).count
    check(count == len(model), f"{tag} count {count} != model {len(model)}")
    victim = min(model)
    present, ctx = client.membership(SET, victim, r=2)
    check(present and bool(ctx), f"{tag} membership missed a live element")
    check(client.remove(SET, victim, ctx=ctx), f"{tag} ctx remove missed")
    cluster.settle()
    model.discard(victim)
    # on a sync=False cluster the remove is acknowledged by its coordinator
    # alone (the network may drop its replicas): ask every owner
    gone, _ = client.membership(SET, victim, r=CLUSTER_FACTOR)
    check(not gone, f"{tag} element visible after its ctx remove")
    after = client.query(Count(SET), r=CLUSTER_FACTOR).count
    check(after == len(model), f"{tag} count {after} != model {len(model)}")
    client.close()

    launches = sum(p[1]["kernel_launches"] for p in pages)
    out.update(pages=pages, count=count, ring=cluster.ring_state(),
               ae=vars(cluster.ae_stats()),
               net=[net.bytes_sent, net.msgs_sent, net.msgs_dropped])
    if timed:
        n_win = len(window)
        say(f"{tag} write: {n_elements} inserts in {t_insert:.3f}s "
            f"({n_elements / t_insert:.0f} el/s), {len(doomed)} "
            f"context-less removes in {t_remove:.3f}s "
            f"({len(doomed) / t_remove:.0f} el/s)")
        say(f"{tag} crash: v0's WAL torn at {crashed_at.decode()} "
            f"({n_win} window writes retried); replay {t_replay:.4f}s, "
            f"{json.dumps(out['recovery'])}")
        say(f"{tag} ring change: {out['handoff']['moves']} of "
            f"{cluster.ring.n_partitions} partitions moved; handoff "
            f"{handoff_ticks} ticks in {t_handoff:.3f}s, "
            f"{out['handoff']['keys']} keys, {out['handoff']['bytes']} bytes")
        for name, when in (("heal", "before the ring change"),
                           ("antientropy", "after the ring change"),
                           ("removes", "after the later removes")):
            a = out[name]
            say(f"{tag} anti-entropy ({when}): quiet after "
                f"{a['sweeps']} sweeps of {a['rounds_per_sweep']} rounds in "
                f"{a['seconds']:.3f}s; {a['keys_shipped']} keys shipped, "
                f"{a['digest_bytes']} digest bytes")
        say(f"{tag} scan: {len(members)} elements in {len(pages)} pages, "
            f"{t_scan:.3f}s ({len(members) / t_scan:.0f} el/s); count "
            f"{count}; membership ctx round trip ok")
        say(f"{tag} dot_seen launches per page: "
            f"{launches / len(pages):.2f} ({launches} over {len(pages)} "
            f"pages)")
    return out, cluster


def phase_cluster(torch):
    from repro_torch.kernels.dot_seen import DISPATCHES

    DISPATCHES.reset()
    t0 = time.perf_counter()
    _, cluster = drive_cluster(torch, "cuda", CLUSTER_ELEMENTS,
                               CLUSTER_REMOVES, timed=True)
    torch.cuda.synchronize()
    launched = DISPATCHES.snapshot()
    say(f"[cluster] done in {time.perf_counter() - t0:.3f}s; dispatches "
        f"{json.dumps(vars(launched))}")
    check(launched.kernel_launches > 0, "the cluster path launched no kernel")
    check(launched.kernel_launches == launched.launches,
          "a dot_seen dispatch on the cluster path missed the CUDA kernel")
    ring = cluster.ring
    groups = [[(cluster.vnodes[a], ring.storage_set(SET, pid))
               for a in ring.owners(pid)] for pid in ring.partitions()]
    clock_launched = phase_clock_entry(torch, cluster, groups)
    return launched, clock_launched


def phase_cluster_parity(torch):
    cpu, _ = drive_cluster(torch, "cpu", CLUSTER_PARITY_ELEMENTS,
                           CLUSTER_PARITY_REMOVES)
    cuda, _ = drive_cluster(torch, "cuda", CLUSTER_PARITY_ELEMENTS,
                            CLUSTER_PARITY_REMOVES)
    check(len(cpu["pages"]) == len(cuda["pages"]),
          "cpu and cuda page counts differ on the cluster path")
    for i, (a, b) in enumerate(zip(cpu["pages"], cuda["pages"])):
        check(a == b, f"cluster page {i} differs between cpu and cuda")
    for run in (cpu, cuda):  # wall seconds differ by nature
        for key in ("heal", "antientropy", "removes"):
            run[key].pop("seconds")
    for key in ("count", "ring", "ae", "net", "recovery", "heal", "handoff",
                "antientropy", "removes"):
        check(cpu[key] == cuda[key],
              f"cluster {key} differs between cpu and cuda: "
              f"{cpu[key]} != {cuda[key]}")
    say(f"[cluster parity] cpu and cuda agree at "
        f"{CLUSTER_PARITY_ELEMENTS} elements: "
        f"{len(cpu['pages'])} pages, bytes sent {cpu['net'][0]}, "
        f"anti-entropy {json.dumps(cpu['ae'])}, ring "
        f"{json.dumps(cpu['ring'])}")


# ------------------------------------------------------------- model path
MODEL_ARCH = "gemma3-27b"
SSM_ARCH = "falcon-mamba-7b"
MODEL_MAX_BATCH, MODEL_MAX_LEN, MODEL_NEW = 4, 2048, 16
LONG_PROMPTS = (1536, 1280)


class ProbedModel:
    """The engine's model, with each serve step timed (the engine syncs on
    every sampled token anyway) and its logits checked for finiteness."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_steps = 0
        self.finite = []

    def _timed(self, fn, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.finite.append(self.torch.isfinite(logits).all())
        return logits, cache, time.perf_counter() - t0

    def prefill_step(self, params, batch, max_len=None):
        logits, cache, dt = self._timed(self.model.prefill_step, params,
                                        batch, max_len=max_len)
        self.prefill_s += dt
        self.prefill_tokens += batch["tokens"].numel()
        return logits, cache

    def decode_step(self, params, cache, tokens, cache_len):
        logits, cache, dt = self._timed(self.model.decode_step, params, cache,
                                        tokens, cache_len)
        self.decode_s += dt
        self.decode_steps += 1
        return logits, cache


def _trace(torch, fn, n: int):
    """Device time by kernel name over ``n`` calls of ``fn``, from
    ``torch.profiler`` (CUDA kernels only), and the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    return by_name, wall


# the MoE dispatch's kernels (top-k, the stable sort, searchsorted, the
# rank and inverse scatters, the row gathers both ways); the embedding's
# and the cross-entropy's gathers fall in this class too
DISPATCH_NAMES = ("topk", "radix", "sort", "scatter", "gather",
                  "indexselect", "index_select", "index_elementwise")


def _kernel_class(name: str) -> str:
    if "mamba_scan_bwd_" in name:
        return "mamba_scan_bwd"
    for kernel in ("flash_attention", "decode_attention", "mamba_scan"):
        if f"{kernel}_kernel" in name:
            return kernel
    if "attn_bwd_" in name:
        return "flash_attention_bwd"
    low = name.lower()
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "splitk")):
        return "matmul"
    if any(s in low for s in DISPATCH_NAMES):
        return "dispatch"
    return "other"


def profile_steps(torch, eng, probe, ms_per_step: float, long_prompt):
    """Where a decode step and a long prefill spend device time: one trace
    of 3 decode steps of the served batch and one of the longest prompt's
    prefill.  The busy share of a decode step is its traced device time
    over the untraced step time measured while serving."""
    model = probe.model
    tokens = torch.zeros((eng.max_batch, 1), dtype=torch.int32, device="cuda")
    steps = 3
    for what, fn, n in (
            ("decode step", lambda: model.decode_step(
                eng.params, eng.cache, tokens, eng.cache_len), steps),
            ("prefill", lambda: model.prefill_step(
                eng.params, {"tokens": torch.as_tensor(
                    long_prompt[None, :], device="cuda")},
                max_len=eng.max_len), 1)):
        try:
            by_name, wall = _trace(torch, fn, n)
        except RuntimeError as e:  # the profiler, not the path, failed
            say(f"[model profile] {what}: not measured ({e})")
            continue
        total_us = sum(by_name.values())
        if total_us == 0:
            say(f"[model profile] {what}: the trace holds no device time")
            continue
        classes = {}
        for name, us in by_name.items():
            c = _kernel_class(name)
            classes[c] = classes.get(c, 0.0) + us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out = dict(calls=n, device_ms_per_call=total_us / n / 1e3,
                   traced_wall_ms_per_call=wall / n * 1e3,
                   ms_by_class={c: us / n / 1e3 for c, us in classes.items()},
                   top_kernels_ms=[[name[:80], us / n / 1e3]
                                   for name, us in top])
        if what == "decode step":
            out["untraced_ms_per_step"] = ms_per_step
            out["device_busy_share"] = total_us / n / 1e3 / ms_per_step
        say(f"[model profile] {what}: {json.dumps(out)}")


def model_prompts(np, vocab: int):
    """Four prompts of 4-16 tokens drawn as ``launch/serve.py`` draws them,
    and the two long ones, interleaved so both long ones are admitted in
    the first wave."""
    rng = np.random.default_rng(0)
    short = [rng.integers(0, vocab, int(rng.integers(4, 16))) for _ in range(4)]
    long_ = [rng.integers(0, vocab, n) for n in LONG_PROMPTS]
    return [long_[0], short[0], long_[1], short[1], short[2], short[3]]


def _leaves(tree):
    """Every tensor of a nest of dicts and lists."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_full_model(torch, np, arch: str, ledgers, routes=None,
                     n_layers=None, during=None):
    """Serve the six prompts on the full ``arch`` (its depth cut to
    ``n_layers`` where given) in bf16 with random weights through
    ``ServeEngine``, with ``ledgers`` (name -> the kernel wrappers'
    ``DISPATCHES``) and ``routes`` (name -> a wrapper's launches by route
    or by type) zeroed just before and read just after, and the serving
    loop inside the context ``during`` where given.

    Checks that every request is served in full, every token is in the
    vocabulary, every logit is finite and every dispatch launched the CUDA
    kernel; prints the path's metrics and a profile, then frees the model
    and the engine.  Returns (config, requests, decode steps, counts,
    launches by route, the path's metrics)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    cut = ""
    if n_layers is not None:
        cut = f" (depth cut from {cfg.n_layers})"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    say(f"[model {arch}] {cfg.n_layers} layers{cut}, d_model {cfg.d_model}, "
        f"{n_params} parameters, {weight_bytes / 1e9:.3f} GB of {cfg.dtype} "
        f"weights, drawn on the card in {t_init:.3f}s (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB while drawing)")

    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, max_batch=MODEL_MAX_BATCH,
                      max_len=MODEL_MAX_LEN, device="cuda")
    probe = ProbedModel(torch, eng.model)
    eng.model = probe
    reqs = [eng.submit(p, max_new_tokens=MODEL_NEW)
            for p in model_prompts(np, cfg.vocab_size)]

    routes = {} if routes is None else routes
    for ledger in ledgers.values():
        ledger.reset()
    for by_route in routes.values():
        for route in by_route:
            by_route[route] = 0
    t0 = time.perf_counter()
    decode_tokens = 0
    with during if during is not None else contextlib.nullcontext():
        while eng.queue or any(s is not None for s in eng.slots):
            decode_tokens += eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: ledger.snapshot() for name, ledger in ledgers.items()}
    route_counts = {name: dict(r) for name, r in routes.items()}

    check(all(r.done and len(r.out_tokens) == MODEL_NEW for r in reqs),
          f"{arch}: a request was not served in full")
    check(all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.out_tokens),
          f"{arch}: a sampled token is out of the vocabulary")
    check(bool(torch.stack(probe.finite).all()), f"{arch}: a logit is not finite")
    check(all(c.kernel_launches == c.launches > 0 for c in counts.values()),
          f"{arch}: a dispatch on the model path missed the CUDA kernel")
    peak = torch.cuda.max_memory_allocated()
    ms_per_step = probe.decode_s / probe.decode_steps * 1e3
    stats = dict(
        requests=len(reqs), prompt_tokens=probe.prefill_tokens,
        new_tokens=sum(len(r.out_tokens) for r in reqs),
        decode_steps=probe.decode_steps, decode_tokens=decode_tokens,
        wall_s=wall, prefill_s=probe.prefill_s, decode_s=probe.decode_s,
        prefill_tok_per_s=probe.prefill_tokens / probe.prefill_s,
        decode_tok_per_s=decode_tokens / probe.decode_s,
        ms_per_decode_step=ms_per_step,
        # a decode step reads every weight once
        weight_read_floor_ms=weight_bytes / PEAK_BYTES_PER_S * 1e3,
        n_params=n_params, weight_gb=weight_bytes / 1e9, peak_gb=peak / 1e9,
        cache_dtypes=sorted({str(t.dtype).removeprefix("torch.")
                             for t in _leaves(eng.cache)}),
        **{name: vars(c) for name, c in counts.items()},
        **({"routes": route_counts} if route_counts else {}))
    say(f"[model {arch}] served: {json.dumps(stats)}")
    for r in reqs:
        say(f"[model {arch}]   req{r.rid} ({len(r.prompt)} prompt tokens): "
            f"{r.out_tokens}")
    profile_steps(torch, eng, probe, ms_per_step, reqs[0].prompt)
    n_reqs, steps = len(reqs), probe.decode_steps
    del eng, params, probe, reqs
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[model {arch}] freed: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"still allocated")
    return cfg, n_reqs, steps, counts, route_counts, stats


def _mixers(cfg):
    """(attention layers, Mamba layers) of ``cfg``."""
    n_mamba = sum(cfg.layer_kind(i)[0] == "mamba" for i in range(cfg.n_layers))
    return cfg.n_layers - n_mamba, n_mamba


def serve_attention_model(torch, np, arch: str, n_layers=None, during=None):
    """``serve_full_model`` on a model with attention: every prefill on the
    flash kernel's tensor-core route (bf16, head dim a multiple of 16),
    one flash launch an attention layer and prompt, one decode launch an
    attention layer and step; a hybrid's Mamba layers one scan launch (on
    the bf16 activations) a layer and prompt.  Returns (config, requests,
    decode steps, the flash, decode and scan counts, the path's metrics);
    the scan count is None for a model without Mamba layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    full = get_config(arch)
    n_attn, n_mamba = _mixers(dataclasses.replace(
        full, n_layers=n_layers or full.n_layers))
    ledgers = {"flash": fa.DISPATCHES, "decode": dec.DISPATCHES}
    if n_mamba:
        ledgers["mamba_scan"] = ms.DISPATCHES
    grids = {}

    @contextlib.contextmanager
    def counting_grids():
        # decode launches by grid over the serving loop alone
        dec.LAUNCHES.clear()
        with during if during is not None else contextlib.nullcontext():
            yield
        grids.update(dec.launches_by_group())

    cfg, n_reqs, steps, counts, by_route, stats = serve_full_model(
        torch, np, arch, ledgers, routes={"flash": fa.ROUTE_LAUNCHES,
                                          "mamba_scan": ms.DTYPE_LAUNCHES},
        n_layers=n_layers, during=counting_grids())
    flash, decode = counts["flash"], counts["decode"]
    routes = by_route["flash"]
    # a group above 8 query heads a kv head is cut across blocks
    group = "chunked" if cfg.n_heads // cfg.n_kv_heads > 8 else "whole"
    stats["decode_grids"] = grids
    say(f"[model {arch}] decode launches by grid: {json.dumps(grids)}")
    check(grids == {"whole": 0, "chunked": 0, group: decode.launches},
          f"decode_attention launches by grid {grids}: every "
          f"{arch} decode step ({cfg.n_heads} over {cfg.n_kv_heads} heads) "
          f"must launch the {group} grid")
    scans = counts.get("mamba_scan")
    dtypes = by_route["mamba_scan"]
    want = {"float32": 0, "bfloat16": scans.launches if scans else 0}
    check(dtypes == want, f"mamba_scan launches by input type {dtypes}: "
          f"every scan of the bf16 {arch} must read bf16")
    if scans is not None:
        check(scans.launches == n_mamba * n_reqs,
              f"mamba_scan dispatches {scans.launches} != {n_mamba} Mamba "
              f"layers x {n_reqs} prompts")
    # decode has the split-KV kernels alone, so a launch of its kernel is one
    check(routes == {"tc": flash.launches, "simt": 0},
          f"flash_attention launches by route {routes}: every bf16 "
          f"{arch} prefill must take the tensor-core route")
    check(flash.kernel_launches == flash.launches
          and decode.kernel_launches == decode.launches,
          "an attention dispatch missed its CUDA kernel")
    check(flash.launches == n_attn * n_reqs,
          f"flash_attention dispatches {flash.launches} != "
          f"{n_attn} attention layers x {n_reqs} prompts")
    check(decode.launches == n_attn * steps,
          f"decode_attention dispatches {decode.launches} != "
          f"{n_attn} attention layers x {steps} steps")
    return cfg, n_reqs, steps, flash, decode, scans, stats


def phase_model(torch, np):
    _, _, _, flash, decode, _, _ = serve_attention_model(torch, np,
                                                         MODEL_ARCH)
    return flash, decode


def phase_ssm_model(torch, np):
    from repro_torch.kernels import mamba_scan as ms

    cfg, n_reqs, _, counts, by_route, _ = serve_full_model(
        torch, np, SSM_ARCH, {"mamba_scan": ms.DISPATCHES},
        routes={"mamba_scan": ms.DTYPE_LAUNCHES})
    scans, dtypes = counts["mamba_scan"], by_route["mamba_scan"]
    check(scans.launches == cfg.n_layers * n_reqs,
          f"mamba_scan dispatches {scans.launches} != "
          f"{cfg.n_layers} x {n_reqs} prompts")
    # the bf16 model hands the scan its bf16 activations, uncast
    check(dtypes == {"float32": 0, "bfloat16": scans.launches},
          f"mamba_scan launches by input type {dtypes}: every scan of the "
          f"bf16 {SSM_ARCH} must read bf16")
    return scans


def tree_to(tree, device: str):
    """A copy of a nest of dicts and lists of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def _serve_smoke(np, cfg, params, device: str):
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, max_batch=4, max_len=64, device=device)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=16)
            for n in (5, 21, 9, 30, 12, 17)]
    eng.run_until_drained()
    return [r.out_tokens for r in reqs]


def smoke_parity(torch, np, arch: str, ledgers, shrink_embed=False,
                 cfg=None):
    """The smoke ``arch`` (or ``cfg``) in fp32, served on cpu and on
    cuda; every dispatch of ``ledgers`` in the cuda run must launch the
    kernel."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    # fp32 products in full fp32 on the card (PyTorch's default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = smoke_config(arch)
    cfg = cfg or smoke
    cpu_model = build_model(cfg, "cpu")
    params = cpu_model.init(0)
    if cfg.scale_embeddings or shrink_embed:
        # at random init the (scaled, or tied) embedding dominates the
        # residual stream and greedy decoding repeats the prompt's last
        # token whatever the layers do; a smaller embedding makes the
        # streams depend on them
        params["embed"]["tok"] *= 0.05
    gpu_params = tree_to(params, "cuda")

    cpu_streams = _serve_smoke(np, cfg, params, "cpu")
    for ledger in ledgers:
        ledger.reset()
    gpu_streams = _serve_smoke(np, cfg, gpu_params, "cuda")
    torch.cuda.synchronize()
    check(all(d.kernel_launches == d.launches > 0 for d in ledgers),
          f"the cuda smoke {arch} run did not go through the kernels")
    check(cpu_streams == gpu_streams,
          f"token streams differ: cpu {cpu_streams} cuda {gpu_streams}")
    varied = sum(len(set(s)) > 1 for s in cpu_streams)

    errs = [float((c - g).abs().max()) for c, g in zip(
        forced_logits(torch, np, cfg, params, "cpu"),
        forced_logits(torch, np, cfg, gpu_params, "cuda"))]
    check(max(errs) <= 1e-4,
          f"{arch}: cpu and cuda logits differ by {max(errs)}")
    say(f"[model parity] {'smoke' if cfg is smoke else 'narrow'} {arch} "
        f"fp32: identical greedy streams "
        f"for {len(cpu_streams)} requests ({varied} of them not a single "
        f"repeated token); prefill + 12 decode steps' logits within "
        f"{max(errs):.3g} of the cpu run")


def forced_logits(torch, np, cfg, params, device: str):
    """Logits (on the cpu) of a seeded prefill of two 21-token prompts and
    12 decode steps of seeded tokens, on ``device``."""
    from repro_torch.models import build_model

    model = build_model(cfg, device)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 21))
    logits, cache = model.prefill_step(
        params, {"tokens": torch.as_tensor(prompt, device=device)}, max_len=64)
    out = [logits.cpu()]
    lens = np.array([21, 21], np.int32)
    for step in range(12):
        tok = np.random.default_rng(10 + step).integers(0, cfg.vocab_size, (2, 1))
        logits, cache = model.decode_step(
            params, cache, torch.as_tensor(tok, device=device),
            torch.as_tensor(lens, device=device))
        out.append(logits.cpu())
        lens = lens + 1
    return out


def phase_model_parity(torch, np):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    smoke_parity(torch, np, MODEL_ARCH, [fa.DISPATCHES, dec.DISPATCHES])


def phase_ssm_parity(torch, np):
    """The smoke SSM model in fp32 (``smoke_parity``), then in bf16, the
    type of the SSM path, whose scans read bf16: cpu and cuda logits of
    ``forced_logits`` within 2e-2 (atol = rtol; the two devices round
    bf16 products and activations at other places)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import build_model

    smoke_parity(torch, np, SSM_ARCH, [ms.DISPATCHES])
    cfg = dataclasses.replace(smoke_config(SSM_ARCH), dtype="bfloat16")
    params = build_model(cfg, "cpu").init(0)
    want = forced_logits(torch, np, cfg, params, "cpu")
    ms.DISPATCHES.reset()
    got = forced_logits(torch, np, cfg, tree_to(params, "cuda"), "cuda")
    torch.cuda.synchronize()
    scans = ms.DISPATCHES.snapshot()
    check(scans.kernel_launches == scans.launches == cfg.n_layers,
          f"the cuda bf16 smoke {SSM_ARCH} prefill: {vars(scans)}")
    check(all(g.dtype == torch.bfloat16 for g in got),
          f"bf16 smoke {SSM_ARCH}: logits in {got[0].dtype}")
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    check(all(_allclose(g, w, 2e-2) for g, w in zip(got, want)),
          f"bf16 smoke {SSM_ARCH}: cpu and cuda logits differ by {err}")
    say(f"[model parity] smoke {SSM_ARCH} bf16: prefill + 12 decode steps' "
        f"logits within 2e-2 of the cpu run (max abs err {err:.3g}), "
        f"{scans.kernel_launches} bf16 scans on the kernel")


VLM_ARCH = "pixtral-12b"


def phase_vlm_parity(torch, np):
    """The smoke ``pixtral-12b`` (fp32) with seeded ``patch_embeds`` on cpu
    and on cuda: the same greedy stream from a prefill and 12 decode steps,
    logits within 1e-4, and other logits without the patches (the splice
    took effect on the card)."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(VLM_ARCH)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 21))
    patches = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    params = build_model(cfg, "cpu").init(0)
    gpu_params = tree_to(params, "cuda")

    def greedy(device, p, with_patches=True):
        model = build_model(cfg, device)
        batch = {"tokens": torch.as_tensor(prompt, device=device)}
        if with_patches:
            batch["patch_embeds"] = torch.as_tensor(patches, device=device)
        logits, cache = model.prefill_step(p, batch, max_len=64)
        out, stream = [logits.cpu()], []
        lens = torch.full((2,), prompt.shape[1], dtype=torch.int32,
                          device=device)
        for _ in range(12):
            tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
            stream.append(tok.cpu())
            logits, cache = model.decode_step(p, cache, tok, lens)
            out.append(logits.cpu())
            lens = lens + 1
        return torch.cat(stream, dim=1).tolist(), out

    cpu_stream, cpu_logits = greedy("cpu", params)
    for ledger in (fa.DISPATCHES, dec.DISPATCHES):
        ledger.reset()
    gpu_stream, gpu_logits = greedy("cuda", gpu_params)
    torch.cuda.synchronize()
    check(all(d.kernel_launches == d.launches > 0
              for d in (fa.DISPATCHES, dec.DISPATCHES)),
          f"the cuda smoke {VLM_ARCH} run did not go through the kernels")
    check(cpu_stream == gpu_stream,
          f"{VLM_ARCH} greedy streams differ: cpu {cpu_stream} cuda "
          f"{gpu_stream}")
    err = max(float((c - g).abs().max()) for c, g in zip(cpu_logits,
                                                         gpu_logits))
    check(err <= 1e-4, f"{VLM_ARCH}: cpu and cuda logits differ by {err}")
    _, plain_logits = greedy("cuda", gpu_params, with_patches=False)
    moved = float((plain_logits[0] - gpu_logits[0]).abs().max())
    check(moved > 0.1, f"{VLM_ARCH}: patch_embeds moved the prefill logits "
          f"by only {moved}")
    say(f"[model parity] smoke {VLM_ARCH} fp32 with patch_embeds: identical "
        f"greedy streams {gpu_stream}; prefill + 12 decode steps' logits "
        f"within {err:.3g} of the cpu run; without the patches the prefill "
        f"logits move by {moved:.3g}")


# -------------------------------------------------------------- MoE paths
MOE_ARCH = "granite-moe-1b-a400m"
GROK_ARCH = "grok-1-314b"
# grok-1-314b's depth cut from 64 layers: a layer holds 4.92 B parameters
# (9.84 GB in bf16) and the tied table 0.81 B, so 6 layers are 60.7 GB
GROK_LAYERS = 6


@contextlib.contextmanager
def recorded_routing(records):
    """Every MoE layer's routing while inside, appended to ``records`` as
    (tokens a row, which token-slots were kept): kept as they are, on the
    card, so that recording launches nothing."""
    from repro_torch.models import mlp

    route = mlp.route

    def recording(p, cfg, x, capacity):
        r = route(p, cfg, x, capacity)
        records.append((x.shape[1], r.keep))
        return r

    mlp.route = recording
    try:
        yield records
    finally:
        mlp.route = route


def serve_moe_model(torch, np, arch: str, n_layers=None):
    """``serve_attention_model`` on an MoE model, with the share of
    token-slots each prefill dropped over its experts' capacity (over its
    MoE layers).  A decode step routes one token a row, which takes each
    expert at most once, so it drops none."""
    from repro_torch.models.mlp import capacity

    records = []
    cfg, n_reqs, steps, flash, decode, scans, stats = serve_attention_model(
        torch, np, arch, n_layers=n_layers, during=recorded_routing(records))
    n_moe = sum(cfg.layer_kind(i)[1] == "moe" for i in range(cfg.n_layers))
    prefills = [r for r in records if r[0] > 1]
    decodes = [r for r in records if r[0] == 1]
    check(len(prefills) == n_moe * n_reqs and len(decodes) == n_moe * steps,
          f"{arch}: {len(prefills)} prefill and {len(decodes)} decode "
          f"routings, not {n_moe} x {n_reqs} and {n_moe} x {steps}")
    drops = []
    for i in range(n_reqs):
        group = prefills[i * n_moe:(i + 1) * n_moe]
        T = group[0][0]
        dropped = sum(int((~keep).sum()) for _, keep in group)
        drops.append(dict(prompt_tokens=T, capacity=capacity(cfg, T),
                          dropped_share=dropped / sum(
                              keep.numel() for _, keep in group)))
    decode_dropped = sum(int((~keep).sum()) for _, keep in decodes)
    check(decode_dropped == 0,
          f"{arch}: decode dropped {decode_dropped} token-slots")
    say(f"[model {arch}] capacity drops by prefill ({n_moe} MoE layers, "
        f"{cfg.n_experts} experts, top {cfg.experts_per_token}, capacity "
        f"factor {cfg.capacity_factor}): {json.dumps(drops)}; decode: 0 of "
        f"{sum(keep.numel() for _, keep in decodes)} token-slots dropped")
    return cfg, flash, decode, scans, stats


def phase_moe_model(torch, np):
    _, flash, decode, _, _ = serve_moe_model(torch, np, MOE_ARCH)
    return flash, decode


def phase_grok_model(torch, np):
    """grok-1-314b at full width with its depth cut to ``GROK_LAYERS``,
    after every earlier model is freed; its decode steps read the int8
    cache, dequantised, through the decode kernel."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    say(f"[model {GROK_ARCH}] {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated before the model is drawn")
    cfg, flash, decode, _, stats = serve_moe_model(torch, np, GROK_ARCH,
                                                   n_layers=GROK_LAYERS)
    check(cfg.kv_cache_dtype == "int8" and "int8" in stats["cache_dtypes"],
          f"{GROK_ARCH}: the cache holds {stats['cache_dtypes']}, no int8")
    return flash, decode


HYBRID_ARCH = "jamba-1.5-large-398b"
# jamba-1.5-large-398b's depth cut from 72 layers to the first 5, so that
# the attention layer of each 8 (offset 4) is in: 4 Mamba mixers and 1
# attention mixer, 2 MoE FFNs and 3 dense ones, 24.05 B parameters (48.1 GB
# in bf16); a sixth layer (an MoE one) would make 34.1 B, 68 GB
HYBRID_LAYERS = 5


def phase_hybrid_model(torch, np):
    """jamba-1.5-large-398b at full width with its depth cut to
    ``HYBRID_LAYERS``, after every earlier model is freed: its Mamba
    layers' prefill scans at d_inner 16,384 and its attention layer's
    int8 cache, dequantised, through the decode kernel."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    say(f"[model {HYBRID_ARCH}] {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated before the model is drawn")
    cfg, flash, decode, scans, stats = serve_moe_model(
        torch, np, HYBRID_ARCH, n_layers=HYBRID_LAYERS)
    check(_mixers(cfg) == (1, 4), f"{HYBRID_ARCH} cut to {cfg.n_layers} "
          f"layers holds {_mixers(cfg)} attention and Mamba mixers")
    check(cfg.kv_cache_dtype == "int8" and "int8" in stats["cache_dtypes"],
          f"{HYBRID_ARCH}: the cache holds {stats['cache_dtypes']}, no int8")
    return flash, decode, scans


def phase_moe_parity(torch, np):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    for arch in (MOE_ARCH, GROK_ARCH):
        smoke_parity(torch, np, arch, [fa.DISPATCHES, dec.DISPATCHES],
                     shrink_embed=True)


# --------------------------------------------------- attention backward
# The training path's shape (minitron-4b: 24 query over 8 KV heads, head
# dim 128, one 4,096-token sequence, causal, bf16), a local layer of
# gemma3-27b (32 over 16 heads, window 1,024), gemma-7b's MHA at head dim
# 256, a T that does not fill a tile, the MoE training path's shape
# (granite-moe-1b-a400m: 16 over 8 heads of 64, 4,096 tokens), and fp32.
BWD_SHAPES = {
    "path": dict(B=1, Hq=24, Hkv=8, T=4096, S=4096, D=128, window=None,
                 causal=True, dtype="bfloat16"),
    "local": dict(B=1, Hq=32, Hkv=16, T=2048, S=2048, D=128, window=1024,
                  causal=True, dtype="bfloat16"),
    "mha-256": dict(B=1, Hq=16, Hkv=16, T=1024, S=1024, D=256, window=None,
                    causal=True, dtype="bfloat16"),
    "ragged": dict(B=1, Hq=24, Hkv=8, T=63, S=63, D=128, window=None,
                   causal=True, dtype="bfloat16"),
    "moe-path": dict(B=1, Hq=16, Hkv=8, T=4096, S=4096, D=64, window=None,
                     causal=True, dtype="bfloat16"),
    # whisper-tiny's training microbatch (64 rows, 6 heads of 64): its
    # cross-attention (448 decoder positions against 1,500 encoder ones)
    # and its encoder, neither causal
    "cross": dict(B=64, Hq=6, Hkv=6, T=448, S=1500, D=64, window=None,
                  causal=False, dtype="bfloat16"),
    "encoder": dict(B=64, Hq=6, Hkv=6, T=1500, S=1500, D=64, window=None,
                    causal=False, dtype="bfloat16"),
    "fp32": dict(B=1, Hq=24, Hkv=8, T=1024, S=1024, D=128, window=None,
                 causal=True, dtype="float32"),
    # the dense family's training paths at one 4,096-token sequence:
    # pixtral-12b's 32 over 8 heads (a group of 4) and mistral-large-123b's
    # 96 over 8 (a group of 12: a dK / dV block runs 12 x 64 stages), each
    # in bf16 and fp32
    "pixtral": dict(B=1, Hq=32, Hkv=8, T=4096, S=4096, D=128, window=None,
                    causal=True, dtype="bfloat16"),
    "mistral": dict(B=1, Hq=96, Hkv=8, T=4096, S=4096, D=128, window=None,
                    causal=True, dtype="bfloat16"),
    "pixtral-fp32": dict(B=1, Hq=32, Hkv=8, T=4096, S=4096, D=128,
                         window=None, causal=True, dtype="float32"),
    "mistral-fp32": dict(B=1, Hq=96, Hkv=8, T=4096, S=4096, D=128,
                         window=None, causal=True, dtype="float32"),
}
# B4''s tolerances by dtype and reference: (rtol, atol) elementwise or
# None, and the largest ||g - ref|| / ||ref|| or None.  fp32 as the CPU
# tests.  bf16 against the plain version (the same bf16 forward output
# and lse): two bf16 steps of each entry (2^-6) above a floor of 1e-3,
# and 1e-3 in norm; a sound kernel differs by one step of the largest
# entries, 1e-4 in norm.  Against fp32 autograd (the exact output) 1e-2
# in norm only: the backward reads the forward's bf16 output, whose
# rounding enters delta = sum dO.O as an absolute error of every dS, so
# entries near 0 are off by up to ~0.02 while each gradient stays within
# 2e-3 in norm.  Wrong gradients read 0.03 and more (PERF.md section 6).
BWD_TOL = {("float32", "plain"): ((1e-4, 1e-5), None),
           ("float32", "autograd"): ((1e-4, 1e-5), None),
           ("bfloat16", "plain"): ((1.6e-2, 1e-3), 1e-3),
           ("bfloat16", "autograd"): (None, 1e-2)}


def _grad_err(g, ref):
    """``(max abs err, ||g - ref|| / ||ref||)`` in fp32."""
    d = g.float() - ref.float()
    return (float(d.abs().max()),
            float(d.norm() / ref.float().norm().clamp_min(1e-30)))


def _grad_ok(g, ref, dtype: str, against: str) -> bool:
    close, rel = BWD_TOL[(dtype, against)]
    if close is not None:
        rtol, atol = close
        if not bool(((g.float() - ref.float()).abs()
                     <= atol + rtol * ref.float().abs()).all()):
            return False
    return rel is None or _grad_err(g, ref)[1] <= rel


def _wrong_bwd(torch, fa, q, k, v, out, dout, lse, window, refs,
               dtype: str):
    """What two wrong gradients read against the plain version and fp32
    autograd (``refs``), each of which both checks must reject: dK and dV
    without the first query head of each group over the later half of
    the keys (the kernel's own gradients with that head's dO zeroed,
    spliced into its sound ones), and all three from an lse one bf16 step
    high."""
    G = q.shape[1] // k.shape[1]
    sound = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=True,
                                   window=window)
    silent = dout.clone()
    silent[:, ::G] = 0
    _, dk0, dv0 = fa.flash_attention_bwd(q, k, v, out, silent, lse,
                                         causal=True, window=window)
    half = k.shape[2] // 2
    dk, dv = sound[1], sound[2]
    dk[:, :, half:] = dk0[:, :, half:]
    dv[:, :, half:] = dv0[:, :, half:]
    step = torch.exp2(torch.floor(torch.log2(lse.abs())) - 7)
    high = lse + torch.where(torch.isfinite(step), step, 0.0)
    cases = {"dkdv_without_one_query_head": dict(dk=dk, dv=dv),
             "lse_one_bf16_step_high": dict(zip(("dq", "dk", "dv"),
                                                fa.flash_attention_bwd(
                                                    q, k, v, out, dout, high,
                                                    causal=True,
                                                    window=window)))}
    read = {}
    for case, grads in cases.items():
        read[case] = {}
        for against, ref in refs.items():
            passes = True
            for name, e in zip(("dq", "dk", "dv"), ref):
                if name in grads:
                    mx, rel = _grad_err(grads[name], e)
                    read[case][f"{name}_vs_{against}"] = dict(
                        max_abs_err=mx, rel_norm_err=rel)
                    passes = passes and _grad_ok(grads[name], e, dtype,
                                                 against)
            check(not passes, f"flash_attention backward: a wrong gradient "
                  f"({case}) passes the check against the {against}: "
                  f"{read[case]}")
    return read


def _exact_bwd(torch, q, k, v, dout, chunk: int = 512):
    """(dq, dk, dv) of causal attention with T == S and no window,
    computed in fp64 from the inputs, ``chunk`` query rows at a time: the
    yardstick both fp32 backward routes are measured against."""
    B, Hq, T, D = q.shape
    G = Hq // k.shape[1]
    q, k, v, do = (t.double() for t in (q, k, v, dout))
    kk, vv = (torch.repeat_interleave(t, G, dim=1) for t in (k, v))
    scale = D ** -0.5
    dq, dk, dv = (torch.zeros_like(t) for t in (q, kk, vv))
    for q0 in range(0, T, chunk):
        q1 = min(T, q0 + chunk)
        s = q[:, :, q0:q1] @ kk[:, :, :q1].transpose(-1, -2) * scale
        later = (torch.arange(q1, device=q.device)[None, :]
                 > torch.arange(q0, q1, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
        del s
        delta = (do[:, :, q0:q1] * (p @ vv[:, :, :q1])).sum(-1, keepdim=True)
        ds = p * (do[:, :, q0:q1] @ vv[:, :, :q1].transpose(-1, -2) - delta)
        dq[:, :, q0:q1] = ds @ kk[:, :, :q1] * scale
        dk[:, :, :q1] += ds.transpose(-1, -2) @ q[:, :, q0:q1] * scale
        dv[:, :, :q1] += p.transpose(-1, -2) @ do[:, :, q0:q1]
        del p, ds
    return (dq, dk.view(B, -1, G, T, D).sum(2),
            dv.view(B, -1, G, T, D).sum(2))


def _sdpa_bwd_ms(torch, q, k, v, dout, window, iters, causal=True):
    """The backward alone of PyTorch's fused attention on the same inputs,
    through ``torch.autograd.grad`` (a yardstick the port never calls):
    (ms, its gradients)."""
    import torch.nn.functional as F

    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    T, S = q.shape[2], k.shape[2]
    if not causal and window is None:
        out = F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    elif window is None and T == S:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
    else:
        qpos = torch.arange(T, device="cuda")[:, None] + S - T
        kpos = torch.arange(S, device="cuda")[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             enable_gqa=True)
    def call():
        return torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    return time_ms(torch, call, iters, warmup=2), call()


def phase_attention_bwd(torch, fwd_path_ms):
    """B4', the attention backward, against its plain version (from the
    same forward output and log-sum-exps) and against autograd of the
    plain attention in fp32 on the same inputs, at ``BWD_SHAPES``; timings
    beside the bound and SDPA's backward; then the forward at the
    attention phase's serve shape with and without the lse output."""
    from repro_torch.kernels import flash_attention as fa

    results = {}
    gen = torch.Generator(device="cuda")
    for shape, s in BWD_SHAPES.items():
        dtype = getattr(torch, s["dtype"])
        gen.manual_seed(11)
        B, Hq, Hkv, T, S, D, w, c = (s[n] for n in (
            "B", "Hq", "Hkv", "T", "S", "D", "window", "causal"))
        q = torch.randn((B, Hq, T, D), generator=gen, device="cuda",
                        dtype=dtype)
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda",
                        dtype=dtype)
        v = torch.randn(k.shape, generator=gen, device="cuda", dtype=dtype)
        dout = torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)
        scale = D ** -0.5
        lse = torch.empty((B, Hq, T), dtype=torch.float32, device="cuda")
        out = fa.flash_attention_cuda(q, k, v, causal=c, window=w,
                                      scale=scale, lse=lse)
        route = fa.flash_bwd_route(dtype)
        check(route == ("tc" if s["dtype"] == "bfloat16" else "simt"),
              f"flash_attention backward {shape}: {s['dtype']} at D = {D} "
              f"takes the {route} route")
        before = fa.BWD_DISPATCHES.kernel_launches
        by_route = fa.BWD_ROUTE_LAUNCHES[route]
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=c,
                                     window=w)
        torch.cuda.synchronize()
        check(fa.BWD_DISPATCHES.kernel_launches == before + 1
              and fa.BWD_ROUTE_LAUNCHES[route] == by_route + 1,
              f"flash_attention backward {shape}: not on the kernel's "
              f"{route} route")
        want = fa.attention_bwd_ref(q, k, v, out, dout, lse, causal=c,
                                    window=w)
        # autograd of the plain attention, in fp32 on the same values
        leaves_ = [t.float().requires_grad_() for t in (q, k, v)]
        exact = torch.autograd.grad(
            fa.attention_ref(*leaves_, causal=c, window=w), leaves_,
            dout.float())
        del leaves_
        errs, auto_errs, rel_errs = [], [], {}
        for name, g, p, e in zip(("dq", "dk", "dv"), got, want, exact):
            check(bool(torch.isfinite(g).all()),
                  f"flash_attention backward {shape}: {name} not finite")
            for ref, what, tag, into in (
                    (p, "plain version", "plain", errs),
                    (e, "fp32 autograd", "autograd", auto_errs)):
                mx, rel = _grad_err(g, ref)
                into.append(mx)
                rel_errs[f"{name}_vs_{tag}"] = rel
                check(_grad_ok(g, ref, s["dtype"], tag),
                      f"flash_attention backward {shape} {name} against the "
                      f"{what}: max abs err {mx}, relative in norm {rel}")
        again = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=c,
                                       window=w)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention backward {shape}: two calls differ")
        fp64 = None
        if s["dtype"] == "float32" and c and w is None and T == S:
            # both fp32 routes against fp64: the kernel's sums over a
            # key's G x T rows must land no further from it than twice
            # the plain version's
            fp64 = {}
            for name, g, p, e in zip(("dq", "dk", "dv"), got, want,
                                     _exact_bwd(torch, q, k, v, dout)):
                fp64[name] = dict(
                    kernel=float((g.double() - e).abs().max()),
                    plain=float((p.double() - e).abs().max()))
                check(fp64[name]["kernel"] <= 2 * fp64[name]["plain"],
                      f"flash_attention backward {shape} {name}: "
                      f"{fp64[name]} from fp64")
        wrong = (_wrong_bwd(torch, fa, q, k, v, out, dout, lse, w,
                            dict(plain=want, autograd=exact), s["dtype"])
                 if shape == "path" else None)
        # the library's own gradients against the plain version, in norm
        iters = 3 if shape == "path" else 5
        lib_ms, lib = _sdpa_bwd_ms(torch, q, k, v, dout, w, iters, c)
        lib_errs = {f"{name}_vs_plain": _grad_err(g, p)[1]
                    for name, g, p in zip(("dq", "dk", "dv"), lib, want)}
        del exact, want, again, lib
        ops, nbytes = fa.flash_work(q, k, c, w, bwd=True)
        bound_ms, bound_by = _bound(nbytes, ops, s["dtype"])
        res = dict(shape=f"B={B},Hq={Hq},Hkv={Hkv},T={T},S={S},D={D},"
                   f"window={w},causal={c}", dtype=s["dtype"], route=route,
                   max_abs_err=max(errs),
                   max_abs_err_vs_fp32_autograd=max(auto_errs),
                   rel_norm_err=rel_errs,
                   bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                   bytes=nbytes)
        res["ms"] = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, dout, lse, causal=c, window=w), iters, warmup=1)
        res["device_ms"] = graph_ms(torch, lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, dout, lse, causal=c, window=w, scale=scale),
            iters)
        res["plain_ms"] = time_ms(torch, lambda: fa.attention_bwd_ref(
            q, k, v, out, dout, lse, causal=c, window=w), 2, warmup=1)
        res["library_ms"] = lib_ms
        res["library_rel_norm_err"] = lib_errs
        if fp64 is not None:
            res["max_abs_err_vs_fp64"] = fp64
        if wrong is not None:
            res["wrong_gradients_rejected"] = wrong
            # where the device time goes: ms a call by kernel
            by_name, _ = _trace(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k, v, out, dout, lse, causal=c, window=w, scale=scale),
                iters)
            names = {n: re.search(r"attn_bwd_\w+(<[^>]*>)?", n)
                     for n in by_name}
            res["device_ms_by_kernel"] = {
                names[n].group(0) if names[n] else n[:60]: us / 1e3 / iters
                for n, us in by_name.items()}
        results[shape] = res
        say(f"[kernel] flash_attention backward {shape} {s['dtype']}: "
            f"{json.dumps(res)}")

    # the forward at the attention phase's serve shape: the serve route
    # (no lse), as that phase timed it, and the training route (lse
    # written)
    gen.manual_seed(7)
    s = FLASH_SHAPES["path"]
    q = torch.randn((s["B"], s["Hq"], s["T"], s["D"]), generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    k = torch.randn((s["B"], s["Hkv"], s["S"], s["D"]), generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    v = torch.randn(k.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
    scale = s["D"] ** -0.5
    serve = graph_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, window=None, scale=scale), 20)
    train = graph_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, window=None, scale=scale, lse=lse), 20)
    want = fa.attention_lse_ref(q, k, causal=True)
    lse_err = float((lse - want).abs().max())
    check(lse_err <= 1e-3, f"flash_attention lse: max abs err {lse_err}")
    fwd = dict(shape="B=1,Hq=32,Hkv=16,T=1536,S=1536,D=128,bf16",
               serve_device_ms_attention_phase=fwd_path_ms,
               serve_device_ms=serve, with_lse_device_ms=train,
               lse_max_abs_err=lse_err)
    say(f"[kernel] flash_attention forward at the serve shape: "
        f"{json.dumps(fwd)}")
    return results


# ------------------------------------------------------- scan backward
# B6', the scan's backward, at the SSM training path's shape
# (falcon-mamba-7b: d_inner 8,192, state 16, one 4,096-token sequence), at
# jamba-1.5-large-398b's width (d_inner 16,384), a T that does not fill a
# chunk of 32, and the smoke models' state of 8 at B = 2; each in fp32
# and in bf16, the path's type.
MAMBA_BWD_SHAPES = {
    "path": dict(B=1, T=4096, D=8192, N=16),
    "jamba": dict(B=1, T=4096, D=16384, N=16),
    "ragged": dict(B=1, T=63, D=1024, N=16),
    "n8": dict(B=2, T=777, D=512, N=8),
}
# B6''s tolerances against its plain version, by dtype: elementwise
# |g - ref| <= atol + share * max |ref| + rtol * |ref|, as (rtol, atol,
# share), and the largest ||g - ref|| / ||ref||.  fp32: rtol 1e-4 with an
# atol of 1e-5 of the gradient's largest entry, and 1e-5 in norm.  The
# atol scales with the gradient because at T = 4,096 the sums reach
# |ddelta| ~ 270 and |dD| ~ 250, where one fp32 rounding is ~3e-5, and
# ddelta's entries are sums over the states that cancel: the kernel's
# exps are ex2.approx (the forward's) and the plain version's torch.exp,
# so a small entry carries the rounding of its large terms.  Each shape
# also reports how many entries an absolute 1e-5 (+ rtol 1e-4) would
# reject (``over_atol_1e-5``).  bf16 (inputs and dx, ddelta, dB, dC
# rounded to bf16, both versions summing in fp32): B4''s elementwise two
# bf16 steps (rtol 1.6e-2) above 1e-3, and 5e-4 in norm, set from the
# readings in PERF.md section 6; a wrong gradient reads far above both.
# The plain version against fp32 autograd of the plain scan (one
# recurrence, summed in another order): rtol 1e-4 / atol 1e-5.
MAMBA_BWD_TOL = {"float32": ((1e-4, 0.0, 1e-5), 1e-5),
                 "bfloat16": ((1.6e-2, 1e-3, 0.0), 5e-4)}
MAMBA_GRADS = ("dx", "ddelta", "dA", "dB", "dC", "dD")


def _scan_grad_ok(g, ref, dtype: str) -> bool:
    (rtol, atol, share), rel = MAMBA_BWD_TOL[dtype]
    g, w = g.double(), ref.double()
    bound = atol + share * float(w.abs().max()) + rtol * w.abs()
    close = bool(((g - w).abs() <= bound).all())
    return close and _grad_err(g, w)[1] <= rel


def _wrong_scan_bwd(torch, ms, args, dy, got, want, dtype: str, cut: int,
                    where: str):
    """What a wrong gradient reads: the kernel's with the carry
    ``a_{cut} g_{cut}`` into ``g_{cut-1}`` dropped, i.e. dx, ddelta, dB
    and dC of steps 0..cut-1 replaced by the kernel's gradients of those
    steps taken alone.  The check must reject it."""
    head = [a[:, :cut].contiguous() if a.dim() == 3 else a for a in args]
    _, _, edges = ms.mamba_scan_cuda(*head, with_edges=True)
    alone = ms.mamba_scan_bwd_cuda(*head, dy[:, :cut].contiguous(), edges)
    wrong = [g.clone() for g in got]
    for i in (0, 1, 3, 4):
        wrong[i][:, :cut] = alone[i]
    read, passes = {"cut": cut}, True
    for name, g, w in zip(MAMBA_GRADS, wrong, want):
        mx, rel = _grad_err(g, w)
        read[name] = dict(max_abs_err=mx, rel_norm_err=rel)
        passes = passes and _scan_grad_ok(g, w, dtype)
    check(not passes, f"mamba_scan backward: a wrong gradient (the carry "
          f"dropped at {where}, step {cut}) passes the check: {read}")
    return read


SCAN_BWD_LAUNCHES = {"carry": "mamba_scan_bwd_carry_kernel",
                     "main": "mamba_scan_bwd_kernel",
                     "reduce": "mamba_scan_bwd_reduce_kernel"}


def _scan_bwd_launch_ms(torch, fn, iters: int):
    """Device ms of each of B6''s launches (``SCAN_BWD_LAUNCHES``), the
    mean over the launches a ``torch.profiler`` trace of ``iters`` calls
    of ``fn`` holds, and how many it holds of each (a trace can miss its
    first calls' kernels); None when the profiler fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        say(f"mamba_scan backward launches: not measured ({e})")
        return None
    try:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except RuntimeError as e:
            say(f"mamba_scan backward launches: not measured ({e})")
            prof = None
    if prof is None:
        return None
    total, seen = (dict.fromkeys(SCAN_BWD_LAUNCHES, 0) for _ in range(2))
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for launch, kernel in SCAN_BWD_LAUNCHES.items():
            if kernel in ev.name:  # no one name holds another
                total[launch] += ev.time_range.elapsed_us() / 1e3
                seen[launch] += 1
    return {launch: total[launch] / max(1, seen[launch])
            for launch in SCAN_BWD_LAUNCHES}, seen


def phase_mamba_bwd(torch):
    """B6', the scan's backward (carry, gradient and sums, on the plan of
    ``kernel.bwd_plan``), from the forward's train variant's edges,
    against its plain version and (fp32) the plain version against
    autograd of the plain scan, at ``MAMBA_BWD_SHAPES``; two wrong
    gradients (the carry dropped at the first 32-step chunk edge and at
    the first segment's end) rejected at each; timings of each launch
    (a profiler trace) beside the bound, the exps' floor and the train
    variant's and serve launch's times."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels.mamba_scan import kernel as mk

    results = {}
    for shape, s0 in MAMBA_BWD_SHAPES.items():
        for dname in ("float32", "bfloat16"):
            s = dict(s0, dtype=dname)
            B, T, D, N = s["B"], s["T"], s["D"], s["N"]
            plan = mk.bwd_plan(B, T, D, N)
            args = mamba_inputs(torch, s, seed=21)
            gen = torch.Generator(device="cuda").manual_seed(5)
            dy = torch.randn(args[0].shape, generator=gen,
                             device="cuda").to(args[0].dtype)
            y0, h0 = ms.mamba_scan_cuda(*args)
            y1, h1, edges = ms.mamba_scan_cuda(*args, with_edges=True)
            check(torch.equal(y0, y1) and torch.equal(h0, h1),
                  f"mamba_scan {shape} {dname}: the train variant changes "
                  "the serve outputs")
            check(tuple(edges.shape) == mk.edges_shape(B, T, D, N),
                  f"mamba_scan {shape}: edges {tuple(edges.shape)}")
            before = ms.BWD_DISPATCHES.kernel_launches
            got = ms.mamba_scan_bwd(*args, dy, edges)
            torch.cuda.synchronize()
            check(ms.BWD_DISPATCHES.kernel_launches == before + 1,
                  f"mamba_scan backward {shape}: not on the kernel")
            check([g.dtype for g in got] == [a.dtype for a in args],
                  f"mamba_scan backward {shape}: gradients in "
                  f"{[g.dtype for g in got]}")
            want = ms.mamba_scan_bwd_ref(*args, dy)
            errs, rels, over = {}, {}, {}
            for name, g, w in zip(MAMBA_GRADS, got, want):
                check(bool(torch.isfinite(g).all()),
                      f"mamba_scan backward {shape} {dname}: {name} not finite")
                errs[name], rels[name] = _grad_err(g, w)
                over[name] = int(((g.double() - w.double()).abs()
                                  > 1e-5 + 1e-4 * w.double().abs()).sum())
                check(_scan_grad_ok(g, w, dname),
                      f"mamba_scan backward {shape} {dname} {name}: max abs "
                      f"err {errs[name]}, relative in norm {rels[name]}, "
                      f"largest entry {float(w.abs().max())}")
            again = ms.mamba_scan_bwd_cuda(*args, dy, edges)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"mamba_scan backward {shape} {dname}: two calls differ")
            res = dict(shape=f"B={B},T={T},D={D},N={N}",
                       dtype=dname, plan=plan._asdict(),
                       max_abs_err=max(errs.values()),
                       max_abs_err_by_grad=errs, rel_norm_err=rels,
                       **{"over_atol_1e-5": over},
                       max_abs_ref={n: float(w.abs().max())
                                    for n, w in zip(MAMBA_GRADS, want)})
            if dname == "float32" and shape != "jamba":
                # the plain version against autograd of the plain scan
                leaves_ = [a.detach().clone().requires_grad_() for a in args]
                exact = torch.autograd.grad(
                    ms.mamba_scan_ref(*leaves_)[0], leaves_, dy)
                auto = {}
                for name, w, e in zip(MAMBA_GRADS, want, exact):
                    auto[name] = _grad_err(w, e)[0]
                    check(bool(((w - e).abs() <= 1e-5 + 1e-4 * e.abs()).all()),
                          f"mamba_scan_bwd_ref {shape} {name} against fp32 "
                          f"autograd: max abs err {auto[name]}")
                res["plain_vs_fp32_autograd_max_abs_err"] = auto
                del exact, leaves_
            # two wrong gradients, each rejected: the carry dropped at the
            # first 32-step chunk edge, and at the first segment's end
            check(plan.n_seg > 1, f"mamba_scan backward {shape}: one segment")
            res["wrong_gradient_rejected"] = {
                where: _wrong_scan_bwd(torch, ms, args, dy, got, want, dname,
                                       cut, where)
                for where, cut in (("chunk edge", 32),
                                   ("segment end", plan.seg_len))}
            n_edges = edges.shape[1]
            ops, nbytes = ms.scan_work(args[0], N, bwd=True,
                                       edges=edges.numel())
            bound_ms, bound_by = _bound(nbytes, ops, "float32")
            blocks, threads, smem = mk.bwd_occupancy(N, args[0].dtype)
            # by the plan's arithmetic, not measured
            exps = plan.exps_per_state_step(T)
            res.update(bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                       # the earlier count, an FMA as one operation
                       ops_before=B * T * D * (18 * N + 5),
                       bytes=nbytes, n_edges=n_edges,
                       # one exp a state element and step (a_t, needed by
                       # the forward's states and by g)
                       sfu_ms=B * T * D * N / SFU_EX2_PER_S * 1e3,
                       plan_exps_per_state_step=exps,
                       sfu_ms_at_plan_exps=exps * B * T * D * N
                       / SFU_EX2_PER_S * 1e3,
                       resident_blocks_per_sm=blocks, threads_per_block=threads,
                       smem_per_block=smem,
                       resident_warps_per_sm=blocks * threads // 32)
            big = shape in ("path", "jamba")
            iters = 5 if big else 20
            res["ms"] = time_ms(torch, lambda: ms.mamba_scan_bwd(
                *args, dy, edges), iters, warmup=1)
            res["device_ms"] = graph_ms(torch, lambda: ms.mamba_scan_bwd_cuda(
                *args, dy, edges), iters)
            res["device_ms_by_launch"], res["traced_launches"] = (
                _scan_bwd_launch_ms(torch, lambda: ms.mamba_scan_bwd_cuda(
                    *args, dy, edges), iters) or (None, None))
            res["train_forward_device_ms"] = graph_ms(
                torch, lambda: ms.mamba_scan_cuda(*args, with_edges=True),
                iters)
            res["serve_forward_device_ms"] = graph_ms(
                torch, lambda: ms.mamba_scan_cuda(*args), iters)
            # the plain version loops over T on the host: one call at the
            # long shapes
            res["plain_ms"] = time_ms(torch, lambda: ms.mamba_scan_bwd_ref(
                *args, dy), 1 if big else 2, warmup=0 if big else 1)
            results[(shape, dname)] = res
            say(f"[kernel] mamba_scan backward {shape} {dname}: "
                f"{json.dumps(res)}")
            del got, want, again, edges
            torch.cuda.empty_cache()
    return results


# --------------------------------------------------------- training path
TRAIN_ARCH = "minitron-4b"
TRAIN_STEPS = 4  # a warm-up, two timed steps, one profiled


def _host_gb():
    """The process's peak resident set, GB (``ru_maxrss`` is in KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _count_attention(fa):
    """The forward's and the backward's counts, then their launches by
    route."""
    return (fa.DISPATCHES.snapshot(), fa.BWD_DISPATCHES.snapshot(),
            dict(fa.ROUTE_LAUNCHES), dict(fa.BWD_ROUTE_LAUNCHES))


def _reset_attention(fa):
    fa.DISPATCHES.reset()
    fa.BWD_DISPATCHES.reset()
    for counts in (fa.ROUTE_LAUNCHES, fa.BWD_ROUTE_LAUNCHES):
        for route in counts:
            counts[route] = 0


def _reset_scan(ms):
    ms.DISPATCHES.reset()
    ms.BWD_DISPATCHES.reset()
    for name in ms.DTYPE_LAUNCHES:
        ms.DTYPE_LAUNCHES[name] = 0


def _trace_busy(torch, fn, what: str):
    """Run ``fn`` once (no warm-up call) under ``torch.profiler``: (device
    ms, wall ms, device ms by kernel class, the ten kernels of most device
    ms), or None when the profiler fails to start or to stop.  A failure
    of ``fn`` itself propagates."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        say(f"{what} profile: not measured ({e})")
        fn()
        return None
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        try:
            prof.stop()
        except RuntimeError as e:
            say(f"{what} profile: not measured ({e})")
            prof = None
    if prof is None:
        return None
    classes, by_name = {}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            c = _kernel_class(ev.name)
            classes[c] = classes.get(c, 0.0) + ms
            by_name[ev.name[:80]] = by_name.get(ev.name[:80], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return sum(classes.values()), wall * 1e3, classes, top


def timed_steps(torch, step, n: int, what: str):
    """``n`` calls of ``step``, each timed on the host clock between two
    synchronisations, the last one under ``_trace_busy``: (ms a step, the
    trace or None)."""
    step_ms, trace = [], None
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n - 1:
            trace = _trace_busy(torch, step, what)
        else:
            step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return step_ms, trace


def trace_stats(trace) -> dict:
    """A profiled step's device ms, wall ms, busy share, device ms by class
    and top kernels, for a path's metrics (none when it was not traced)."""
    if trace is None:
        return {}
    device_ms, wall_ms, classes, top = trace
    return dict(traced_device_ms=device_ms, traced_wall_ms=wall_ms,
                device_busy_share=device_ms / wall_ms,
                device_ms_by_class=classes, top_kernels_ms=top)


def _reached_params(cfg, params) -> int:
    """The held parameters a token reaches: all but the ``E - K`` experts
    of each MoE layer that it is not routed to."""
    from repro_torch.tree import leaves

    n = sum(t.numel() for t in leaves(params))
    if cfg.n_experts:
        E, K = cfg.n_experts, cfg.experts_per_token
        n -= sum(layer["ffn"][name].numel() * (E - K) // E
                 for layer in params["layers"] if "router" in layer["ffn"]
                 for name in ("e_gate", "e_up", "e_down"))
    return n


def phase_train(torch, np):
    """The training path: ``FTTrainer`` on the full ``minitron-4b`` (32
    layers, d_model 3072, bf16, fp32 AdamW moments, remat)."""
    return train_full_model(torch, np, TRAIN_ARCH)[1:3]


def phase_moe_train(torch, np):
    """The MoE training path: ``FTTrainer`` on the full
    ``granite-moe-1b-a400m`` (24 layers, d_model 1024, 32 experts top 8,
    bf16, fp32 AdamW moments, remat)."""
    return train_full_model(torch, np, MOE_ARCH)[1:3]


# falcon-mamba-7b's depth cut from 64 layers for training: a layer holds
# 105.3 M parameters, the untied embedding and head 0.53 B, and bf16
# weights, fp32 moments, the gradient sum and one host's fresh gradients
# take 14 bytes a parameter before activations, so the whole model (7.27
# B) would need ~100 GB.  At 32 layers (3.90 B) the step peaked at 55.17
# GB on an H100 80GB HBM3, under 56 GB, so the cut is 40 layers (4.74 B;
# 66.98 GB peak there, PERF.md section 4)
SSM_TRAIN_LAYERS = 40


def phase_ssm_train(torch, np):
    """The SSM training path: ``FTTrainer`` on ``falcon-mamba-7b`` at full
    width (d_model 4,096, d_inner 8,192, state 16, dt_rank 256, vocab
    65,024, bf16, fp32 AdamW moments, remat), its depth cut to
    ``SSM_TRAIN_LAYERS``; then two ``grad_step``s of the model at full
    width and 2 layers on one 4,096-token sequence under the trainer's
    enforced deterministic algorithms, whose gradients must be
    bit-equal."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import build_model
    from repro_torch.runtime.ft import deterministic
    from repro_torch.tree import leaves

    _, _, _, scan_fwd, scan_bwd = train_full_model(
        torch, np, SSM_ARCH, n_layers=SSM_TRAIN_LAYERS)
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=2)
    model = build_model(cfg, "cuda")
    params = model.init(0)
    tok = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 4097)), dtype=torch.int32, device="cuda")
    runs = []
    ms.BWD_DISPATCHES.reset()
    for _ in range(2):
        with deterministic(torch.device("cuda")):
            loss, grads = model.grad_step(params, {"tokens": tok})
            runs.append((loss, grads))
    torch.cuda.synchronize()
    check(ms.BWD_DISPATCHES.kernel_launches == 2 * cfg.n_layers,
          f"the deterministic grad steps' scan backward: "
          f"{vars(ms.BWD_DISPATCHES)}")
    (l0, g0), (l1, g1) = runs
    same = torch.equal(l0, l1) and all(
        torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    check(same, f"{SSM_ARCH} (full width, 2 layers): two grad_steps under "
          "deterministic algorithms differ")
    say(f"[train {SSM_ARCH}] full width, 2 layers, 4,096 tokens: two "
        f"grad_steps under enforced deterministic algorithms: loss "
        f"{float(l0):.6f}, {len(leaves(g0))} gradient leaves bit-equal")
    del model, params, runs, g0, g1
    gc.collect()
    torch.cuda.empty_cache()
    return scan_fwd, scan_bwd


def reckon_train_state(cfg, params, grads: int):
    """GB of a training step's state, reckoned before the first step from
    the held leaves: bf16 parameters, the moments of
    ``cfg.optimizer_moments`` (fp32 m and v; or bf16 m and fp32 row and
    column means of v for a factored leaf, a whole fp32 v for the others),
    ``grads`` bf16 gradient trees alive at once, and the fp32 temporaries
    of one leaf's update (at most three copies of the largest leaf, which
    ``adamw_update`` updates one at a time)."""
    from repro_torch.train.optimizer import _factored
    from repro_torch.tree import leaves

    held = leaves(params)
    n = sum(t.numel() for t in held)
    if cfg.optimizer_moments == "factored":
        moments = sum(2 * t.numel() + (4 * (t.numel() // t.shape[-1]
                                            + t.numel() // t.shape[-2])
                                       if _factored(t) else 4 * t.numel())
                      for t in held)
    else:
        moments = (8 if cfg.optimizer_moments == "fp32" else 4) * n
    out = dict(params_gb=2 * n / 1e9, moments_gb=moments / 1e9,
               grads_gb=2 * grads * n / 1e9,
               update_temporaries_gb=3 * 4 * max(t.numel() for t in held)
               / 1e9)
    out["total_gb_before_activations"] = sum(out.values())
    return out


def factored_moments(torch, params, opt) -> dict:
    """The factored leaves' ``v_row`` / ``v_col`` after training: every
    entry finite and at least 0, and each above 0 somewhere (a row of
    the embedding whose token was never drawn keeps 0)."""
    from repro_torch.tree import subtrees_up_to

    mu = [st for st in subtrees_up_to(params, opt["mu"]) if "v_row" in st]
    check(bool(mu), "no leaf holds factored moments")
    for st in mu:
        for name in ("v_row", "v_col"):
            t = st[name]
            check(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
                  and bool((t >= 0).all()) and bool((t > 0).any()),
                  f"a factored {name} of shape {tuple(t.shape)} was not "
                  "updated")
    return dict(factored_leaves=len(mu),
                v_row_entries=sum(st["v_row"].numel() for st in mu),
                v_col_entries=sum(st["v_col"].numel() for st in mu),
                v_row_nonzero_share=sum(int((st["v_row"] > 0).sum())
                                        for st in mu)
                / sum(st["v_row"].numel() for st in mu))


def train_full_model(torch, np, arch: str, n_layers=None):
    """``FTTrainer`` on the full ``arch`` (its depth cut to ``n_layers``
    where given) with random weights from seed 0, two simulated hosts of
    one 4,096-token sequence each, 4 steps (rates over the two warm
    unprofiled ones); every attention and scan forward and backward on
    the kernels.  ``mfu`` counts the parameters a token reaches
    (``ModelConfig.n_active_params``: an MoE layer's routed experts only),
    held against a count of the held leaves.  Returns (the path's
    metrics, the attention forward's and backward's counts, the scan's
    forward and backward counts)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.runtime.ft import FTConfig, FTTrainer

    cfg = get_config(arch)
    cut = ""
    if n_layers is not None:
        cut = f" (depth cut from {cfg.n_layers})"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_attn, n_mamba = _mixers(cfg)
    ft = FTConfig(n_hosts=2, global_batch=2, seq_len=4096,
                  ckpt_every=TRAIN_STEPS + 1)
    tokens = ft.global_batch * ft.seq_len
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = FTTrainer(cfg, ft, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    from repro_torch.tree import leaves
    n = sum(t.numel() for t in leaves(tr.state.params))
    reached = _reached_params(cfg, tr.state.params)
    active = cfg.n_active_params()
    # (ModelConfig counts three FFN matrices, where relu2 holds two: the
    # counts agree for the gated MoE models, not for minitron-4b)
    check(not cfg.n_experts or abs(reached - active) <= 1e-3 * active,
          f"{arch}: a token reaches {reached} held parameters, "
          f"ModelConfig.n_active_params() says {active}")
    reckoned = reckon_train_state(cfg, tr.state.params, grads=2)
    mixers = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
              f"d_ff {cfg.d_ff} ({cfg.hidden_act})" if n_attn else
              f"{n_mamba} Mamba mixers of d_inner {cfg.d_inner}, state "
              f"{cfg.ssm_state}, dt_rank {cfg.dt_rank}")
    say(f"[train {arch}] {cfg.n_layers} layers{cut}, d_model {cfg.d_model}, "
        f"{mixers}, vocab {cfg.vocab_size} "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, "
        f"{cfg.dtype}, {cfg.optimizer_moments} moments, remat={cfg.remat}; "
        f"{n} parameters held (ModelConfig.n_params: {cfg.n_params()}), "
        f"{reached} of them reached by a token (n_active_params: "
        f"{active}); "
        f"global batch cut from train_4k's 256 to "
        f"{ft.global_batch} ({ft.n_hosts} hosts x 1 x {ft.seq_len} tokens); "
        f"reckoned: {json.dumps(reckoned)}")

    _reset_attention(fa)
    _reset_scan(ms)
    losses = []
    step_ms, trace = timed_steps(torch, lambda: losses.extend(
        tr.train_steps(1)), TRAIN_STEPS, f"[train {arch}]")
    fwd, bwd, routes, bwd_routes = _count_attention(fa)
    scan_fwd, scan_bwd = ms.DISPATCHES.snapshot(), ms.BWD_DISPATCHES.snapshot()
    scan_dtypes = dict(ms.DTYPE_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    factored = (factored_moments(torch, tr.state.params, tr.state.opt)
                if cfg.optimizer_moments == "factored" else None)

    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"{arch} training losses {losses}")
    per_layer = ft.n_hosts * TRAIN_STEPS
    want_scan_bwd = n_mamba * per_layer
    want_scan_fwd = 2 * want_scan_bwd if cfg.remat else want_scan_bwd
    check(scan_bwd.launches == scan_bwd.kernel_launches == want_scan_bwd,
          f"mamba_scan backward launches {vars(scan_bwd)} != {want_scan_bwd}")
    check(scan_fwd.launches == scan_fwd.kernel_launches == want_scan_fwd,
          f"mamba_scan forward launches {vars(scan_fwd)} != {want_scan_fwd}")
    check(scan_dtypes == {"float32": 0, "bfloat16": want_scan_fwd},
          f"mamba_scan launches by input type {scan_dtypes}")
    want_bwd = n_attn * per_layer
    want_fwd = 2 * want_bwd if cfg.remat else want_bwd
    check(bwd.launches == bwd.kernel_launches == want_bwd,
          f"flash_attention backward launches {vars(bwd)} != {want_bwd}")
    check(fwd.launches == fwd.kernel_launches == want_fwd,
          f"flash_attention forward launches {vars(fwd)} != {want_fwd}")
    check(routes == {"tc": want_fwd, "simt": 0},
          f"flash_attention launches by route {routes}")
    check(bwd_routes == {"tc": want_bwd, "simt": 0},
          f"flash_attention backward launches by route {bwd_routes}: every "
          f"bf16 backward at the training shape must take the tensor cores")
    # model FLOPs: 6 x parameters x tokens, plus causal attention (4
    # flops a visible pair and head dim in the forward, twice that back);
    # an MoE model counts the parameters a token reaches
    attn = 12 * n_attn * cfg.n_heads * cfg.head_dim \
        * fa.visible_pairs(ft.seq_len, ft.seq_len, None) * ft.global_batch
    flops = 6 * (active if cfg.n_experts else n) * tokens + attn
    timed = step_ms[1:-1]  # warm and unprofiled
    warm = sum(timed) / len(timed)
    stats = dict(
        steps=TRAIN_STEPS, losses=losses, step_ms=step_ms,
        traced_step=TRAIN_STEPS, timed_steps=len(timed), warm_step_ms=warm,
        warm_step_ms_spread=[min(timed), max(timed)], n_params=n,
        n_params_reached=reached, n_active_params=active,
        tokens_per_step=tokens, tokens_per_s=tokens / warm * 1e3,
        model_flops_per_step=flops,
        mfu=flops / (warm / 1e3) / PEAK_BF16_OPS_PER_S,
        init_s=t_init, state_gb=state_gb, peak_gb=peak_gb,
        host_peak_rss_gb=_host_gb(),
        flash_forward=vars(fwd), flash_backward=vars(bwd),
        flash_backward_routes=bwd_routes,
        expected_forward=want_fwd, expected_backward=want_bwd,
        scan_forward=vars(scan_fwd), scan_backward=vars(scan_bwd),
        expected_scan_forward=want_scan_fwd,
        expected_scan_backward=want_scan_bwd, reckoned=reckoned,
        **({"factored_moments": factored} if factored else {}))
    stats.update(trace_stats(trace))
    say(f"[train {arch}] trained: {json.dumps(stats)}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return stats, fwd, bwd, scan_fwd, scan_bwd


def phase_ft(torch, np):
    """The launcher's fault-tolerance flow at full width, 2 layers, with
    ``test_ft.py``'s crash-restore ``FTConfig`` at 4,096 tokens, its
    checkpoint every 2 steps (cut from 4, and the steps from 8 + 8 to
    4 + 4, to pay for the dry-run phases): an uninterrupted run of 4
    steps that saves no checkpoint (a save is some 20 s of host copies
    and reads the state only); then 2 steps (checkpoint at step 2),
    checkpoint host 1 crashes, a restarted fleet restores from the
    surviving replicas and trains 2 more, saving nothing (no later step
    reads a save); the losses must equal the uninterrupted run's within
    rtol 1e-5."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.runtime.ft import FTConfig, FTTrainer

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    ft = FTConfig(n_hosts=3, global_batch=6, seq_len=4096, ckpt_every=2)
    say(f"[ft {TRAIN_ARCH}] full width, depth cut from 32 to 2 layers "
        "(BigStore keeps every shard's bytes on the host: the tied "
        "embedding with its fp32 moments is 7.9 GB alone, the 2-layer "
        "state 9.5 GB, and each save writes a new version of it); "
        f"FTConfig {json.dumps(dataclasses.asdict(ft))}")
    saves = []

    def timed_checkpoints(tr):
        save = tr.checkpoint

        def checkpoint():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save()
            saves.append(time.perf_counter() - t0)
            return out
        tr.checkpoint = checkpoint
        return tr

    t0 = time.perf_counter()
    ref = FTTrainer(cfg, dataclasses.replace(ft, ckpt_every=10**9),
                    device="cuda")
    ref_losses = ref.train_steps(4)
    del ref
    gc.collect()
    tr = timed_checkpoints(FTTrainer(cfg, ft, device="cuda"))
    losses_a = tr.train_steps(2)
    check(len(saves) == 1, "no checkpoint at step 2")
    tr.crash_host(1)
    store = tr.store
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # the continuation saves nothing: no later step reads a save
    tr2 = FTTrainer(cfg, dataclasses.replace(ft, ckpt_every=10**9),
                    device="cuda")
    tr2.store = store
    t1 = time.perf_counter()
    step = tr2.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    check(step == 2, f"restored at step {step}, not 2")
    losses_b = tr2.train_steps(2)
    got = losses_a + losses_b
    err = max(abs(a - b) / abs(b) for a, b in zip(got, ref_losses))
    check(all(np.isfinite(ref_losses)) and err <= 1e-5,
          f"restored run {got} != uninterrupted {ref_losses} (rel {err})")
    stats = dict(layers=cfg.n_layers, losses=got, uninterrupted=ref_losses,
                 max_rel_err=err, bit_equal=got == ref_losses,
                 save_s=saves, restore_s=restore_s,
                 store_total_bytes=store.total_bytes(),
                 alive_ckpt_hosts=sum(h.alive for h in store.hosts),
                 host_peak_rss_gb=_host_gb(),
                 wall_s=time.perf_counter() - t0)
    say(f"[ft {TRAIN_ARCH}] crash, restore, continue: {json.dumps(stats)}")
    del tr2, store
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_train_parity(torch, np):
    train_parity(torch, np, TRAIN_ARCH)


def _attention_calls(cfg) -> int:
    """Prefill-attention calls of one ``train`` forward without remat: a
    self-attention a layer with attention and, for an encoder-decoder fed
    frames, an encoder layer's self-attention and a decoder layer's
    cross-attention."""
    n = _mixers(cfg)[0]
    if cfg.is_encoder_decoder:
        n += cfg.n_encoder_layers + cfg.n_layers
    return n


def train_parity(torch, np, arch: str):
    """One ``train_step`` of the smoke ``arch`` (fp32) from the same state
    on cpu and on cuda (an encoder-decoder fed seeded frames): the loss
    within 1e-4, every parameter after the step within rtol 1e-4 / atol
    1e-5; the cuda step's attention and scans on the kernels."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, map_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    state = cpu.init_train_state(0)
    gstate = map_tree(lambda t: t.to("cuda"), state)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (4, 65)), dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = torch.as_tensor(rng.standard_normal(
            (4, cfg.encoder_positions, cfg.d_model)), dtype=torch.float32)
    state, m_cpu = cpu.train_step(state, batch)
    _reset_attention(fa)
    _reset_scan(ms)
    gstate, m_gpu = gpu.train_step(gstate, tree_to(batch, "cuda"))
    torch.cuda.synchronize()
    fwd, bwd, _, _ = _count_attention(fa)
    n_attn, n_mamba = _attention_calls(cfg), _mixers(cfg)[1]
    check(all(c.kernel_launches == c.launches == n for c, n in (
        (fwd, n_attn), (bwd, n_attn), (ms.DISPATCHES, n_mamba),
        (ms.BWD_DISPATCHES, n_mamba))),
          f"the cuda smoke train step: attention forward {vars(fwd)}, "
          f"backward {vars(bwd)}; scan forward {vars(ms.DISPATCHES)}, "
          f"backward {vars(ms.BWD_DISPATCHES)}")
    loss_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
    check(loss_err <= 1e-4, f"train step loss: cpu {float(m_cpu['loss'])} "
          f"cuda {float(m_gpu['loss'])}")
    errs = []
    for a, b in zip(leaves(gstate.params), leaves(state.params)):
        a = a.cpu()
        errs.append(float((a - b).abs().max()))
        check(bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all()),
              f"a parameter after the train step differs by {errs[-1]}")
    say(f"[train parity] smoke {arch} fp32, one train_step: loss "
        f"{float(m_cpu['loss']):.6f} (cpu) vs {float(m_gpu['loss']):.6f} "
        f"(cuda), parameters within {max(errs):.3g}")


def deterministic_grad_steps(torch, np, arch: str):
    """Two ``grad_step``s of the smoke ``arch`` on cuda under the trainer's
    enforced deterministic algorithms: every op (the MoE dispatch's, the
    backward kernels') runs without raising, and the two give bit-equal
    gradients."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import build_model
    from repro_torch.runtime.ft import deterministic
    from repro_torch.tree import leaves

    cfg = smoke_config(arch)
    model = build_model(cfg, "cuda")
    params = model.init(0)
    tok = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 65)), dtype=torch.int32, device="cuda")
    _reset_attention(fa)
    _reset_scan(ms)
    runs = []
    for _ in range(2):
        with deterministic(torch.device("cuda")):
            runs.append(model.grad_step(params, {"tokens": tok}))
    torch.cuda.synchronize()
    _, bwd, _, _ = _count_attention(fa)
    n_attn, n_mamba = _mixers(cfg)
    check(bwd.kernel_launches == bwd.launches == 2 * n_attn
          and ms.BWD_DISPATCHES.kernel_launches
          == ms.BWD_DISPATCHES.launches == 2 * n_mamba,
          f"the deterministic grad steps' backward: attention {vars(bwd)}, "
          f"scan {vars(ms.BWD_DISPATCHES)}")
    (l0, g0), (l1, g1) = runs
    same = torch.equal(l0, l1) and all(
        torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    check(same, f"smoke {arch}: two grad_steps under deterministic "
          "algorithms differ")
    say(f"[train parity] smoke {arch}: two grad_steps on cuda under "
        f"enforced deterministic algorithms: loss {float(l0):.6f}, "
        f"{len(leaves(g0))} gradient leaves bit-equal")


def phase_moe_train_parity(torch, np):
    """``train_parity`` and ``deterministic_grad_steps`` of the smoke
    ``granite-moe-1b-a400m``."""
    train_parity(torch, np, MOE_ARCH)
    deterministic_grad_steps(torch, np, MOE_ARCH)


def phase_hybrid_parity(torch, np):
    """The smoke ``jamba-1.5-large-398b`` (fp32, its int8 cache kept):
    ``smoke_parity``, then ``train_parity`` and
    ``deterministic_grad_steps``, which run the scan's backward kernel,
    attention's and the MoE dispatch together."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    smoke_parity(torch, np, HYBRID_ARCH,
                 [fa.DISPATCHES, dec.DISPATCHES, ms.DISPATCHES])
    train_parity(torch, np, HYBRID_ARCH)
    deterministic_grad_steps(torch, np, HYBRID_ARCH)


# ------------------------------------------------------ encoder-decoder
ENCDEC_ARCH = "whisper-tiny"
WHISPER_REQUESTS = 32
WHISPER_PROMPT = 4        # tokens a prompt: Whisper's start-of-transcript prefix
WHISPER_BATCH = 256       # train_4k's global batch (configs/shapes.py)
WHISPER_TRAIN_STEPS = 4   # a warm-up, two timed steps, one profiled


class AttentionKinds(contextlib.AbstractContextManager):
    """While installed, the model's prefill-attention calls by kind, each
    as [calls, CUDA kernel launches, tensor-core launches]: ``encoder``
    (inside ``encoder_forward``), ``self`` (causal: the decoder's
    self-attention) and ``cross`` (not causal, outside the encoder); and
    the seconds spent in ``encoder_forward`` (synchronised on both
    sides).  It wraps the names the model looks up at call time,
    ``attention.flash_attention`` and ``transformer.encoder_forward``, and
    restores them on exit; the wrappers launch nothing themselves."""

    def __init__(self, torch):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models import attention, transformer

        self.torch, self.fa = torch, fa
        self.attention, self.transformer = attention, transformer
        self.counts = {k: [0, 0, 0] for k in ("encoder", "self", "cross")}
        self.encoder_s = 0.0
        self._in_encoder = False

    def _flash(self, q, k, v, *, causal=True, **kw):
        fa = self.fa
        kind = ("encoder" if self._in_encoder
                else "self" if causal else "cross")
        launched, tc = fa.DISPATCHES.kernel_launches, fa.ROUTE_LAUNCHES["tc"]
        out = self._real_flash(q, k, v, causal=causal, **kw)
        c = self.counts[kind]
        c[0] += 1
        c[1] += fa.DISPATCHES.kernel_launches - launched
        c[2] += fa.ROUTE_LAUNCHES["tc"] - tc
        return out

    def _encoder(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._in_encoder = True
        try:
            out = self._real_encoder(*args, **kw)
        finally:
            self._in_encoder = False
        self.torch.cuda.synchronize()
        self.encoder_s += time.perf_counter() - t0
        return out

    def __enter__(self):
        self._real_flash = self.attention.flash_attention
        self._real_encoder = self.transformer.encoder_forward
        self.attention.flash_attention = self._flash
        self.transformer.encoder_forward = self._encoder
        return self

    def __exit__(self, *exc):
        self.attention.flash_attention = self._real_flash
        self.transformer.encoder_forward = self._real_encoder
        return False


def _whisper_parts(cfg, params):
    """(held parameters, the encoder's, the decoder cross-attention's
    ``wk`` / ``wv``): the parameters that read each encoder frame."""
    from repro_torch.tree import leaves

    n = sum(t.numel() for t in leaves(params))
    enc = sum(t.numel() for t in leaves(params["encoder"]))
    cross_kv = sum(layer["cross"][w].numel() for layer in params["layers"]
                   for w in ("wk", "wv"))
    return n, enc, cross_kv


def phase_whisper_serve(torch, np):
    """The encoder-decoder's serve path: the full ``whisper-tiny`` (4
    encoder and 4 decoder layers, d_model 384, 6 heads of 64, vocab
    51,865) in bf16 with random weights (seed 0) on ``cuda``, through
    ``Model.prefill_step`` and ``decode_step`` as the JAX package serves
    it (neither package's engine takes frames): 32 requests, each a
    4-token prompt with 1,500 seeded bf16 frames, one prefill with a
    448-slot cache, then greedy decode steps to position 447, the last
    row of the decoder's position table, each step's tokens copied to the
    host.  The attention counts are zeroed just before and read just
    after: every call on the kernels, every prefill-attention launch on
    the tensor-core route, by kind (encoder, decoder self-attention,
    cross-attention: also 4 a decode step, T = 1 against 1,500
    positions); one decode-attention launch a decoder layer and step.
    Then the prefill once more, warm, outside the counted run."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = get_config(ENCDEC_ARCH)
    B, P = WHISPER_REQUESTS, WHISPER_PROMPT
    steps = cfg.decoder_positions - P
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    n, enc, _ = _whisper_parts(cfg, params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    dec_bytes = weight_bytes - sum(t.numel() * t.element_size()
                                   for t in leaves(params["encoder"]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    frames = torch.randn((B, cfg.encoder_positions, cfg.d_model),
                         generator=gen, device="cuda", dtype=torch.bfloat16)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)), dtype=torch.int32, device="cuda")
    say(f"[whisper serve] {cfg.n_encoder_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}: {n} "
        f"parameters held ({enc} in the encoder; ModelConfig.n_params: "
        f"{cfg.n_params()}, ROADMAP C12), {weight_bytes / 1e9:.4f} GB; "
        f"{B} requests of {P} tokens and {cfg.encoder_positions} frames")

    _reset_attention(fa)
    dec.DISPATCHES.reset()
    streams, finite = [prompts.cpu()], []
    with AttentionKinds(torch) as kinds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_step(
            params, {"tokens": prompts, "encoder_frames": frames},
            max_len=cfg.decoder_positions)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        streams.append(tok[:, None].cpu())
        prefill_s = time.perf_counter() - t0
        finite.append(torch.isfinite(logits).all())
        lens = torch.full((B,), P, dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, tok[:, None],
                                              lens)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            streams.append(tok[:, None].cpu())  # streamed out each step
            finite.append(torch.isfinite(logits).all())
            lens += 1
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    fwd, _, routes, _ = _count_attention(fa)
    dcount = dec.DISPATCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.cat(streams, dim=1)
    # the same prefill again, after the counts are read: the first one is
    # the model's first call, and pays its one-time costs
    with AttentionKinds(torch) as again:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill_step(params, {"tokens": prompts,
                                    "encoder_frames": frames},
                           max_len=cfg.decoder_positions)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0

    check(int(lens.min()) == int(lens.max()) == cfg.decoder_positions,
          f"decode ended at cache length {lens.tolist()[:3]}")
    check(bool(torch.stack(finite).all()), "whisper serve: a logit is not "
          "finite")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "whisper serve: a token is out of the vocabulary")
    check(cache["enc_out"].dtype == torch.bfloat16
          and tuple(cache["enc_out"].shape)
          == (B, cfg.encoder_positions, cfg.d_model),
          f"the cache's enc_out is {cache['enc_out'].dtype} "
          f"{tuple(cache['enc_out'].shape)}")
    want = {"encoder": cfg.n_encoder_layers, "self": cfg.n_layers,
            "cross": cfg.n_layers * (1 + steps)}
    got = {k: c[0] for k, c in kinds.counts.items()}
    check(got == want, f"flash_attention calls by kind {got} != {want}")
    check(all(c[0] == c[1] == c[2] for c in kinds.counts.values()),
          f"a flash_attention call missed the kernel's tensor-core route: "
          f"{kinds.counts}")
    check(fwd.launches == fwd.kernel_launches == sum(want.values())
          and routes == {"tc": fwd.launches, "simt": 0},
          f"flash_attention launches {vars(fwd)}, by route {routes}")
    check(dcount.launches == dcount.kernel_launches == cfg.n_layers * steps,
          f"decode_attention launches {vars(dcount)} != {cfg.n_layers} "
          f"layers x {steps} steps")
    enc_out_bytes = B * cfg.encoder_positions * cfg.d_model * 2
    floor_bytes = dec_bytes + cfg.n_layers * enc_out_bytes
    stats = dict(
        requests=B, prompt_tokens=B * P, frames=B * cfg.encoder_positions,
        decode_steps=steps, new_tokens=B * (steps + 1),
        prefill_ms=prefill_s * 1e3, prefill_encoder_ms=kinds.encoder_s * 1e3,
        prefill_decoder_ms=(prefill_s - kinds.encoder_s) * 1e3,
        prefill_again_ms=again_s * 1e3,
        prefill_again_encoder_ms=again.encoder_s * 1e3,
        decode_s=decode_s, ms_per_decode_step=decode_s / steps * 1e3,
        decode_tok_per_s=B * steps / decode_s,
        # a step reads the decoder's weights and, in each layer's cross
        # step, the encoder's output, once each
        decode_floor_bytes=floor_bytes,
        decode_floor_ms=floor_bytes / PEAK_BYTES_PER_S * 1e3,
        weight_gb=weight_bytes / 1e9, peak_gb=peak / 1e9,
        flash_calls_by_kind={k: c[0] for k, c in kinds.counts.items()},
        flash_kernel_launches_by_kind={k: c[1]
                                       for k, c in kinds.counts.items()},
        flash_tc_launches_by_kind={k: c[2] for k, c in kinds.counts.items()},
        flash=vars(fwd), flash_routes=routes, decode=vars(dcount),
        distinct_tokens=int(torch.unique(tokens[:, P:]).numel()))
    say(f"[whisper serve] served: {json.dumps(stats)}")
    say(f"[whisper serve]   req0's tokens: {tokens[0, :24].tolist()} ...")
    del model, params, cache, frames, logits
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, dcount


def phase_whisper_train(torch, np):
    """The encoder-decoder's training path: ``Model.train_step`` on the
    full ``whisper-tiny`` (bf16, fp32 AdamW moments, remat, 4
    microbatches) with random weights (seed 0), a global batch of 256
    (``train_4k``'s) rows of 449 tokens (the whole 448-row position
    table) and 1,500 seeded bf16 frames; a warm-up step, two timed, one
    profiled.  The attention counts are zeroed just before and read just
    after: every forward (the encoder's once, the decoder's twice under
    remat) and backward on the kernels' tensor-core routes.  ``mfu``
    counts the encoder and the cross ``wk`` / ``wv`` per frame, the other
    held parameters per decoder token, and 12 flops a head dim, head and
    visible pair (encoder S^2, decoder causal, cross T x S)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cfg = get_config(ENCDEC_ARCH)
    B, T, S = WHISPER_BATCH, cfg.decoder_positions, cfg.encoder_positions
    mbs = cfg.n_microbatches
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    state = model.init_train_state(0)
    n, enc, cross_kv = _whisper_parts(cfg, state.params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batch = {
        "tokens": torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (B, T + 1)), dtype=torch.int32,
            device="cuda"),
        "encoder_frames": torch.randn((B, S, cfg.d_model), generator=gen,
                                      device="cuda", dtype=torch.bfloat16)}
    state_gb = torch.cuda.memory_allocated() / 1e9
    say(f"[whisper train] {n} parameters held ({enc} encoder, {cross_kv} "
        f"cross wk/wv), {cfg.dtype}, {cfg.optimizer_moments} moments, "
        f"remat={cfg.remat}, {mbs} microbatches; batch {B} x {T + 1} "
        f"tokens and {S} frames; {state_gb:.3f} GB with the batch")

    _reset_attention(fa)
    losses = []

    def step():
        nonlocal state
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))

    step_ms, trace = timed_steps(torch, step, WHISPER_TRAIN_STEPS,
                                 "[whisper train]")
    fwd, bwd, routes, bwd_routes = _count_attention(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(all(np.isfinite(losses)) and losses[1] != losses[0],
          f"whisper training losses {losses}")
    calls = mbs * WHISPER_TRAIN_STEPS
    want_bwd = calls * (cfg.n_encoder_layers + 2 * cfg.n_layers)
    want_fwd = calls * (cfg.n_encoder_layers
                        + 2 * cfg.n_layers * (2 if cfg.remat else 1))
    check(fwd.launches == fwd.kernel_launches == want_fwd
          and routes == {"tc": want_fwd, "simt": 0},
          f"flash_attention forward {vars(fwd)}, by route {routes} != "
          f"{want_fwd}")
    check(bwd.launches == bwd.kernel_launches == want_bwd
          and bwd_routes == {"tc": want_bwd, "simt": 0},
          f"flash_attention backward {vars(bwd)}, by route {bwd_routes} != "
          f"{want_bwd}")
    frames, tokens = B * S, B * T
    pairs = (cfg.n_encoder_layers * S * S
             + cfg.n_layers * fa.visible_pairs(T, T, None)
             + cfg.n_layers * T * S)
    flops = (6 * (enc + cross_kv) * frames + 6 * (n - enc - cross_kv) * tokens
             + 12 * cfg.n_heads * cfg.head_dim * pairs * B)
    timed = step_ms[1:-1]
    warm = sum(timed) / len(timed)
    stats = dict(
        steps=WHISPER_TRAIN_STEPS, losses=losses, step_ms=step_ms,
        timed_steps=len(timed), warm_step_ms=warm,
        warm_step_ms_spread=[min(timed), max(timed)], n_params=n,
        encoder_params=enc, cross_kv_params=cross_kv,
        n_params_config=cfg.n_params(), frames_per_step=frames,
        decoder_tokens_per_step=tokens,
        decoder_tokens_per_s=tokens / warm * 1e3,
        model_flops_per_step=flops,
        mfu=flops / (warm / 1e3) / PEAK_BF16_OPS_PER_S,
        state_gb=state_gb, peak_gb=peak_gb, flash_forward=vars(fwd),
        flash_backward=vars(bwd), expected_forward=want_fwd,
        expected_backward=want_bwd)
    stats.update(trace_stats(trace))
    say(f"[whisper train] trained: {json.dumps(stats)}")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, bwd


def whisper_stream(torch, np, cfg, params, device: str):
    """Greedy tokens (a list a row) and logits (on the cpu) of a seeded
    prefill of four 7-token prompts with seeded fp32 frames and 12 greedy
    decode steps, on ``device``."""
    from repro_torch.models import build_model

    model = build_model(cfg, device)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (4, 7)), dtype=torch.int32, device=device),
        "encoder_frames": torch.as_tensor(rng.standard_normal(
            (4, cfg.encoder_positions, cfg.d_model)), dtype=torch.float32,
            device=device)}
    logits, cache = model.prefill_step(params, batch, max_len=64)
    out, toks = [logits.cpu()], [torch.argmax(logits, -1)]
    lens = torch.full((4,), 7, dtype=torch.int32, device=device)
    for _ in range(12):
        logits, cache = model.decode_step(params, cache,
                                          toks[-1][:, None].to(torch.int32),
                                          lens)
        out.append(logits.cpu())
        toks.append(torch.argmax(logits, -1))
        lens += 1
    return torch.stack(toks, 1).tolist(), out


def phase_whisper_parity(torch, np):
    """The smoke ``whisper-tiny`` (fp32) on cpu and on cuda: a prefill with
    frames and 12 greedy decode steps give identical tokens and logits
    within 1e-4, every attention call on the kernels; then
    ``train_parity`` with frames."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(ENCDEC_ARCH)
    params = build_model(cfg, "cpu").init(0)
    # the tied embedding dominates the residual stream at random init, as
    # in smoke_parity: a smaller one makes the streams depend on the layers
    params["embed"]["tok"] *= 0.05
    cpu_toks, cpu_logits = whisper_stream(torch, np, cfg, params, "cpu")
    _reset_attention(fa)
    dec.DISPATCHES.reset()
    gpu_toks, gpu_logits = whisper_stream(torch, np, cfg,
                                          tree_to(params, "cuda"), "cuda")
    torch.cuda.synchronize()
    want_flash = cfg.n_encoder_layers + 2 * cfg.n_layers + 12 * cfg.n_layers
    check(fa.DISPATCHES.kernel_launches == fa.DISPATCHES.launches
          == want_flash and dec.DISPATCHES.kernel_launches
          == dec.DISPATCHES.launches == 12 * cfg.n_layers,
          f"the cuda smoke whisper run: flash {vars(fa.DISPATCHES)} (want "
          f"{want_flash}), decode {vars(dec.DISPATCHES)}")
    check(cpu_toks == gpu_toks,
          f"whisper token streams differ: cpu {cpu_toks} cuda {gpu_toks}")
    err = max(float((c - g).abs().max())
              for c, g in zip(cpu_logits, gpu_logits))
    check(err <= 1e-4, f"whisper: cpu and cuda logits differ by {err}")
    varied = sum(len(set(t)) > 1 for t in cpu_toks)
    say(f"[whisper parity] smoke {ENCDEC_ARCH} fp32: identical greedy "
        f"streams for 4 rows ({varied} of them not a single repeated "
        f"token); prefill + 12 decode steps' logits within {err:.3g} of "
        f"the cpu run")
    train_parity(torch, np, ENCDEC_ARCH)


# The dry run's arch, its 256-rank host cell, and the cells run on the card
# with their global batches cut to fit one H100 (prefill_32k 32 -> 1,
# decode_32k 128 -> 2); train_4k does not fit one card (8.54 B parameters
# with fp32 AdamW moments are over 100 GB) and is not cut.
DRYRUN_ARCH = "gemma-7b"
DRYRUN_CARD_CELLS = (("prefill_32k", 1), ("decode_32k", 2))
DRYRUN_DECODE_STEPS = 3


def _expect(phase: str, seconds: str) -> None:
    say(f"[{phase}] expected {seconds} s")


def phase_dryrun_host(torch, card: str):
    """The dry run on the card's host: ``gemma-7b`` ``train_4k`` on the
    16x16 production mesh over a fake 256-rank group, on meta tensors,
    through ``run_cell`` (which writes its record under ``dryrun_torch/``):
    the record's roofline terms, per-device bytes and collective census;
    FLOPs, argument bytes and collectives above zero, and the argument
    bytes (the DTensors' local shards) equal to the shards the rules give,
    reckoned from the shapes and the mesh's sizes alone."""
    import types

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import build_model

    _expect("dryrun host", "10-60")
    t0 = time.perf_counter()
    rec = dr.run_cell(DRYRUN_ARCH, "train_4k", "single", force=True)
    wall = time.perf_counter() - t0
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(16, 16))
    model = build_model(dr.get_config(DRYRUN_ARCH), "meta")
    args, specs = dr.cell_args(model, SHAPES["train_4k"],
                               dr.cell_rules(mesh, "train_4k"))
    by_rules = dr.shard_bytes(args, specs, mesh)
    check(rec["cost"]["flops_per_device"] > 0, "dry run: no FLOPs")
    check(rec["memory"]["argument_bytes"] > 0, "dry run: no argument bytes")
    check(rec["collectives"]["n_collectives"] > 0, "dry run: no collectives")
    check(rec["memory"]["argument_bytes"] == by_rules,
          f"dry run: argument bytes {rec['memory']['argument_bytes']} != "
          f"{by_rules} by the rules' shards")
    say(f"[dryrun host] {DRYRUN_ARCH} train_4k single (256 fake ranks, "
        f"meta, not measured): {json.dumps(dict(rec, wall_s=wall))}")
    say(f"[dryrun host] argument bytes by the rules' shards: {by_rules}; "
        f"host of the card {card}")
    return rec


def _placed(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on the 1x1 ``mesh`` holding it
    whole (no copy: on one rank the local tensor is the tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import placements
    from repro_torch.tree import map_tree_with_path

    return map_tree_with_path(
        lambda _, t, s: DTensor.from_local(t, mesh, placements(s, mesh),
                                           run_check=False), tree, specs)


def _library_ms(torch, fn, iters: int, warmup: int = 5):
    """``time_ms`` of a library call, or why it could not run (None and a
    line saying so: the yardstick is optional, the port never calls it)."""
    try:
        return time_ms(torch, fn, iters, warmup)
    except RuntimeError as e:
        say(f"[dryrun card] library call failed: {str(e)[:200]}")
        return None


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in _leaves(tree))


def dryrun_cells(torch, card: str, arch: str, cells, model, params, gen):
    """The dry-run ``cells`` ((shape name, global batch) pairs) of
    ``arch``'s ``model`` and ``params`` on ``make_host_mesh()`` (1x1, this
    card): each traced on meta over the same mesh and rules, then run on
    the card with the parameters, batch (with ``gen``'s patch embeddings
    for a vision frontend) and cache as DTensors under the rules.  Prints
    the predicted and measured argument bytes (checked equal), peak (their
    ratio) and time (the roofline's max(t_compute, t_memory) against the
    step); checks that every attention call launched its kernel (prefill
    on the tensor-core route) and that the last-token logits under the
    rules are bit-equal to the same model's without them; for a vision
    frontend, that a prefill without the patches gives other logits (the
    splice took effect).  Returns (the records by cell, the attention
    counts by cell)."""
    import dataclasses
    import gc

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.sharding import sharding_rules, tree_pspecs

    cfg = model.cfg
    mesh = make_host_mesh()
    check(tuple(mesh.shape) == (1, 1), f"host mesh {mesh}")
    n_attn = _mixers(cfg)[0]
    vision = cfg.frontend == "vision"
    out = {}
    counts = {}
    for name, batch in cells:
        shape = dataclasses.replace(SHAPES[name], global_batch=batch)
        rules = dr.cell_rules(mesh, name)
        pred = dr.trace_cell(cfg, shape, mesh, rules)
        rec = dr.cell_record(arch, shape, "host", 1, cfg, pred)
        roof = rec["roofline"]
        pred_ms = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
        dparams = _placed(params, tree_pspecs(params, rules), mesh)
        B, S = shape.global_batch, shape.seq_len
        ledger = fa.DISPATCHES if shape.kind == "prefill" else dec.DISPATCHES
        fa.ROUTE_LAUNCHES.update(tc=0, simt=0)
        ledger.reset()
        moved = None
        if shape.kind == "prefill":
            tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   device="cuda", dtype=torch.int32)
            batch_ = {"tokens": tokens}
            if vision:
                batch_["patch_embeds"] = torch.randn(
                    (B, cfg.n_patches, cfg.d_model), generator=gen,
                    device="cuda", dtype=DTYPES[cfg.dtype])
            dbatch = _placed(batch_, dr.batch_pspecs(batch_, rules), mesh)
            measured_args = _local_bytes(dparams) + _local_bytes(dbatch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with sharding_rules(rules), implicit_replication():
                logits, cache = model.prefill_step(dparams, dbatch, max_len=S)
                logits = logits.full_tensor()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            del cache
            gc.collect()
            t0 = time.perf_counter()
            plain, cache = model.prefill_step(params, batch_, max_len=S)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            del cache
            runs = 2
            if vision:
                bare, cache = model.prefill_step(params, {"tokens": tokens},
                                                 max_len=S)
                del cache
                runs = 3
                moved = float((bare.float() - plain.float()).abs().max())
                check(not torch.equal(bare, plain),
                      f"{arch} {name}: the logits without the patch "
                      "embeddings equal those with them")
            want_launches = runs * n_attn
            check(fa.ROUTE_LAUNCHES == {"tc": want_launches, "simt": 0},
                  f"{name}: flash launches by route {fa.ROUTE_LAUNCHES}")
        else:
            cache = model.init_cache(B, S)
            for t in _leaves(cache):
                t.normal_(generator=gen)
            tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                                   device="cuda", dtype=torch.int32)
            lens = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
            batch_ = {"tokens": tokens, "cache_len": lens}
            dbatch = _placed(batch_, dr.batch_pspecs(batch_, rules), mesh)
            dcache = _placed(cache, dr.cache_pspecs(cache, rules), mesh)
            measured_args = (_local_bytes(dparams) + _local_bytes(dcache)
                             + _local_bytes(dbatch))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(DRYRUN_DECODE_STEPS):
                t0 = time.perf_counter()
                with sharding_rules(rules), implicit_replication():
                    logits, _ = model.decode_step(dparams, dcache,
                                                  dbatch["tokens"],
                                                  dbatch["cache_len"])
                    logits = logits.full_tensor()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            step_ms = min(times)
            # the same step without rules on the same tensors: it writes
            # the same slot with the same values and reads the same cache
            t0 = time.perf_counter()
            plain, _ = model.decode_step(params, cache, tokens, lens)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            del cache, dcache
            want_launches = (DRYRUN_DECODE_STEPS + 1) * n_attn
        counts[name] = ledger.snapshot()
        c = counts[name]
        check(c.launches == c.kernel_launches == want_launches,
              f"{name}: attention launches {vars(c)}, want {want_launches} "
              "all on the kernel")
        check(bool(torch.isfinite(logits.float()).all()),
              f"{name}: a logit is not finite")
        check(torch.equal(logits, plain),
              f"{name}: logits under the rules differ from the plain run's "
              f"(max abs {float((logits.float() - plain.float()).abs().max())})")
        check(measured_args == pred["argument_bytes"],
              f"{name}: measured argument bytes {measured_args} != predicted "
              f"{pred['argument_bytes']}")
        res = dict(cell=name, global_batch=B, seq_len=S,
                   predicted_argument_bytes=pred["argument_bytes"],
                   measured_argument_bytes=measured_args,
                   predicted_peak_bytes=pred["peak_bytes"],
                   measured_peak_bytes=peak,
                   peak_ratio=peak / pred["peak_bytes"],
                   roofline_ms=pred_ms, t_compute_ms=roof["t_compute_s"] * 1e3,
                   t_memory_ms=roof["t_memory_s"] * 1e3,
                   step_ms=step_ms, plain_step_ms=plain_ms,
                   step_over_roofline=step_ms / pred_ms,
                   trace_s=pred["seconds"], kernel_calls=vars(c),
                   logits_bit_equal=True, card=card)
        if shape.kind == "decode":
            res["step_ms_all"] = times
        if moved is not None:
            res["patch_embeds"] = list(batch_["patch_embeds"].shape)
            res["logits_moved_without_patches"] = moved
        say(f"[dryrun card] {arch} {name}: {json.dumps(res)}")
        out[name] = res
        del dparams, dbatch
        gc.collect()
        torch.cuda.empty_cache()
    return out, counts


def cell_kernels(torch, card: str, arch: str, cfg, rows: int, gen):
    """B4 and B5 alone at ``arch``'s dry-run cells' shapes (``cfg``'s
    heads and head dim, ``prefill_32k``'s 32,768 keys; ``decode_32k`` at
    ``rows`` rows of 32,768 slots), each held against its plain version at
    ``ATTN_TOL`` and timed beside its bound and PyTorch's
    ``scaled_dot_product_attention``.  B4's plain version runs on the last
    256 queries against all 32,768 keys (its scores for every query would
    not fit).  Call with the model freed."""
    import torch.nn.functional as F

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = SHAPES["prefill_32k"].seq_len
    q = torch.randn((1, Hq, S, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((1, Hkv, S, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    ops, nbytes = fa.flash_work(q, k, True, None)
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    flash_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), 3, 1)
    sdpa_ms = _library_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 3, 1)
    tail = q[:, :, -256:].contiguous()
    got, want = fa.flash_attention(tail, k, v), fa.attention_ref(tail, k, v)
    err = float((got.float() - want.float()).abs().max())
    check(_allclose(got, want, ATTN_TOL["flash_attention"]["bfloat16"]),
          f"{arch} flash_attention at {Hq} over {Hkv} heads, D {D}, S {S}: "
          f"max abs err {err}")
    scores_gb = Hq * S * S * 4 / 1e9
    out = {"flash": dict(
        shape=f"B=1,Hq={Hq},Hkv={Hkv},T={S},S={S},D={D},causal,bf16",
        ms=flash_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
        bound_by=bound_by,
        plain_ms=f"not measured (its [{Hq}, {S}, {S}] fp32 scores are "
                 f"{scores_gb:.1f} GB)",
        tail_256_queries_max_abs_err=err)}
    del q, k, v, tail, got, want
    q = torch.randn((rows, Hq, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((rows, Hkv, S, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    lens = torch.full((rows,), S, dtype=torch.int32, device="cuda")
    ops, nbytes = dec.decode_work(q, k, rows * S)
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    dec_ms = time_ms(torch, lambda: dec.decode_attention(q, k, v, lens), 20)
    plain_ms = time_ms(torch, lambda: dec.decode_attention_ref(q, k, v, lens),
                       3, 1)
    sdpa_ms = _library_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, enable_gqa=True), 20)
    got = dec.decode_attention(q, k, v, lens)
    want = dec.decode_attention_ref(q, k, v, lens)
    err = float((got.float() - want.float()).abs().max())
    check(_allclose(got, want, ATTN_TOL["decode_attention"]["bfloat16"]),
          f"{arch} decode_attention at {rows} x {Hq} over {Hkv} heads, "
          f"D {D}, S {S}: max abs err {err}")
    out["decode"] = dict(shape=f"B={rows},Hq={Hq},Hkv={Hkv},S={S},D={D},bf16",
                         ms=dec_ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=err)
    say(f"[dryrun card] {arch} B4/B5 alone at the cells' shapes on {card}: "
        f"{json.dumps(out)}")
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def phase_dryrun_card(torch, np, card: str):
    """``gemma-7b`` at full size: its ``DRYRUN_CARD_CELLS`` through
    ``dryrun_cells`` on ``make_host_mesh()`` (1x1, this card); then B4 and
    B5 alone at the cells' shapes (head dim 256, 32,768 keys) through
    ``cell_kernels``."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import build_model

    _expect("dryrun card", "20-90")
    cfg = get_config(DRYRUN_ARCH)
    say(f"[dryrun card] {DRYRUN_ARCH} at full size on the host mesh; cuts: "
        + ", ".join(f"{n} global batch {SHAPES[n].global_batch} -> {b}"
                    for n, b in DRYRUN_CARD_CELLS)
        + "; train_4k not run: 8.54 B parameters with fp32 AdamW moments "
        "exceed one card's 80 GB (the model is not cut)")
    model = build_model(cfg, "cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    out, counts = dryrun_cells(torch, card, DRYRUN_ARCH, DRYRUN_CARD_CELLS,
                               model, params, gen)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()

    out.update(cell_kernels(torch, card, DRYRUN_ARCH, cfg,
                            DRYRUN_CARD_CELLS[1][1], gen))
    flash = counts[DRYRUN_CARD_CELLS[0][0]]
    decode = counts[DRYRUN_CARD_CELLS[1][0]]
    return flash, decode, out


# ---------------------------------------------------- the dense family
# pixtral-12b (the VLM backbone: 40 layers, d_model 5,120, 32 over 8 heads
# of 128, 256 patch embeddings) at full size, and mistral-large-123b (88
# layers, d_model 12,288, 96 over 8 heads of 128, int8 KV cache, factored
# second moment) at full width with its depth cut.
VLM_SERVE_ROWS, VLM_SERVE_PROMPT, VLM_SERVE_NEW = 4, 1536, 16
# the cache a decode_32k row holds is 10.7 GB at pixtral's 40 layers: the
# cell takes as many rows as fit beside the weights, less this margin for
# the step's own tensors
VLM_DECODE_MARGIN_GB = 6.0
# pixtral-12b's depth cut from 40 for training: a layer holds 272.6 M
# parameters and the untied embedding and head 1.34 B; bf16 parameters,
# fp32 m and v and one bf16 gradient tree take 14 bytes a parameter, so 10
# layers (4.07 B) reckon to ~57 GB before the update's fp32 temporaries
# (three copies of the 131,072 x 5,120 embedding, 8.1 GB) and activations;
# 12 layers would reckon to ~73 GB
VLM_TRAIN_LAYERS = 10
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, VLM_TRAIN_STEPS = 2, 4096, 4
DENSE_ARCH = "mistral-large-123b"
# mistral-large-123b's depth cut from 88 layers for serving: a layer holds
# 1.384 B parameters (2.77 GB in bf16) and the untied embedding and head
# 0.81 B, so 12 layers are 17.42 B, 34.8 GB
MISTRAL_LAYERS = 12
# and for training: bf16 parameters, m and two gradient trees (the
# running sum and one host's fresh ones) take 8 bytes a parameter beside
# the factored v's row and column means, so 4 layers (6.34 B) reckon to
# ~51 GB before the update's fp32 temporaries (three copies of the
# 32,768 x 12,288 embedding, 4.8 GB) and activations; 5 layers would
# reckon to ~62 GB, 6 to ~73 GB
MISTRAL_TRAIN_LAYERS = 4
# a narrow model at mistral-large-123b's head ratio (24 query heads over
# 2, a group of 12: the decode kernel's chunked grid), head dim 16, its
# int8 cache; the CPU tests hold the same model against the JAX package
MISTRAL_NARROW = dict(n_heads=24, n_kv_heads=2, head_dim=16)


def phase_vlm_model(torch, np, card: str):
    """``pixtral-12b`` at full size (40 layers, bf16, random weights from
    seed 0), after every earlier model is freed: served through
    ``Model.prefill_step`` / ``decode_step`` (neither package's engine
    takes patches) with ``VLM_SERVE_ROWS`` prompts of
    ``VLM_SERVE_PROMPT`` tokens, each with 256 seeded patch embeddings
    over its first positions, and ``VLM_SERVE_NEW`` greedy decode steps;
    the attention counts are zeroed just before and read just after (the
    prefill on the tensor-core route, the decode on the whole grid).  Then
    the same model's dry-run cells through ``dryrun_cells``:
    ``prefill_32k`` at a global batch of 1 with its 256 patch embeddings
    and ``decode_32k`` at as many rows as fit."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.layers import DTYPES

    _expect("vlm model", "10-45")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(VLM_ARCH)
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    B, T = VLM_SERVE_ROWS, VLM_SERVE_PROMPT
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    patches = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                          device="cuda", dtype=DTYPES[cfg.dtype])
    say(f"[vlm {VLM_ARCH}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{n_params} parameters, {weight_bytes / 1e9:.3f} GB of {cfg.dtype} "
        f"weights; {B} prompts of {T} tokens with {cfg.n_patches} patch "
        f"embeddings each")
    _reset_attention(fa)
    dec.DISPATCHES.reset()
    dec.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill_step(
        params, {"tokens": tokens, "patch_embeds": patches},
        max_len=T + VLM_SERVE_NEW)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    stream, finite = [], [torch.isfinite(logits).all()]
    t0 = time.perf_counter()
    for _ in range(VLM_SERVE_NEW):
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        stream.append(tok)
        logits, cache = model.decode_step(params, cache, tok, lens)
        finite.append(torch.isfinite(logits).all())
        lens = lens + 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    fwd, _, routes, _ = _count_attention(fa)
    decode = dec.DISPATCHES.snapshot()
    groups = dec.launches_by_group()
    peak = torch.cuda.max_memory_allocated()
    stream = torch.cat(stream, dim=1).tolist()
    n_attn = _mixers(cfg)[0]
    check(bool(torch.stack(finite).all()), f"{VLM_ARCH}: a logit is not finite")
    check(all(0 <= t < cfg.vocab_size for row in stream for t in row),
          f"{VLM_ARCH}: a sampled token is out of the vocabulary")
    check(fwd.launches == fwd.kernel_launches == n_attn
          and routes == {"tc": n_attn, "simt": 0},
          f"{VLM_ARCH} prefill: flash {vars(fwd)}, by route {routes}")
    check(decode.launches == decode.kernel_launches == n_attn * VLM_SERVE_NEW
          and groups == {"whole": decode.launches, "chunked": 0},
          f"{VLM_ARCH} decode: {vars(decode)}, by grid {groups}")
    ms_per_step = decode_s / VLM_SERVE_NEW * 1e3
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    stats = dict(rows=B, prompt_tokens=B * T, patch_embeds=list(patches.shape),
                 new_tokens=B * VLM_SERVE_NEW, prefill_s=prefill_s,
                 prefill_tok_per_s=B * T / prefill_s,
                 ms_per_decode_step=ms_per_step,
                 # a decode step reads every weight and the cache once
                 read_floor_ms=(weight_bytes + cache_bytes)
                 / PEAK_BYTES_PER_S * 1e3,
                 n_params=n_params, weight_gb=weight_bytes / 1e9,
                 peak_gb=peak / 1e9, flash=vars(fwd), decode=vars(decode),
                 decode_grids=groups, card=card)
    say(f"[vlm {VLM_ARCH}] served: {json.dumps(stats)}")
    say(f"[vlm {VLM_ARCH}] greedy streams: {stream}")
    del logits, cache, tokens, patches
    gc.collect()
    torch.cuda.empty_cache()

    # decode_32k at as many rows as fit beside the weights
    shape = SHAPES["decode_32k"]
    row_bytes = sum(t.numel() * t.element_size() for t in _leaves(
        build_model(cfg, "meta").init_cache(1, shape.seq_len)))
    free, _ = torch.cuda.mem_get_info()
    rows = int((free - VLM_DECODE_MARGIN_GB * 1e9) // row_bytes)
    rows = max(1, min(rows, shape.global_batch))
    cells = (("prefill_32k", 1), ("decode_32k", rows))
    say(f"[dryrun card] {VLM_ARCH} at full size on the host mesh; cuts: "
        f"prefill_32k global batch {SHAPES['prefill_32k'].global_batch} -> "
        f"1, decode_32k {shape.global_batch} -> {rows} (a row's cache "
        f"{row_bytes / 1e9:.3f} GB, {free / 1e9:.3f} GB free beside the "
        f"weights, {VLM_DECODE_MARGIN_GB} GB kept for the step)")
    out, counts = dryrun_cells(torch, card, VLM_ARCH, cells, model, params,
                               gen)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out.update(cell_kernels(torch, card, VLM_ARCH, cfg, rows, gen))
    return fwd, decode, counts["prefill_32k"], counts["decode_32k"], out


def phase_dense_model(torch, np):
    """``mistral-large-123b`` at full width with its depth cut to
    ``MISTRAL_LAYERS``, after every earlier model is freed, through
    ``serve_attention_model`` (the six prompts, ``ServeEngine``): its
    int8 cache dequantised through the decode kernel, every decode launch
    on the chunked grid (a group of 12), decode ms a step beside the
    floor of its reads."""
    import gc

    _expect("dense model", "6-25")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[model {DENSE_ARCH}] {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated before the model is drawn")
    cfg, _, _, flash, decode, _, stats = serve_attention_model(
        torch, np, DENSE_ARCH, n_layers=MISTRAL_LAYERS)
    check(cfg.kv_cache_dtype == "int8" and "int8" in stats["cache_dtypes"],
          f"{DENSE_ARCH}: the cache holds {stats['cache_dtypes']}, no int8")
    say(f"[model {DENSE_ARCH}] decode {stats['ms_per_decode_step']:.3f} ms a "
        f"step against a floor of {stats['weight_read_floor_ms']:.3f} ms "
        f"(its {stats['weight_gb']:.3f} GB of weights read once)")
    return flash, decode


def phase_dense_parity(torch, np):
    """The narrow model at mistral-large-123b's head ratio
    (``MISTRAL_NARROW``, fp32, int8 cache) served on cpu and on cuda
    through ``smoke_parity``: identical greedy streams and logits within
    1e-4, every cuda decode launch on the chunked grid."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    _expect("dense parity", "1-6")
    cfg = dataclasses.replace(smoke_config(DENSE_ARCH), **MISTRAL_NARROW)
    dec.LAUNCHES.clear()
    smoke_parity(torch, np, DENSE_ARCH, [fa.DISPATCHES, dec.DISPATCHES],
                 cfg=cfg)
    groups = dec.launches_by_group()
    check(groups == {"whole": 0,
                     "chunked": dec.DISPATCHES.kernel_launches},
          f"the narrow {DENSE_ARCH} (G = 12): decode launches by grid "
          f"{groups}")
    say(f"[model parity] narrow {DENSE_ARCH} ({cfg.n_heads} over "
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.kv_cache_dtype} "
        f"cache): {groups['chunked']} decode launches, all on the chunked "
        f"grid")


def phase_dense_train(torch, np):
    """``FTTrainer`` on ``mistral-large-123b`` at full width with its depth
    cut to ``MISTRAL_TRAIN_LAYERS`` (bf16, factored moments, remat):
    every attention forward and backward on the kernels at a group of 12,
    the factored ``v_row`` / ``v_col`` updated on the card."""
    _expect("dense train", "6-25")
    return train_full_model(torch, np, DENSE_ARCH,
                            n_layers=MISTRAL_TRAIN_LAYERS)[1:3]


def phase_vlm_train(torch, np):
    """``Model.train_step`` on ``pixtral-12b`` at full width with its depth
    cut to ``VLM_TRAIN_LAYERS`` (bf16, fp32 moments, remat) and random
    weights (seed 0), a batch of ``VLM_TRAIN_BATCH`` rows of
    ``VLM_TRAIN_SEQ`` + 1 tokens, each with 256 seeded patch embeddings
    (``FTTrainer``'s data feeds tokens only, in both packages); a warm-up
    step, two timed, one profiled.  The attention counts are zeroed just
    before and read just after: every forward (twice a layer under remat)
    and backward on the kernels' tensor-core routes.  ``mfu`` counts the
    held parameters per position and 12 flops a head dim, head and
    visible causal pair."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.layers import DTYPES

    _expect("vlm train", "5-25")
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS)
    B, T = VLM_TRAIN_BATCH, VLM_TRAIN_SEQ
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    state = model.init_train_state(0)
    n = sum(t.numel() for t in _leaves(state.params))
    reckoned = reckon_train_state(cfg, state.params, grads=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T + 1),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "patch_embeds": torch.randn((B, cfg.n_patches, cfg.d_model),
                                         generator=gen, device="cuda",
                                         dtype=DTYPES[cfg.dtype])}
    state_gb = torch.cuda.memory_allocated() / 1e9
    say(f"[train {VLM_ARCH}] {cfg.n_layers} layers (depth cut from "
        f"{get_config(VLM_ARCH).n_layers}), d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, {n} "
        f"parameters held, {cfg.dtype}, {cfg.optimizer_moments} moments, "
        f"remat={cfg.remat}; batch {B} x {T + 1} tokens with "
        f"{cfg.n_patches} patch embeddings a row; {state_gb:.3f} GB with "
        f"the batch; reckoned: {json.dumps(reckoned)}")

    _reset_attention(fa)
    losses = []

    def step():
        nonlocal state
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))

    step_ms, trace = timed_steps(torch, step, VLM_TRAIN_STEPS,
                                 f"[train {VLM_ARCH}]")
    fwd, bwd, routes, bwd_routes = _count_attention(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(losses) == VLM_TRAIN_STEPS and all(np.isfinite(losses))
          and losses[1] != losses[0], f"{VLM_ARCH} training losses {losses}")
    n_attn = _mixers(cfg)[0]
    want_bwd = n_attn * VLM_TRAIN_STEPS
    want_fwd = want_bwd * (2 if cfg.remat else 1)
    check(fwd.launches == fwd.kernel_launches == want_fwd
          and routes == {"tc": want_fwd, "simt": 0},
          f"flash_attention forward {vars(fwd)}, by route {routes} != "
          f"{want_fwd}")
    check(bwd.launches == bwd.kernel_launches == want_bwd
          and bwd_routes == {"tc": want_bwd, "simt": 0},
          f"flash_attention backward {vars(bwd)}, by route {bwd_routes} != "
          f"{want_bwd}")
    tokens = B * T
    flops = (6 * n * tokens + 12 * n_attn * cfg.n_heads * cfg.head_dim
             * fa.visible_pairs(T, T, None) * B)
    timed = step_ms[1:-1]
    warm = sum(timed) / len(timed)
    stats = dict(
        steps=VLM_TRAIN_STEPS, losses=losses, step_ms=step_ms,
        timed_steps=len(timed), warm_step_ms=warm,
        warm_step_ms_spread=[min(timed), max(timed)], n_params=n,
        positions_per_step=tokens, patch_positions_per_step=B * cfg.n_patches,
        tokens_per_s=tokens / warm * 1e3, model_flops_per_step=flops,
        mfu=flops / (warm / 1e3) / PEAK_BF16_OPS_PER_S,
        state_gb=state_gb, peak_gb=peak_gb, reckoned=reckoned,
        flash_forward=vars(fwd), flash_backward=vars(bwd),
        expected_forward=want_fwd, expected_backward=want_bwd)
    stats.update(trace_stats(trace))
    say(f"[train {VLM_ARCH}] trained: {json.dumps(stats)}")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, bwd


# --------------------------------------------------------------- examples
EXAMPLES_DIR, DOCS_DIR = ROOT / "examples_torch", ROOT / "docs_torch"
# each driver's promised lines (CI greps the reference's for the same)
PROMISED = {
    "quickstart": ("semantically equivalent to Riak ORSWOT sets",
                   "anti-entropy convergence"),
    "bigset_cluster": ("converged; concurrent re-add beat the remove",
                       "served scan agrees with every replica"),
    "serve_batched": ("all requests served",),
    "train_ft": ("loss improved across crash/restore/elastic events",),
    "cookbook": ("cookbook: 19 blocks executed green",
                 "converged in ", "healed "),
}
COOKBOOK_BLOCKS = 19
# the model drivers and the ledgers each must launch; the others build
# bigset clusters
EXAMPLE_KERNELS = {"serve_batched": ("flash", "decode"),
                   "train_ft": ("flash", "flash_bwd")}


class ClustersBuilt(contextlib.AbstractContextManager):
    """While installed, every ``BigsetCluster`` built, in order: it wraps
    the class's ``__init__`` (the drivers import the class itself) and
    restores it on exit."""

    def __init__(self):
        from repro_torch.cluster.clusters import BigsetCluster

        self.cls, self.clusters = BigsetCluster, []

    def __enter__(self):
        real = self._real = self.cls.__init__

        def init(cluster, *args, **kw):
            real(cluster, *args, **kw)
            self.clusters.append(cluster)

        self.cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self._real
        return False


def _driver_main(path: Path):
    """A driver's ``main``, loaded from its file as a module of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def phase_examples(torch):
    """The port's four examples and its query cookbook, in this process on
    ``cuda``, each through its ``main``: every promised line printed; each
    attention ledger zeroed just before a driver and read just after
    (``serve_batched`` launches B4 and B5, ``train_ft`` B4 and B4'); every
    bigset cluster on the card and every ``dot_seen`` dispatch a kernel
    launch (the demos' batches are below ``query/batch.MIN_BATCH``, so none
    may happen).  Returns each driver's counts."""
    import io

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import dot_seen
    from repro_torch.kernels import flash_attention as fa

    _expect("examples", "15-60")
    ledgers = {"flash": fa.DISPATCHES, "flash_bwd": fa.BWD_DISPATCHES,
               "decode": dec.DISPATCHES, "dot_seen": dot_seen.DISPATCHES}
    drivers = [(name, EXAMPLES_DIR / f"{name}.py")
               for name in ("quickstart", "bigset_cluster", "serve_batched",
                            "train_ft")]
    drivers.append(("cookbook", DOCS_DIR / "run_cookbook.py"))
    out = {}
    for name, path in drivers:
        main = _driver_main(path)
        text = io.StringIO()
        for ledger in ledgers.values():
            ledger.reset()
        t0 = time.perf_counter()
        with ClustersBuilt() as built, contextlib.redirect_stdout(text):
            ret = main(["--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: ledger.snapshot() for k, ledger in ledgers.items()}
        text = text.getvalue()
        say(f"[examples {name}] {seconds:.2f}s; clusters on "
            f"{sorted({c.device.type for c in built.clusters})}; dispatches "
            + json.dumps({k: vars(c) for k, c in counts.items()}))
        for line in text.splitlines():
            if line.startswith(("final:", "model:", "converged in",
                                "replayed ")):
                say(f"[examples {name}] {line}")
        for line in PROMISED[name]:
            check(line in text, f"{name} did not print {line!r}")
        for k, c in counts.items():
            check(c.kernel_launches == c.launches,
                  f"{name}: a {k} dispatch missed its CUDA kernel")
        if name in EXAMPLE_KERNELS:
            check(all(counts[k].launches > 0 for k in EXAMPLE_KERNELS[name]),
                  f"{name} launched no attention kernel: {counts}")
        else:
            check(bool(built.clusters) and all(
                c.device.type == "cuda" for c in built.clusters),
                f"{name}: a bigset cluster is not on the card")
        if name == "cookbook":
            check(ret == COOKBOOK_BLOCKS,
                  f"the cookbook ran {ret} blocks, not {COOKBOOK_BLOCKS}")
        out[name] = counts
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    def run(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say(f"[time] {fn.__name__}: {time.perf_counter() - t0:.2f}s")
        return out

    try:
        card = run(phase_device, torch)
        run(phase_build)
        kres = run(phase_kernels, torch, np)
        ares = run(phase_attention_kernels, torch)
        mres = run(phase_mamba_kernel, torch)
        cres = run(phase_clock_kernels, torch, np)
        launched, cluster = run(phase_main, torch)
        clock_launched = run(phase_clock_entry, torch, cluster)
        del cluster
        run(phase_parity, torch)
        cluster_launched, cluster_clock = run(phase_cluster, torch)
        run(phase_cluster_parity, torch)
        # each serve and training path's attention launches, by path
        flash, decode, bwd = {}, {}, {}
        flash[MODEL_ARCH], decode[MODEL_ARCH] = run(phase_model, torch, np)
        run(phase_model_parity, torch, np)
        run(phase_vlm_parity, torch, np)
        scans = run(phase_ssm_model, torch, np)
        run(phase_ssm_parity, torch, np)
        flash[MOE_ARCH], decode[MOE_ARCH] = run(phase_moe_model, torch, np)
        flash[GROK_ARCH], decode[GROK_ARCH] = run(phase_grok_model, torch, np)
        (flash[HYBRID_ARCH], decode[HYBRID_ARCH],
         hybrid_scans) = run(phase_hybrid_model, torch, np)
        flash[DENSE_ARCH], decode[DENSE_ARCH] = run(phase_dense_model,
                                                    torch, np)
        run(phase_moe_parity, torch, np)
        run(phase_dense_parity, torch, np)
        bres = run(phase_attention_bwd, torch,
                   ares[("flash_attention", "path", "bfloat16")]["device_ms"])
        sbres = run(phase_mamba_bwd, torch)
        flash[f"{TRAIN_ARCH} train"], bwd[TRAIN_ARCH] = run(phase_train,
                                                            torch, np)
        flash[f"{MOE_ARCH} train"], bwd[MOE_ARCH] = run(phase_moe_train,
                                                        torch, np)
        train_scans, scan_bwd = run(phase_ssm_train, torch, np)
        (flash[f"{DENSE_ARCH} train"],
         bwd[f"{DENSE_ARCH} train"]) = run(phase_dense_train, torch, np)
        (flash[f"{VLM_ARCH} train"],
         bwd[f"{VLM_ARCH} train"]) = run(phase_vlm_train, torch, np)
        run(phase_ft, torch, np)
        run(phase_train_parity, torch, np)
        run(phase_moe_train_parity, torch, np)
        run(phase_hybrid_parity, torch, np)
        serve_key, train_key = f"{ENCDEC_ARCH} serve", f"{ENCDEC_ARCH} train"
        flash[serve_key], decode[serve_key] = run(phase_whisper_serve,
                                                  torch, np)
        flash[train_key], bwd[train_key] = run(phase_whisper_train, torch,
                                               np)
        run(phase_whisper_parity, torch, np)
        run(phase_dryrun_host, torch, card)
        (flash[f"{DRYRUN_ARCH} prefill_32k"],
         decode[f"{DRYRUN_ARCH} decode_32k"], _) = run(phase_dryrun_card,
                                                        torch, np, card)
        (flash[f"{VLM_ARCH} serve"], decode[f"{VLM_ARCH} serve"],
         flash[f"{VLM_ARCH} prefill_32k"], decode[f"{VLM_ARCH} decode_32k"],
         _) = run(phase_vlm_model, torch, np, card)
        ex = run(phase_examples, torch)
        flash["serve_batched example"] = ex["serve_batched"]["flash"]
        decode["serve_batched example"] = ex["serve_batched"]["decode"]
        flash["train_ft example"] = ex["train_ft"]["flash"]
        bwd["train_ft example"] = ex["train_ft"]["flash_bwd"]
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))
        check(not leaked, f"imported {leaked[:5]}")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    path = kres["path"]
    seen_by_path = {"main": launched.kernel_launches,
                    "cluster": cluster_launched.kernel_launches,
                    "examples": sum(c["dot_seen"].kernel_launches
                                    for c in ex.values())}
    kernels = [{
        "name": "dot_seen",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dot_seen/csrc/dot_seen.cu",
        "replaces": "src/repro/kernels/dot_seen/kernel.py:53",
        "launches": sum(seen_by_path.values()),
        "launches_by_path": seen_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in kres.values()),
        "ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": None,
        "device_ms": path["device_ms"],
        "empty_launch_ms": path["empty_launch_ms"],
        "shape": path["shape"],
    }]
    for name, replaces, by_path in (
            ("flash_attention", "src/repro/kernels/flash_attention/kernel.py:102",
             flash),
            ("decode_attention",
             "src/repro/kernels/decode_attention/kernel.py:74", decode)):
        res = ares[(name, "path", "bfloat16")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(c.kernel_launches for c in by_path.values()),
            "launches_by_path": {arch: c.kernel_launches
                                 for arch, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for (n, _, _), r in ares.items()
                               if n == name),
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
            "device_ms": res["device_ms"],
            "shape": f"{res['shape']},bf16",
        })
    mpath = mres["path-bf16"]
    scans_by_path = {f"{SSM_ARCH} serve": scans.kernel_launches,
                     f"{SSM_ARCH} train": train_scans.kernel_launches,
                     f"{HYBRID_ARCH} serve": hybrid_scans.kernel_launches}
    kernels.append({
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:54",
        "launches": sum(scans_by_path.values()),
        "launches_by_path": scans_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in mres.values()),
        "ms": mpath["ms"],
        "plain_ms": mpath["plain_ms"],
        "bound_ms": mpath["bound_ms"],
        "bound_by": mpath["bound_by"],
        "library_ms": None,
        "device_ms": mpath["device_ms"],
        "shape": f"{mpath['shape']},bf16",
    })
    tomb = cres["tomb"]
    for name, replaces, op, res in (
            ("clock_merge", "src/repro/kernels/clock_ops/kernel.py:91",
             "merge", dict(tomb["join"], **{
                 k: tomb[k] for k in ("bound_ms", "bound_by")})),
            ("clock_popcount", "src/repro/kernels/clock_ops/kernel.py:132",
             "popcount", tomb["popcount"])):
        by_path = {"main": clock_launched[op].kernel_launches,
                   "cluster": cluster_clock[op].kernel_launches}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/clock_ops/csrc/clock_ops.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in cres.values()),
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
            "device_ms": res["device_ms"],
            "shape": tomb["shape"] + (",join" if name == "clock_merge" else ""),
        })
    bpath = bres["path"]
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:102 "
                    "(its gradient: no Pallas backward; JAX differentiates "
                    "the jnp reference)",
        "launches": sum(c.kernel_launches for c in bwd.values()),
        "launches_by_path": {arch: c.kernel_launches
                             for arch, c in bwd.items()},
        "max_abs_err": max(r["max_abs_err"] for r in bres.values()),
        "ms": bpath["ms"],
        "plain_ms": bpath["plain_ms"],
        "bound_ms": bpath["bound_ms"],
        "bound_by": bpath["bound_by"],
        "library_ms": bpath["library_ms"],
        "device_ms": bpath["device_ms"],
        "shape": f"{bpath['shape']},bf16",
    })
    spath = sbres[("path", "bfloat16")]
    kernels.append({
        "name": "mamba_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:54 (its "
                    "gradient: no Pallas backward; JAX differentiates the "
                    "jnp reference, src/repro/models/mamba.py:107-111)",
        "launches": scan_bwd.kernel_launches,
        "launches_by_path": {SSM_ARCH: scan_bwd.kernel_launches},
        "max_abs_err": max(r["max_abs_err"] for r in sbres.values()),
        "ms": spath["ms"],
        "plain_ms": spath["plain_ms"],
        "bound_ms": spath["bound_ms"],
        "bound_by": spath["bound_by"],
        "library_ms": None,
        "device_ms": spath["device_ms"],
        "device_ms_by_launch": spath["device_ms_by_launch"],
        "sfu_ms": spath["sfu_ms"],
        "resident_warps_per_sm": spath["resident_warps_per_sm"],
        "jamba_device_ms": sbres[("jamba", "bfloat16")]["device_ms"],
        "train_forward_device_ms": spath["train_forward_device_ms"],
        "serve_forward_device_ms": spath["serve_forward_device_ms"],
        "shape": f"{spath['shape']},bf16",
    })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
