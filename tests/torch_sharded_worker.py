"""Run the port's serve and train steps on DTensors over a real 4-rank
``gloo`` group on the CPU, for ``tests/test_torch_sharded_parity.py``.

    python tests/torch_sharded_worker.py CASES.pt RESULTS.pt WORKDIR

``CASES.pt`` holds a list of cases, each a dict: ``arch`` (a smoke
config), ``mesh`` (``(data, model)``, four ranks in all), ``params`` (the
port's parameter tree as plain tensors), ``prompt`` (int32 ``[B, T]``),
``max_len``, ``next`` (int32 ``[B, 1]``, the decoded token) and ``batch``
(a train batch).  Every rank places the parameters, optimizer state,
batch and cache by the dry run's rules (``cell_rules`` of ``prefill_32k``,
``decode_32k`` and ``train_4k``) and runs one prefill, one decode step on
the prefill's cache, one ``grad_step`` (the loss's gradients, each in its
parameter's placements) and one train step; rank 0 writes each case's
gathered results to ``RESULTS.pt``.  Imports torch and the port only.
"""
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def run_case(case, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import smoke_config
    from repro_torch.launch.dryrun import batch_pspecs, cache_pspecs, cell_rules
    from repro_torch.models import TrainState, build_model
    from repro_torch.models.sharding import (P, distribute, placements,
                                             sharding_rules, tree_pspecs)
    from repro_torch.train.optimizer import init_opt_state, opt_state_pspecs
    from repro_torch.tree import leaves, map_tree

    cfg = smoke_config(case["arch"])
    model = build_model(cfg, "cpu")
    mesh = init_device_mesh("cpu", case["mesh"],
                            mesh_dim_names=("data", "model"))
    full = lambda tree: map_tree(lambda t: t.full_tensor(), tree)  # noqa: E731
    out = {}

    def placed(tree, specs):
        return distribute(tree, specs, mesh)

    with implicit_replication():
        rules = cell_rules(mesh, "prefill_32k")
        params = placed(case["params"], tree_pspecs(case["params"], rules))
        prompt = {"tokens": case["prompt"]}
        with sharding_rules(rules):
            logits, cache = model.prefill_step(
                params, placed(prompt, batch_pspecs(prompt, rules)),
                max_len=case["max_len"])
        out["prefill_logits"] = logits.full_tensor()

        # the decode cell's rules: its cache placed by them (kv_seq over
        # 'model' where the KV heads do not divide it)
        rules = cell_rules(mesh, "decode_32k")
        cache = map_tree(
            lambda t, s: t.redistribute(mesh, placements(s, mesh)),
            cache, cache_pspecs(cache, rules))
        params = placed(case["params"], tree_pspecs(case["params"], rules))
        B, T = case["prompt"].shape
        step = {"tokens": case["next"],
                "cache_len": torch.full((B,), T, dtype=torch.int32)}
        step = placed(step, batch_pspecs(step, rules))
        with sharding_rules(rules):
            logits, cache = model.decode_step(params, cache, step["tokens"],
                                              step["cache_len"])
        out["decode_logits"] = logits.full_tensor()

        rules = cell_rules(mesh, "train_4k")
        p_specs = tree_pspecs(case["params"], rules)
        plain = map_tree(lambda t: t.clone(), case["params"])
        opt = init_opt_state(plain, model.opt_cfg)
        state = TrainState(placed(plain, p_specs),
                           placed(opt, opt_state_pspecs(opt, p_specs)),
                           placed(torch.zeros((), dtype=torch.int32), P()))
        batch = placed(case["batch"], batch_pspecs(case["batch"], rules))
        with sharding_rules(rules):
            _, grads = model.grad_step(state.params, batch)
            placed_as_params = all(
                g.placements == p.placements
                for g, p in zip(leaves(grads), leaves(state.params)))
            out["grads"] = full(grads)
            out["grads_placed_as_params"] = placed_as_params
            state, metrics = model.train_step(state, batch)
        out["loss"] = metrics["loss"].full_tensor()
        out["params"] = full(state.params)
    return out


def worker(rank, cases_path, results_path, workdir):
    store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        torch.manual_seed(0)
        cases = torch.load(cases_path, weights_only=False)
        results = [run_case(case, rank) for case in cases]
        if rank == 0:
            torch.save(results, results_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    mp.spawn(worker, args=tuple(sys.argv[1:4]), nprocs=WORLD, join=True)
