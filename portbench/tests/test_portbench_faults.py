"""A run driven to its end on the CPU at a tiny width, with the timed
path broken underneath, comes out not correct: a served token altered
where it is produced; a training step that returns its state unchanged;
half of the batch left out, the mean taken over the rest.  The sound
program at the same size comes out correct.  The control (the plain
reference in float8, in the program's place) reads far above the
program."""
import pytest
import torch

from portbench import serve, train
from portbench.run import run_cell

from conftest import tiny_cell

SEED = 2 ** 31 + 4242


class AlteredTokens:
    """The engine's serving with every served token bumped by one."""
    check = staticmethod(serve.check)

    @staticmethod
    def run(*a, **kw):
        out = serve.run(*a, **kw)
        for req, _ in out["finished"]:
            req.out_tokens[:] = [(t + 1) % 256 for t in req.out_tokens]
        return out


def _train_driver(broken_step):
    class Driver:
        check = staticmethod(train.check)

        @staticmethod
        def run(cell, seed, seconds, tracer, device, clock):
            from repro_torch.models import build_model
            from portbench.spec import port_config
            model = build_model(port_config(cell.spec), device,
                                train.optimizer(cell.traffic))
            return train.run(cell, seed, seconds, tracer, device, clock,
                             step_fn=broken_step(model))
    return Driver


def unchanged(model):
    """A step that computes the loss and returns its state as it was."""
    def step(state, batch):
        with torch.no_grad():
            return state, {"loss": model.loss_fn(state.params, batch)}
    return step


def half_batch(model):
    def step(state, batch):
        rows = batch["tokens"].shape[0] // 2
        return model.train_step(state, {"tokens": batch["tokens"][:rows]})
    return step


def _run(cell, driver=None):
    # a serving window long enough on a slow CPU for every client's first
    # request to finish (a decode step can take 0.2 s there)
    seconds = 4.0 if cell.kind == "serve" else 0.5
    return run_cell(cell.name, SEED, seconds, False, torch.device("cpu"),
                    cell=cell, driver=driver, clock=lambda: 0.0)


@pytest.mark.parametrize("kind", ["decoder", "mamba1"])
def test_serve_sound_and_altered(kind):
    cell = tiny_cell(kind, "serve", {"widest_gap": 0.05})
    assert _run(cell)["correct"]
    bad = _run(cell, AlteredTokens)
    assert not bad["correct"]
    assert bad["checked"]["widest_gap"]["value"] > 0.05


@pytest.mark.parametrize("kind", ["decoder", "mamba1"])
def test_train_sound_unchanged_and_half_batch(kind):
    lim = {"loss_gap": 3e-3, "first_grad_gap": 3e-2, "change_gap": 0.1}
    cell = tiny_cell(kind, "train", lim)
    assert _run(cell)["correct"]
    r = _run(cell, _train_driver(unchanged))
    assert not r["correct"]
    assert r["checked"]["change_gap"]["value"] == pytest.approx(1.0, abs=1e-6)
    r = _run(cell, _train_driver(half_batch))
    assert not r["correct"]


def test_control_reads_above_the_program(cpu):
    """At a size where rounding can flip the greedy token (a vocabulary of
    4,096), the float8 control's widest gap lies above the program's."""
    from dataclasses import replace
    from portbench.calibrate import serve_control
    cell = tiny_cell("decoder", "serve", {"widest_gap": 0.05})
    spec = replace(cell.spec, vocab=4096, d_model=128,
                   port=dict(cell.spec.port, vocab_size=4096, d_model=128))
    cell = replace(cell, spec=spec,
                   traffic=dict(cell.traffic, check_requests=3, new_tokens=8))
    kept = {}

    class Keep:
        run = staticmethod(serve.run)

        @staticmethod
        def check(*a, **kw):
            kept.update(serve.check(*a, detail=True, **kw))
            return kept
    r = _run(cell, Keep)
    ctrl = serve_control(cell, SEED, kept, cpu)
    assert ctrl["control_widest_gap"] > r["checked"]["widest_gap"]["value"]
    assert ctrl["altered_token_widest_gap"] > 0.05


@pytest.mark.parametrize("kind", ["decoder", "mamba1"])
def test_train_control_reads_above_the_program(kind, cpu):
    """The float8 reference's first steps, in the program's place, read a
    loss gap several times the sound program's."""
    from portbench.calibrate import train_control
    cell = tiny_cell(kind, "train", {"loss_gap": 3e-3, "first_grad_gap": 3e-2,
                                     "change_gap": 0.1})
    sound = _run(cell)["checked"]["loss_gap"]["value"]
    ctrl = train_control(cell, SEED, cpu)["control"]
    assert ctrl["loss_gap"] > 3 * sound
