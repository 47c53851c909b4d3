"""The port's BigStore decomposed delta checkpoints against the JAX
package's, on the CPU.

Every case of ``tests/test_checkpoint.py`` runs on the port's store
(supersession, quorum restore, host failure, anti-entropy revive,
compaction reclaim, delta-save byte accounting, torn saves), and the same
saves through both stores give the same stats, the same restored values
and the same stored bytes.  A packed shard is byte-identical to the JAX
package's for fp32, int32 and bf16 arrays (a bf16 tensor leaves as its
``uint16`` bits, tagged ``"bfloat16"``).  A train state saved and restored
through ``flatten_state`` / ``unflatten_state`` comes back bit-equal.
Shard *names* differ between the packages (the port keeps a dict per
layer, JAX stacks each group), so parity is asserted on bytes and values.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.bigstore import BigStore as JaxBigStore
from repro.checkpoint.bigstore import _pack_shard as jax_pack
from repro.checkpoint.bigstore import _unpack_shard as jax_unpack
from repro_torch.checkpoint import (BigStore, flatten_state, state_shard_names,
                                    unflatten_state)
from repro_torch.checkpoint.bigstore import _pack_shard, _unpack_shard
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.tree import leaves, leaves_with_path

RUN = b"run0"


def shards_at(step, n=6, scale=1.0):
    rng = np.random.default_rng(step)
    return {f"layer{i}/w": (rng.standard_normal((4, 8)) * scale).astype(np.float32)
            for i in range(n)}


def tensors(shards):
    return {k: torch.from_numpy(v) for k, v in shards.items()}


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), want)


class TestSaveRestore:
    def test_roundtrip(self):
        store = BigStore(4, replication=3)
        shards = shards_at(1)
        store.save(RUN, tensors(shards), step=1)
        got = store.restore(RUN, expect=shards.keys())
        for k, v in shards.items():
            step, arr = got[k]
            assert step == 1
            _eq(arr, v)

    def test_supersession_keeps_latest(self):
        store = BigStore(4)
        store.save(RUN, tensors(shards_at(1)), step=1, delta_only=False)
        s2 = shards_at(2)
        store.save(RUN, tensors(s2), step=2, delta_only=False)
        got = store.restore(RUN)
        for k in s2:
            step, arr = got[k]
            assert step == 2
            _eq(arr, s2[k])

    def test_delta_save_skips_unchanged(self):
        store = BigStore(4)
        shards = shards_at(1)
        r1 = store.save(RUN, tensors(shards), step=1)
        assert r1["written"] == len(shards)
        # identical content at step 2: everything skipped
        r2 = store.save(RUN, tensors(shards), step=2)
        assert r2["written"] == 0 and r2["skipped"] == len(shards)
        # change one shard only (the MoE-cold-expert pattern)
        shards2 = dict(shards)
        shards2["layer0/w"] = shards["layer0/w"] + 1
        r3 = store.save(RUN, tensors(shards2), step=3)
        assert r3["written"] == 1
        got = store.restore(RUN)
        assert got["layer0/w"][0] == 3
        assert got["layer1/w"][0] == 1  # old version still live

    def test_restore_with_dead_host(self):
        store = BigStore(5, replication=3)
        shards = shards_at(7, n=12)
        store.save(RUN, tensors(shards), step=7)
        store.kill(0)
        store.kill(3)
        got = store.restore(RUN, expect=shards.keys())
        assert len(got) == 12

    def test_restore_fails_below_quorum(self):
        store = BigStore(3, replication=2)
        shards = shards_at(1, n=8)
        store.save(RUN, tensors(shards), step=1)
        store.kill(0)
        store.kill(1)
        store.kill(2)
        with pytest.raises(RuntimeError):
            store.restore(RUN, expect=shards.keys())

    def test_revive_via_antientropy(self):
        store = BigStore(3, replication=2)
        shards = shards_at(1, n=6)
        store.save(RUN, tensors(shards), step=1)
        store.kill(1)
        store.revive(1)
        # the revived host must serve reads on its own for its keyrange
        got = store.restore(RUN, expect=shards.keys())
        assert len(got) == 6

    def test_compaction_reclaims_superseded(self):
        store = BigStore(3, replication=3)
        for step in range(1, 6):
            store.save(RUN, tensors(shards_at(step)), step=step,
                       delta_only=False)
        before = store.total_bytes()
        store.compact_all()
        after = store.total_bytes()
        assert after < before * 0.45  # 5 versions -> 1 live version
        got = store.restore(RUN)
        assert all(s == 5 for s, _ in got.values())

    def test_interrupted_save_is_safe(self):
        """A torn save never corrupts: old shard versions stay live."""
        store = BigStore(3)
        s1 = shards_at(1)
        store.save(RUN, tensors(s1), step=1)
        s2 = shards_at(2)
        # write only half of step 2's shards (crash mid-save)
        partial = dict(list(s2.items())[:3])
        store.save(RUN, tensors(partial), step=2, delta_only=False)
        got = store.restore(RUN, expect=s1.keys())
        for k in s1:
            step, arr = got[k]
            if k in partial:
                assert step == 2
            else:
                assert step == 1  # old version intact


# ------------------------------------------------------- against JAX
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_packed_shard_is_byte_identical(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 3, 4)) * 40
    if dtype == "bfloat16":
        arr = np.asarray(jnp.asarray(x, jnp.bfloat16))
        t = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16)
    else:
        arr = x.astype(dtype)
        t = torch.from_numpy(arr)
    raw = jax_pack(9, arr)
    assert _pack_shard(9, t) == raw
    assert _pack_shard(9, arr) == raw
    step, got = _unpack_shard(raw)
    assert step == 9 and str(got.dtype) == f"torch.{dtype}"
    assert torch.equal(got, t)
    _, back = jax_unpack(_pack_shard(9, t))
    np.testing.assert_array_equal(np.asarray(back, np.float64),
                                  np.asarray(arr, np.float64))


def test_scalar_shard_is_byte_identical():
    assert _pack_shard(4, torch.tensor(7, dtype=torch.int32)) == \
        jax_pack(4, np.asarray(jnp.asarray(7, jnp.int32)))


def test_same_saves_give_the_same_store():
    """The same saves, supersessions, a dead host and a compaction through
    both stores: the same stats, stored bytes and restored values."""
    jstore, tstore = JaxBigStore(4, replication=3), BigStore(4, replication=3)
    for step in (1, 2, 3):
        shards = shards_at(step, n=8)
        if step == 3:
            shards = dict(list(shards.items())[:5])
        assert tstore.save(RUN, tensors(shards), step=step) == \
            jstore.save(RUN, shards, step=step)
    assert tstore.total_bytes() == jstore.total_bytes()
    for store in (jstore, tstore):
        store.kill(2)
        store.compact_all()
    assert tstore.total_bytes() == jstore.total_bytes()
    want, got = jstore.restore(RUN), tstore.restore(RUN)
    assert sorted(got) == sorted(want)
    for name, (step, arr) in want.items():
        assert got[name][0] == step
        _eq(got[name][1], np.asarray(arr))


@pytest.mark.parametrize("moments", ["fp32", "factored"])
def test_train_state_round_trips_bit_equal(moments):
    import dataclasses
    cfg = dataclasses.replace(smoke_config("minitron-4b"), dtype="bfloat16",
                              optimizer_moments=moments)
    model = build_model(cfg, "cpu")
    state = model.init_train_state(3)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    state, _ = model.train_step(state, {"tokens": tok})
    saved = [t.clone() for t in leaves(state)]
    shards = flatten_state(state)
    names = state_shard_names(state)
    assert names == sorted(shards)
    assert "step" in names and "opt/step" in names
    assert "params/embed/tok" in names and "opt/mu/embed/tok/m" in names
    assert shards["params/embed/tok"].dtype == torch.bfloat16
    store = BigStore(3)
    store.save(RUN, shards, step=1)
    fresh = model.init_train_state(4)
    restored = unflatten_state(fresh, store.restore(RUN, expect=names))
    assert restored is fresh
    for (path, got), want in zip(leaves_with_path(restored), saved,
                                 strict=True):
        assert got.dtype == want.dtype, path
        assert torch.equal(got, want), path
