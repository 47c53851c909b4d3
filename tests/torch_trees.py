"""One comparison of two of the port's trees, leaf by leaf.

``leaves_with_path`` is a generator: a helper that asserts on its paths and
then zips it compares nothing.  :func:`assert_trees_close` materialises both
leaf lists, asserts the same paths, compares every leaf (dtype included) and
counts what it compared, so a tree that yields no leaf fails too.

An entry beyond ``rtol`` / ``atol`` fails unless ``excuse`` clears it:
``excuse(path, got, want)`` returns a bool mask of the entries a derived
limit of their own holds instead (:func:`bf16_ulps_apart`,
:func:`adam_step_at_rounding`).  Each such limit applies to its leaf class
only and says why in its docstring.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves_with_path


def _np(t):
    return t.detach().float().numpy()


def assert_trees_close(got, want, *, rtol, atol, excuse=None):
    """Every leaf of ``got`` against the leaf of ``want`` at its path;
    returns the paths compared."""
    got_l, want_l = list(leaves_with_path(got)), list(leaves_with_path(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    compared = 0
    for (path, g), (_, w) in zip(got_l, want_l, strict=True):
        assert g.dtype == w.dtype, path
        assert g.shape == w.shape, path
        gv, wv = _np(g), _np(w)
        over = ~np.isclose(gv, wv, rtol=rtol, atol=atol, equal_nan=True)
        if excuse is not None and over.any():
            over &= ~excuse(path, g, w)
        assert not over.any(), (
            f"{path}: {int(over.sum())} of {over.size} entries beyond rtol "
            f"{rtol} / atol {atol}, up to {np.abs(gv - wv)[over].max()}")
        compared += 1
    assert compared == len(want_l) > 0, (compared, len(want_l))
    return [p for p, _ in got_l]


def bf16_ulps(t):
    """A bf16 tensor's bits as a monotone int: adjacent values differ by 1."""
    bits = t.detach().contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def bf16_ulps_apart(n):
    """Excuse a bf16 entry at most ``n`` rounding steps (ulps) from its
    counterpart, on the raw bits; other dtypes get no excuse.

    For a bf16 AdamW moment after two steps, ``n = 2``: each step computes
    it in fp32 from gradients the two sides agree on to rounding, then
    rounds it to bf16 once.  The first rounding leaves two fp32 values much
    closer than an ulp at one value or at neighbours: one ulp apart at
    most.  The second step carries ``b1 = 0.9`` of that, under 1.8 ulps of
    a moment that fell at most one binade, and rounds to nearest again:
    below 2.8 ulps, so at most two.  A moment that cancels further keeps
    the absolute limit."""
    def excuse(path, got, want):
        if got.dtype != torch.bfloat16:
            return np.zeros(tuple(got.shape), bool)
        return np.abs(bf16_ulps(got) - bf16_ulps(want)) <= n
    return excuse


def adam_step_at_rounding(grads_got, grads_want, lr, grad_atol):
    """Excuse a parameter entry whose first step's gradient is at rounding
    level on both sides (within ``grad_atol``, the gradient comparison's
    own absolute limit, of zero) and whose sides are within ``2 * lr``.

    AdamW's first step moves an entry by ``lr * g / (|g| + eps)`` (and the
    weight decay both sides share): scale-free, each side's step is in
    ``(-lr, lr)``, so where ``g`` is a cancelling sum's rounding residue the
    two steps may differ by anything below ``2 * lr``.  A later step whose
    gradient is resolved agrees again: ``g_1`` enters its ``m_hat / sqrt(
    v_hat)`` only at the order of ``g_1 / g_2``."""
    grads_got = dict(leaves_with_path(grads_got))
    grads_want = dict(leaves_with_path(grads_want))

    def excuse(path, got, want):
        at_rounding = ((np.abs(_np(grads_got[path])) <= grad_atol)
                       & (np.abs(_np(grads_want[path])) <= grad_atol))
        apart = np.abs(_np(got) - _np(want))
        return at_rounding & (apart <= 2 * lr)
    return excuse
