"""``BatchedEISFitter.fit_stream`` and ``fit(adaptive=True)`` on the CPU in
float64 (``device="cpu"``), against the port's own sequential fits, bit for
bit.

The stream's batches are tests/test_parallel.py::test_fit_stream_matches_
sequential's sizes (6, 4, 6), drawn as tests/test_torch_batch.py draws its
spectra. On the CPU the stream runs the same fit and collect as on the card
without the side stream; tests/test_torch_cuda.py holds it on the card.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from hybdrt_torch import BatchedEISFitter

from test_torch_batch import FREQ, KW, _batch

BATCHES = [_batch(6, seed=11), _batch(4, seed=12), _batch(6, seed=13)]


@pytest.fixture(scope="module")
def fitters():
    return {fused: BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", pred_stop=True,
                                    qp_fused=fused, **KW)
            for fused in (False, True)}


def _assert_same(a, b):
    """Every field of two BatchFitResults bit for bit (lazy fields as
    tensors of the same dtype)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        assert type(x) is type(y), f
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, f
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("collect", ["lazy", "full"])
@pytest.mark.parametrize("adaptive", [False, "staged"])
def test_stream_matches_sequential(fitters, fused, collect, adaptive):
    """One result per batch, in input order, each bitwise the sequential
    fit's, over batches of mixed sizes."""
    tf = fitters[fused]
    seq = [tf.fit(z, adaptive=adaptive, collect=collect) for z in BATCHES]
    stream = list(tf.fit_stream(iter(BATCHES), adaptive=adaptive, collect=collect))
    assert len(stream) == len(BATCHES)
    for a, b in zip(seq, stream):
        _assert_same(a, b)
        lazy = isinstance(b.weights, torch.Tensor) and isinstance(b.s_vectors, torch.Tensor)
        assert lazy == (collect == "lazy")


def test_stream_defaults_are_staged_and_lazy(fitters):
    tf = fitters[False]
    out = list(tf.fit_stream(BATCHES[:2]))
    for a, b in zip([tf.fit(z, adaptive="staged", collect="lazy") for z in BATCHES[:2]], out):
        _assert_same(a, b)


@pytest.mark.parametrize("kw,match", [
    ({"adaptive": True}, "adaptive="), ({"adaptive": np.True_}, "adaptive="),
    ({"adaptive": 1}, "adaptive="), ({"adaptive": "stage"}, "adaptive="),
    ({"collect": "eager"}, "collect="),
], ids=["true", "np-true", "one", "typo", "collect"])
def test_stream_rejects(fitters, kw, match):
    """adaptive=True raises as in the JAX package, and so does any other
    value than False or "staged", and a bad collect, at the call."""
    with pytest.raises(ValueError, match=match):
        fitters[False].fit_stream(BATCHES, **kw)


def test_empty_stream(fitters):
    assert list(fitters[False].fit_stream([])) == []
    assert list(fitters[False].fit_stream(iter(()))) == []


def test_stream_bad_batch_raises(fitters):
    """A batch on another grid raises out of the generator, as fit does,
    once the results of the batches before it are yielded, and so does an
    input iterable that raises."""
    tf = fitters[False]
    gen = tf.fit_stream([BATCHES[0], BATCHES[1], BATCHES[2][:, :-1]])
    got = [next(gen), next(gen)]
    with pytest.raises(ValueError, match="z_batch shape"):
        next(gen)
    for z, res in zip(BATCHES, got):
        _assert_same(res, tf.fit(z, adaptive="staged", collect="lazy"))

    def failing():
        yield BATCHES[1]
        raise RuntimeError("input failed")

    gen = tf.fit_stream(failing())
    _assert_same(next(gen), tf.fit(BATCHES[1], adaptive="staged", collect="lazy"))
    with pytest.raises(RuntimeError, match="input failed"):
        next(gen)


@pytest.mark.parametrize("how", ["break", "close"])
def test_stream_consumer_stops_early(fitters, how):
    """A consumer that takes the first result and stops: the result is the
    sequential fit's, and the generator finishes without drawing the rest of
    an endless input."""
    tf = fitters[False]
    drawn = []

    def endless():
        while True:
            drawn.append(len(drawn))
            yield BATCHES[(len(drawn) - 1) % 3]

    gen = tf.fit_stream(endless())
    if how == "break":
        for first in gen:
            break
    else:
        first = next(gen)
    gen.close()
    _assert_same(first, tf.fit(BATCHES[0], adaptive="staged", collect="lazy"))
    assert len(drawn) == 3  # the first result comes once the second batch's loop has run
    with pytest.raises(StopIteration):
        next(gen)


def test_stream_keeps_no_batch(fitters, monkeypatch):
    """Once a batch's result is yielded, the generator holds nothing of that
    batch's loop state (the result holds its lazy fields only), and each
    lazy field is its own allocation, not a view of a larger tensor."""
    tf = fitters[False]
    states = []
    fit_plain = tf._fit_plain

    def watched(rzv):
        out = fit_plain(rzv)
        states.append(weakref.ref(out))
        return out

    monkeypatch.setattr(tf, "_fit_plain", watched)
    kept = []
    for k, res in enumerate(tf.fit_stream(BATCHES)):
        gc.collect()
        assert states[k]() is None, f"batch {k}'s loop state is still referenced"
        for t in (res.weights, res.s_vectors):
            assert t._base is None
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
        kept.append(res)
    assert len(kept) == 3


@pytest.mark.parametrize("pred_stop", [False, True])
def test_adaptive_true_matches_plain_bitwise(pred_stop):
    """tests/test_parallel.py::test_adaptive_matches_plain_bitwise on the
    port: adaptive=True runs the live-lane loop, bitwise adaptive=False."""
    tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", pred_stop=pred_stop, **KW)
    z = _batch(10, seed=3)
    _assert_same(tf.fit(z, adaptive=True), tf.fit(z))
    _assert_same(tf.fit(z, adaptive=True, collect="lazy"), tf.fit(z, collect="lazy"))


@pytest.mark.parametrize("adaptive", [True, "staged"])
def test_phase_budgets_raise(fitters, adaptive):
    """The live-lane loop has no compaction schedule, so phase_budgets
    raises for both adaptive modes."""
    with pytest.raises(ValueError, match="phase_budgets"):
        fitters[False].fit(BATCHES[1], adaptive=adaptive, phase_budgets=(8, 20))
