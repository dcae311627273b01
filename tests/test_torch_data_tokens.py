"""Port parity of the synthetic token pipeline (``repro_torch.data.tokens``
against ``repro.data.tokens``): the same seed gives the same int32 batches,
bit for bit, and the prefetcher keeps order, stops and holds at most its
depth ahead of the consumer."""

import time

import numpy as np
import pytest

from repro.data import tokens as J
from repro_torch.data import tokens as T


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 16, 4, 0), (1000, 33, 3, 7), (49_152, 128, 2, 1), (151_936, 8, 5, 123)])
def test_batches_bit_equal_to_jax(vocab, seq, batch, seed):
    j, t = J.SyntheticTokens(vocab, seq, batch, seed=seed), T.SyntheticTokens(
        vocab, seq, batch, seed=seed)
    for _ in range(3):
        (tj, yj), (tt, yt) = j.next_batch(), t.next_batch()
        assert tt.dtype == np.int32 and yt.dtype == np.int32
        assert tt.shape == (batch, seq) and yt.shape == (batch, seq)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(tt[:, 1:], yt[:, :-1])  # targets shifted by one
        assert 0 <= tt.min() and tt.max() < vocab


def test_iteration_matches_next_batch():
    a, b = T.SyntheticTokens(300, 6, 2, seed=4), T.SyntheticTokens(300, 6, 2, seed=4)
    it = iter(a)
    for _ in range(2):
        np.testing.assert_array_equal(next(it)[0], b.next_batch()[0])


@pytest.mark.parametrize("vocab,alpha", [(100, 1.1), (49_152, 1.1), (257, 0.7)])
def test_zipf_logits_equal(vocab, alpha):
    got, want = T.zipf_logits(vocab, alpha), J.zipf_logits(vocab, alpha)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    p = np.exp(got)
    assert p[0] > p[vocab // 2] > p[-1]


def test_prefetcher_keeps_order_and_stops():
    pf = T.Prefetcher(iter(range(10)), depth=2)
    assert [next(pf) for _ in range(10)] == list(range(10))
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_respects_its_depth():
    produced = []

    def source():
        for i in range(20):
            produced.append(i)
            yield i

    pf = T.Prefetcher(source(), depth=3)
    deadline = time.monotonic() + 5.0
    while len(produced) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    # three items queued, and the producer blocked on putting a fourth
    assert len(produced) == 4
    assert next(pf) == 0
    deadline = time.monotonic() + 5.0
    while len(produced) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert len(produced) == 5
    assert list(pf) == list(range(1, 20))
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()
