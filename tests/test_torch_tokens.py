"""The port's token stream and batch iterators against the JAX package's:
pure numpy on both sides, so every output is array_equal (no tolerance)."""
import numpy as np
import pytest

from repro.data import spiral as JSPIRAL, tokens as JTOK
from repro_torch.data import spiral as SPIRAL, tokens as TOK


@pytest.mark.parametrize("batch,vocab,seq,seed", [
    (4, 64, 64, 1234), (3, 16, 5, 1235), (1, 7, 2, 0)])
def test_token_lm_stream_array_equal(batch, vocab, seq, seed):
    got = TOK.token_lm_stream(batch, vocab, seq=seq, seed=seed)
    want = JTOK.token_lm_stream(batch, vocab, seq=seq, seed=seed)
    # across sequence boundaries, and back to an earlier sequence (the
    # memoised sequence is replaced, as a restarted trainer needs)
    steps = list(range(3 * seq + 2)) + [seq + 1, 0, 5 * seq - 1]
    for t in steps:
        (x, y), (jx, jy) = got(t), want(t)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == jx.dtype == np.float32
        assert y.dtype == jy.dtype == np.int32
        assert (x.sum(axis=1) == 1).all() and x.shape == (batch, vocab)


@pytest.mark.parametrize("kw", [
    dict(batch=4, seq=16, vocab=64),
    dict(batch=6, seq=9, vocab=11, shard=1, n_shards=3, seed=7),
    dict(batch=2, seq=12, vocab=32, n_patches=3),
    dict(batch=2, seq=8, vocab=32, frames=(5, 4))])
def test_synthetic_token_batches_array_equal(kw):
    got = TOK.synthetic_token_batches(**kw)
    want = JTOK.synthetic_token_batches(**kw)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_tokens_for_array_equal():
    for seed in (0, 1234 * 1_000_003 + 5):
        np.testing.assert_array_equal(TOK._tokens_for(seed, 5, 33, 64),
                                      JTOK._tokens_for(seed, 5, 33, 64))


@pytest.mark.parametrize("batch,T,n,seed,time_major", [
    (32, 17, 10_000, 0, True), (5, 9, 257, 3, False), (1, 4, 10, 1, True)])
def test_spiral_batches_array_equal(batch, T, n, seed, time_major):
    got = SPIRAL.spiral_batches(batch, T=T, n_samples=n, seed=seed,
                                time_major=time_major)
    want = JSPIRAL.spiral_batches(batch, T=T, n_samples=n, seed=seed,
                                  time_major=time_major)
    for _ in range(4):
        (x, y), (jx, jy) = next(got), next(want)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        assert x.shape == ((T, batch, 2) if time_major else (batch, T, 2))
