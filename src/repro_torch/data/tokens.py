"""Deterministic synthetic LM token stream (no external corpora).

A numpy copy of `repro.data.tokens`: a Markov-ish token generator keyed by
(seed, sequence), so a restarted worker replays its exact stream.  Its
outputs are `array_equal` to the reference's for the same arguments
(tested).
"""
from __future__ import annotations

import numpy as np


def _tokens_for(seed: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # low-order structure so losses are learnable: a random walk over the
    # token space mixed with uniform resets
    base = rng.integers(0, vocab, size=(batch, 1))
    steps = rng.integers(-32, 33, size=(batch, seq))
    walk = (base + np.cumsum(steps, axis=1)) % vocab
    resets = rng.random((batch, seq)) < 0.05
    uni = rng.integers(0, vocab, size=(batch, seq))
    return np.where(resets, uni, walk).astype(np.int32)


def token_lm_stream(batch: int, vocab: int, *, seq: int = 64,
                    seed: int = 1234):
    """Step-keyed single-token view of the stream, the online RTRL
    workload: stream(t) -> (x_t [B, vocab] one-hot float32, y_t [B] int32
    next-token labels).  Global step t reads position t % seq of sequence
    t // seq ([B, seq+1] tokens drawn from seed * 1_000_003 + sequence),
    one sequence memoised between calls."""
    cache: dict = {}

    def stream(t: int):
        s, pos = divmod(int(t), seq)
        if cache.get("s") != s:
            cache["s"] = s
            cache["toks"] = _tokens_for(seed * 1_000_003 + s, batch,
                                        seq + 1, vocab)
        toks = cache["toks"]
        x = np.zeros((batch, vocab), dtype=np.float32)
        x[np.arange(batch), toks[:, pos]] = 1.0
        return x, toks[:, pos + 1].astype(np.int32)

    return stream


def synthetic_token_batches(batch: int, seq: int, vocab: int, *,
                            shard: int = 0, n_shards: int = 1,
                            seed: int = 1234, n_patches: int = 0,
                            frames: tuple | None = None, d_model: int = 0):
    """Yields batches {'tokens', 'labels'[, 'patch_embeds'][, 'frames']}.

    `shard` / `n_shards` partition the stream deterministically: rows
    [shard::n_shards] of a global batch, keyed by (seed, step)."""
    step = 0
    local = batch // n_shards if n_shards > 1 else batch
    while True:
        key = seed * 1_000_003 + step
        toks = _tokens_for(key, batch, seq + 1, vocab)
        toks = toks[shard::n_shards][:local] if n_shards > 1 else toks
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if n_patches > 0:
            rng = np.random.default_rng(key + 1)
            out["patch_embeds"] = rng.standard_normal(
                (local, n_patches, 4096)).astype(np.float32) * 0.02
            out["labels"][:, :n_patches] = -1
        if frames is not None:
            rng = np.random.default_rng(key + 2)
            out["frames"] = rng.standard_normal(
                (local,) + frames).astype(np.float32) * 0.02
        yield out
        step += 1
