"""The port's serving path (`repro_torch.runtime.serving.Engine`,
`repro_torch.launch.serve`) held against the JAX package's on the same
parameters: the reference Engine's default draw (`materialize` at key 0)
moved to the port through numpy.  Greedy decoding only: the port's gumbel
noise comes from a torch.Generator and cannot equal `jax.random`'s.
Token ids must be equal; the logits behind them agree to f32 round-off
(`tests/test_torch_rwkv.py`).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.runtime.serving import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import weights as W
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as SERVE
from repro_torch.runtime.serving import Engine, ServeConfig

SRC = Path(__file__).resolve().parents[1] / "src"


def _engines(**scfg):
    """(reference engine, port engine on the reference's parameters)."""
    jeng = JEngine(jsmoke(jget_config("rwkv6-3b")), JServeConfig(**scfg))
    params = W.params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu",
                                 dtype=None)
    eng = Engine(smoke_config(get_config("rwkv6-3b")), ServeConfig(**scfg),
                 params=params, device="cpu")
    return jeng, eng


def test_greedy_generate_equals_reference():
    jeng, eng = _engines(batch_slots=2, max_seq=32)
    prompts = [[1, 2, 3], [4, 5]]
    want = jeng.generate(prompts, max_new=6)
    got = eng.generate(prompts, max_new=6)
    assert got == want
    assert all(len(o) == 6 for o in got) and eng.failed_requests == set()
    # more requests than slots: finished slots are refilled from the queue.
    # The reference's reused slot keeps the last request's recurrent state
    # (ROADMAP Queue 3, fault 6), so the port is held against the reference
    # serving each request alone, in a fresh engine
    prompts = [[7, 8, 9, 10], [11], [12, 13], [14, 15, 16]]
    alone = [JEngine(jeng.cfg, JServeConfig(batch_slots=2, max_seq=32),
                     params=jeng.params).generate([p], max_new=4)[0]
             for p in prompts]
    assert eng.generate(prompts, max_new=4) == alone


def _traced(eng):
    """Record every live slot's logits at every engine step, keyed by
    (the slot's prompt, its position)."""
    owner, rec = {}, {}
    add, decode = eng.add_request, eng.api.decode_step

    def add_request(prompt):
        slot = add(prompt)
        if slot is not None:
            owner[slot] = tuple(prompt)
        return slot

    def decode_step(cfg, params, token, cache, pos):
        logits, cache = decode(cfg, params, token, cache, pos)
        for b in np.where(eng.live)[0]:
            rec[(owner[int(b)], int(eng.pos[b]))] = logits[b].clone()
        return logits, cache

    eng.add_request = add_request
    eng.api = dataclasses.replace(eng.api, decode_step=decode_step)
    return rec


@pytest.mark.parametrize("arch", ["rwkv6-3b", "gemma2-2b"])
def test_a_reused_slot_starts_from_a_zero_state(arch):
    """6 prompts over 4 slots: every request's logits at every step within
    1e-5 of the same request served alone, and the same greedy tokens
    (the reference's engine fails this for RWKV6: fault 6)."""
    cfg = smoke_config(get_config(arch))
    scfg = ServeConfig(batch_slots=4, max_seq=32)
    eng = Engine(cfg, scfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 9)).tolist()
               for _ in range(6)]
    rec = _traced(eng)
    outs = eng.generate(prompts, max_new=8)
    for p, out in zip(prompts, outs):
        solo = Engine(cfg, scfg, params=eng.params, device="cpu")
        srec = _traced(solo)
        assert solo.generate([p], max_new=8) == [out]
        keys = [k for k in srec if k[0] == tuple(p)]
        assert len(keys) == len(p) + 8 - 1
        for k in keys:
            want = srec[k]
            err = float((rec[k] - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (k, err)


def test_per_request_budget_fails_only_stuck_request():
    jeng, eng = _engines(batch_slots=2, max_seq=32, max_request_steps=6)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [4, 5]]
    want = jeng.generate(prompts, max_new=3)
    got = eng.generate(prompts, max_new=3)
    assert got == want
    assert eng.failed_requests == jeng.failed_requests == {0}
    assert len(got[0]) < 3 and len(got[1]) == 3


def test_sampling_is_seeded_on_the_generator():
    cfg = smoke_config(get_config("rwkv6-3b"))
    outs = []
    for seed in (3, 3, 4):
        eng = Engine(cfg, ServeConfig(batch_slots=2, max_seq=32, temperature=1.0,
                                      seed=seed), device="cpu")
        outs.append(eng.generate([[1, 2, 3], [4, 5]], max_new=8))
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_serve_launcher_smoke_on_cpu(capsys):
    out = SERVE.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu"])
    s = out["summary"]
    assert s["requests"] == 6 and s["tokens"] == 6 * 12 and s["failed"] == 0
    assert out["failed_requests"] == [] and all(len(o) == 12 for o in out["outputs"])
    assert '"tok_per_s"' in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    # the dense and MoE decoders and the rglru model are ported and serve
    # (match None); the encoder-decoder is not
    (["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu"], None),
    (["--arch", "whisper-large-v3", "--smoke", "--device", "cpu"], "item 14"),
    (["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
      "--metrics-dir", "x", "--trace"], None),
    # telemetry is ported: beside an unported arch it still meets the refusal
    (["--arch", "whisper-large-v3", "--smoke", "--device", "cpu",
      "--metrics-dir", "x", "--trace"], "item 14"),
])
def test_serve_launcher_rejects_what_is_not_ported(argv, match, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    if match is None:
        out = SERVE.main(argv)
        assert out["failed_requests"] == [] and out["summary"]["tokens"] == 72
        return
    with pytest.raises(NotImplementedError, match=match):
        SERVE.main(argv)
    assert list(tmp_path.iterdir()) == []


def test_engine_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, ServeConfig())


def test_serve_entry_point_raises_without_cuda():
    code = """
import torch
torch.cuda.is_available = lambda: False
from repro_torch.launch import serve
try:
    serve.main(['--arch', 'rwkv6-3b', '--smoke'])
except RuntimeError as e:
    print('raised:', e)
else:
    raise SystemExit('ran without CUDA')
"""
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(SRC)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "raised: CUDA is not available" in r.stdout
