"""The port's MoE decoders (`repro_torch.models.moe`, the MoE block of
`models.transformer`, `configs/{olmoe_1b_7b,kimi_k2_1t_a32b}.py`) held
against the JAX package on the same inputs: numpy arrays made from a seed,
and the reference's own parameters (`materialize` at a key) moved to the
port through `weights.params_from_numpy`.  f32 smoke configs.

Tolerances: 1e-5 of the largest magnitude for block outputs, logits and
the loss; 1e-5 of each leaf's largest entry for gradients.  Inside the
port, the routing is exact: the same pairs are dropped as in the
reference (checked against the dense oracle with the dropped pairs' gates
zeroed), and a forward and backward is bitwise run to run.  Prefill then
decode is held against the port's own full forward, at a capacity where
no pair is dropped: the capacity is computed over the tokens of a call,
so a prefill and a full forward can drop different pairs (in either
package).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.models import moe as JM, transformer as JT
from repro.models.module import count_params as jcount, is_spec
from repro.models.module import materialize as jmaterialize
from repro_torch import weights as W
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import get_model, moe as M, transformer as T
from repro_torch.models.module import count_params
from repro_torch.optim.grad import microbatch_grads
from repro_torch.tree import tree_flatten_with_path

MOE = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch="olmoe-1b-7b", **kw):
    return (jsmoke(jget_config(arch)).replace(**kw),
            smoke_config(get_config(arch)).replace(**kw))


def _block(arch="olmoe-1b-7b", **kw):
    """(reference cfg, port cfg, reference block params, port params)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = jmaterialize(JM.moe_specs(jcfg), jax.random.key(1))
    return jcfg, cfg, jp, W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(S, seed=0, d=64):
    return np.random.default_rng(seed).standard_normal((2, S, d)).astype(np.float32)


def _kept(cfg, expert_idx: np.ndarray, C: int) -> np.ndarray:
    """[T, k] bool: the reference's rule, in numpy: the pairs stable-sorted
    by expert, the first C of each expert kept."""
    e = expert_idx.reshape(-1)
    order = np.argsort(e, kind="stable")
    keep = np.zeros(e.shape, bool)
    seen = np.zeros(cfg.n_experts, int)
    for i in order:
        keep[i] = seen[e[i]] < C
        seen[e[i]] += 1
    return keep.reshape(expert_idx.shape)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_configs_equal_the_reference_field_for_field(arch):
    want, got = jget_config(arch), get_config(arch)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(b) == f"torch.{jnp.dtype(a).name}", f.name
        else:
            assert a == b, f.name
    assert get_model(got).family == "decoder" and got.moe


@pytest.mark.parametrize("arch,layers,n", [("olmoe-1b-7b", 16, 6_919_100_416),
                                           ("olmoe-1b-7b", 4, 1_884_310_528),
                                           ("kimi-k2-1t-a32b", 1, 19_395_138_560)])
def test_full_size_specs_equal_the_reference(arch, layers, n):
    """The full-width parameter trees (specs only, nothing allocated):
    the reference's shapes and dtypes, the router in f32 in a bf16 model."""
    jcfg = jget_config(arch).replace(n_layers=layers)
    cfg = get_config(arch).replace(n_layers=layers)
    js, ts = JT.decoder_specs(jcfg), T.decoder_specs(cfg)
    assert count_params(ts) == jcount(js) == n
    tl = tree_flatten_with_path(ts)
    jl = jax.tree_util.tree_flatten_with_path(js, is_leaf=is_spec)[0]
    assert len(jl) == len(tl)
    for (path, s), (_, j) in zip(tl, jl):
        assert s.shape == j.shape, path
        assert str(s.dtype) == f"torch.{jnp.dtype(j.dtype).name}", path
        if path[-1] == "router":
            assert s.dtype == torch.float32
            assert s.shape[-2:] == (cfg.d_model, cfg.n_experts)


def test_bf16_reference_tree_crosses_with_its_dtypes():
    jcfg = jsmoke(jget_config("olmoe-1b-7b")).replace(param_dtype=jnp.bfloat16,
                                                       scan_layers=True)
    jp = jmaterialize(JT.decoder_specs(jcfg), jax.random.key(0))
    tp = W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", dtype=None)
    mlp = tp["units"]["global"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["wi"].dtype == torch.bfloat16
    assert mlp["wi"].shape == (2, 8, 64, 128)             # [U, E, d, f]
    for a, w in zip(jax.tree.leaves(W.to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(
                        lambda x: np.asarray(x, np.float32), jp))):
        assert np.array_equal(a, w)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def test_router_probs_and_load_balance_loss_equal_the_reference():
    jcfg, cfg, jp, tp = _block()
    xt = _x(20)[0]
    _close(M.router_probs(cfg, tp, _t(xt)),
           JM.router_probs(jcfg, jp, jnp.asarray(xt)), what="probs")
    probs = np.asarray(JM.router_probs(jcfg, jp, jnp.asarray(xt)))
    idx = np.argsort(-probs, axis=-1)[:, :cfg.top_k]
    _close(M.load_balance_loss(_t(probs), _t(idx), cfg.n_experts),
           JM.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx),
                                cfg.n_experts), what="aux")
    assert M.capacity(cfg, 20) == JM.capacity(jcfg, 20) == 8
    assert M.capacity(cfg, 1000) == JM.capacity(jcfg, 1000) == 320


@pytest.mark.parametrize("cf,S", [(1.25, 12), (0.3, 48), (1.0, 64)])
@pytest.mark.parametrize("impl", ["dispatch", "blockwise", "dense", "shardmap"])
def test_moe_block_equals_the_reference(impl, cf, S):
    jcfg, cfg, jp, tp = _block(moe_impl=impl, capacity_factor=cf)
    x = _x(S, seed=S)
    y, aux = M.moe_block(cfg, tp, _t(x))
    jy, jaux = JM.moe_block(jcfg, jp, jnp.asarray(x))
    _close(y, jy, what=f"{impl} y")
    _close(aux, jaux, what=f"{impl} aux")


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_drops_the_reference_pairs(arch):
    """At capacity_factor 0.3 pairs are dropped; the kept ones are the
    reference's (stable order by expert, then token), and dispatch equals
    the dense oracle with the dropped pairs' gates zeroed."""
    jcfg, cfg, jp, tp = _block(arch, capacity_factor=0.3)
    x = _t(_x(48, seed=4))
    xt = x.reshape(-1, cfg.d_model)
    gate, idx, _ = M._route(cfg, tp, xt)
    C = M.capacity(cfg, xt.shape[0])
    keep = _kept(cfg, idx.numpy(), C)
    assert 0 < (~keep).sum() and keep.sum() == cfg.n_experts * C - (
        np.maximum(C - np.bincount(idx.numpy().ravel(),
                                   minlength=cfg.n_experts), 0).sum())
    y, _ = M.moe_block(cfg, tp, x)
    oracle = M._moe_dense_combine(cfg, tp, x, gate * _t(keep), idx)
    _close(y, oracle, what="dispatch vs the oracle on the kept pairs")
    jy, _ = JM.moe_block(jcfg, jp, jnp.asarray(x.numpy()))
    _close(y, jy, what="dispatch vs the reference")


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_equals_the_dense_oracle_at_ample_capacity(arch):
    _, cfg, _, tp = _block(arch, capacity_factor=4.0)   # C >= T: no drop
    x = _t(_x(40, seed=2))
    y, aux = M.moe_block(cfg, tp, x)
    yd, auxd = M.moe_block(cfg.replace(moe_impl="dense"), tp, x)
    _close(y, yd, what="dispatch vs dense")
    assert torch.equal(aux, auxd)


@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_block_gradients_equal_the_reference_and_repeat_bitwise(cf):
    """d/d(x, params) of sum(y * w) + aux through the dispatch's gathers,
    against `jax.grad`; two runs bitwise."""
    jcfg, cfg, jp, tp = _block(capacity_factor=cf)
    x = _x(48, seed=6)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_block(jcfg, p, xx)
        return (y * w).sum() + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    def run():
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xx = _t(x).clone().requires_grad_(True)
        y, aux = M.moe_block(cfg, p, xx)
        ((y * _t(w)).sum() + aux).backward()
        return {k: v.grad for k, v in p.items()}, xx.grad

    (g1, gx1), (g2, gx2) = run(), run()
    _close(gx1, jg[1], what="d/dx")
    for k in tp:
        _close(g1[k], jg[0][k], what=f"d/d{k}")
        assert torch.equal(g1[k], g2[k])
    assert torch.equal(gx1, gx2)


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------

def _models(arch, scan=False, **kw):
    jcfg, cfg = _cfgs(arch, scan_layers=scan, **kw)
    jp = jmaterialize(JT.decoder_specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_equal_the_reference(arch, scan):
    """CE + z + 0.01 * aux, and its gradients, against `jax.grad`."""
    jcfg, cfg, jp, tp = _models(arch, scan)
    b = _batch(cfg, 2, 24, seed=7)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bb: JT.loss_fn(jcfg, p, bb)))(
        jp, jax.tree.map(jnp.asarray, b))
    tl, tg = microbatch_grads(lambda p, bb: T.loss_fn(cfg, p, bb), tp,
                              {k: _t(v) for k, v in b.items()}, 1)
    _close(tl, jl, what="loss")
    got = jax.tree.leaves(W.to_numpy(tg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        _close(a, w, what="gradient leaf")
    # the aux loss is in it: the router's gradient is not CE's alone
    x = T.embed_inputs(cfg, tp, _t(b["tokens"]))
    _, aux = T.backbone(cfg, tp, x, torch.arange(24))
    assert float(aux) > 0


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_teacher_forced_decode_equals_the_reference(arch, scan):
    jcfg, cfg, jp, tp = _models(arch, scan)
    toks = _batch(cfg, 2, 10, seed=3)["tokens"]
    c, jc = T.init_cache(cfg, 2, 10), JT.init_cache(jcfg, 2, 10)
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg))
    for t in range(10):
        pos = np.full((2,), t, np.int32)
        lg, c = T.decode_step(cfg, tp, _t(toks[:, t:t + 1]), c, _t(pos))
        jlg, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                          jnp.asarray(pos))
        _close(lg, jlg, what=f"decode step {t}")


@pytest.mark.parametrize("arch,S", [("olmoe-1b-7b", 12), ("kimi-k2-1t-a32b", 20)])
def test_prefill_then_decode_equals_the_full_forward(arch, S):
    """prefill(S, max_seq=S+n) then n decode steps against the full forward
    over S+n, at a capacity with no drop (see the module docstring); the
    prefill alone against the forward over S at the config's capacity."""
    _, cfg, _, tp = _models(arch, scan=arch == "olmoe-1b-7b")
    n = 8
    toks = torch.randint(0, cfg.vocab_size, (2, S + n),
                         generator=torch.Generator().manual_seed(S))
    lg, _ = T.prefill(cfg, tp, toks[:, :S])
    _close(lg, T.forward_logits(cfg, tp, toks[:, :S], start=S - 1)[:, 0],
           what="prefill at capacity_factor 1.25")
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    full = T.forward_logits(cfg, tp, toks, start=S - 1)
    lg, cache = T.prefill(cfg, tp, toks[:, :S], max_seq=S + n)
    _close(lg, full[:, 0], what="prefill")
    for i in range(n):
        lg, cache = T.decode_step(cfg, tp, toks[:, S + i:S + i + 1], cache,
                                  torch.full((2,), S + i))
        _close(lg, full[:, i + 1], what=f"decode {i}")
