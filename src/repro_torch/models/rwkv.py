"""RWKV6 "Finch": data-dependent decay linear recurrence (attention-free).

Counterpart of `repro.models.rwkv`.  Time-mix state per head:

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t,
    o_t = r_t^T (diag(u) k_t (x) v_t + S_{t-1})

with per-channel decay w_t = exp(-exp(ww_t)) from a data-dependent LoRA,
plus data-dependent token-shift lerps (ddlerp) for r/k/v/w/g.  A prompt goes
through the chunked WKV (`wkv_full`, kernel K4 on CUDA tensors); decoding
steps the recurrence one token at a time (`wkv_step`).  Training
(`loss_fn`) differentiates through the plain chunked WKV
(`kernels.wkv.wkv_reference`), chosen explicitly by `plain=True`: the
reference trains through its plain `wkv_chunk` scan under autodiff, never
through the Pallas kernel, and K4 has no backward.

Parameters keep the reference's tree: with ``cfg.scan_layers`` the layers'
``units`` are stacked ``[L, ...]`` tensors (looped over in Python, as
``lax.scan`` does), otherwise a list of per-layer dicts.  The remat policy
wraps the layer.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import wkv as WK
from repro_torch.kernels.wkv import wkv_chunk  # noqa: F401  (re-exported)
from repro_torch.models.layers import (embed_tokens, embedding_specs, lm_logits,
                                       rmsnorm_spec)
from repro_torch.models.module import (ParamSpec, constant_init, fan_in_normal,
                                       normal, ones_init, stack_specs, zeros_init)
from repro_torch.models.transformer import _maybe_remat, _norm, chunked_ce_loss
from repro_torch.tree import stack, unstack

LORA_R = 32      # ddlerp LoRA rank
LORA_W = 64      # decay LoRA rank


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.head_dim


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def time_mix_specs(cfg: ModelConfig) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    H, D = n_heads(cfg), cfg.head_dim
    s: dict[str, Any] = {"mu_x": ParamSpec((d,), pd, normal(0.1), ("embed",))}
    for c in ("w", "k", "v", "r", "g"):
        s[f"mu_{c}"] = ParamSpec((d,), pd, normal(0.1), ("embed",))
    # fused ddlerp LoRAs: one [d, 4, r] matmul for (k,v,r,g) + one for w
    s["lora_kvrg_a"] = ParamSpec((d, 4, LORA_R), pd, fan_in_normal(0),
                                 ("embed", None, None))
    s["lora_w_a"] = ParamSpec((d, LORA_W), pd, fan_in_normal(), ("embed", None))
    for c in ("w", "k", "v", "r", "g"):
        rank = LORA_W if c == "w" else LORA_R
        s[f"lora_{c}_b"] = ParamSpec((rank, d), pd, zeros_init(), (None, "embed_tp"))
    s["w0"] = ParamSpec((d,), torch.float32, constant_init(-0.7), ("embed",))
    s["u"] = ParamSpec((H, D), torch.float32, normal(0.3), ("heads", "head_dim"))
    # fused r/k/v/g projection: [d, 4, d] (one matmul)
    s["W_rkvg"] = ParamSpec((d, 4, d), pd, fan_in_normal(0),
                            ("embed_tp", None, "q_out"))
    s["Wo"] = ParamSpec((d, d), pd, fan_in_normal(), ("q_out", "embed_tp"))
    s["ln_x_scale"] = ParamSpec((d,), pd, ones_init(), ("embed",))
    s["ln_x_bias"] = ParamSpec((d,), pd, zeros_init(), ("embed",))
    return s


def channel_mix_specs(cfg: ModelConfig) -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mu_k": ParamSpec((d,), pd, normal(0.1), ("embed",)),
        "mu_r": ParamSpec((d,), pd, normal(0.1), ("embed",)),
        "Wk": ParamSpec((d, f), pd, fan_in_normal(), ("embed_tp", "mlp")),
        "Wv": ParamSpec((f, d), pd, fan_in_normal(), ("mlp", "embed_tp")),
        "Wr": ParamSpec((d, d), pd, fan_in_normal(), ("embed_tp", "q_out")),
    }


def layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "tm": time_mix_specs(cfg),
        "ln2": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "cm": channel_mix_specs(cfg),
    }


def rwkv_model_specs(cfg: ModelConfig) -> dict:
    specs: dict[str, Any] = {"emb": embedding_specs(cfg)}
    specs["ln0"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    u = layer_specs(cfg)
    specs["units"] = stack_specs(u, cfg.n_layers, "layers") if cfg.scan_layers \
        else [u for _ in range(cfg.n_layers)]
    specs["ln_f"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    return specs


def _layers(cfg: ModelConfig, tree):
    """Per-layer views of `units` (or of a stacked cache)."""
    return unstack(tree, cfg.n_layers) if cfg.scan_layers else list(tree)


def _stack_layers(cfg: ModelConfig, per_layer: list):
    """The per-layer states as the cache layout: stacked [L, ...] or a list."""
    return stack(per_layer) if cfg.scan_layers else per_layer


# ---------------------------------------------------------------------------
# ddlerp projections (full sequence)
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; prev: [B,d] state for t=0 (zeros if None)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def ddlerp_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor, prev=None):
    """-> dict of mixed inputs per channel c: x_c = x + (shift(x)-x)*(mu_c+lora_c).

    The five LoRA down-projections are fused into two matmuls (4x rank-32
    + 1x rank-64)."""
    dt = cfg.compute_dtype
    sx = _shift(x, prev) - x
    xxx = x + sx * p["mu_x"].to(dt)
    low4 = torch.tanh(torch.einsum("btd,dcr->btcr", xxx,
                                   p["lora_kvrg_a"].to(dt)))    # [B,T,4,32]
    low_w = torch.tanh(torch.einsum("btd,dr->btr", xxx, p["lora_w_a"].to(dt)))
    out = {}
    for i, c in enumerate(("k", "v", "r", "g")):
        lora = torch.einsum("btr,rd->btd", low4[:, :, i], p[f"lora_{c}_b"].to(dt))
        out[c] = x + sx * (p[f"mu_{c}"].to(dt) + lora)
    lora_w = torch.einsum("btr,rd->btd", low_w, p["lora_w_b"].to(dt))
    out["w"] = x + sx * (p["mu_w"].to(dt) + lora_w)
    return out


def _heads(x: torch.Tensor, H: int, D: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], H, D)


def group_norm_heads(cfg: ModelConfig, p: dict, o: torch.Tensor) -> torch.Tensor:
    """Per-head LayerNorm (GroupNorm with H groups) on [B,T,H,D]."""
    of = o.float()
    mu = of.mean(dim=-1, keepdim=True)
    var = (of - mu).square().mean(dim=-1, keepdim=True)   # jnp.var, ddof 0
    of = (of - mu) * torch.rsqrt(var + 64e-5)
    flat = of.reshape(*o.shape[:-2], -1)
    return (flat * p["ln_x_scale"].float()
            + p["ln_x_bias"].float()).to(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Chunked WKV
# ---------------------------------------------------------------------------

def wkv_full(cfg: ModelConfig, r, k, v, logw, u, S0=None, *, plain=False):
    """Chunked WKV over the full sequence. r/k/v/logw: [B,T,H,D].  The
    chunk length is min(cfg.rwkv_chunk, T); T must be a multiple of it
    (the reference's reshape fails otherwise; nothing is padded here).
    `plain` runs the plain PyTorch version (`wkv_reference`, which autograd
    differentiates) in place of the kernel wrapper (K4 on the card).
    Returns (o [B,T,H,D] in the compute dtype, S [B,H,D,D] f32)."""
    T = r.shape[1]
    L = min(cfg.rwkv_chunk, T)
    tr = lambda x: x.transpose(1, 2).contiguous()        # [B,H,T,D]
    fn = WK.wkv_reference if plain else WK.wkv
    o, S = fn(tr(r), tr(k), tr(v), tr(logw.float()), u, S0, chunk=L)
    return o.transpose(1, 2).to(cfg.compute_dtype), S


def wkv_step(r1, k1, v1, logw1, u, S):
    """Single decode step. r1/k1/v1/logw1: [B,H,D]; S: [B,H,D,Dv]."""
    rf, kf, vf = r1.float(), k1.float(), v1.float()
    kv = kf[..., None] * vf[:, :, None, :]                 # k (x) v  [B,H,D,Dv]
    o = torch.einsum("bhd,bhdv->bhv", rf, S + u[None, ..., None] * kv)
    S_new = torch.exp(logw1)[..., None] * S + kv
    return o, S_new


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def decay_logw(cfg: ModelConfig, p: dict, xw: torch.Tensor) -> torch.Tensor:
    """ww = w0 + lora_w(x_w); logw = -exp(ww) (clipped for safety)."""
    dt = cfg.compute_dtype
    lora = torch.einsum(
        "btr,rd->btd",
        torch.tanh(torch.einsum("btd,dr->btr", xw, p["lora_w_a"].to(dt))),
        p["lora_w_b"].to(dt)).float()
    ww = p["w0"] + lora
    return -torch.exp(ww.clamp(-20.0, 10.0))


def time_mix_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor, prev=None):
    """The time-mix operands of x [B,T,d]: ddlerp, then the fused r/k/v/g
    projection (one [d,4,d] einsum) and the decay.  Returns r, k, v, logw
    [B,T,H,D] (logw f32) and g [B,T,d]."""
    H, D = n_heads(cfg), cfg.head_dim
    mixed = ddlerp_inputs(cfg, p, x, prev)
    mixed4 = torch.stack([mixed["r"], mixed["k"], mixed["v"], mixed["g"]], 2)
    proj = torch.einsum("btcd,dce->btce", mixed4, p["W_rkvg"].to(cfg.compute_dtype))
    r, k, v = (_heads(proj[:, :, i], H, D) for i in range(3))
    logw = _heads(decay_logw(cfg, p, mixed["w"]), H, D)
    return r, k, v, logw, F.silu(proj[:, :, 3])


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, state=None, *,
             plain=False):
    """x: [B,T,d] -> (out [B,T,d], {"S": S_final, "x_tm": x_last})."""
    prev = None if state is None else state["x_tm"]
    r, k, v, logw, g = time_mix_inputs(cfg, p, x, prev)
    S0 = None if state is None else state["S"]
    o, S = wkv_full(cfg, r, k, v, logw, p["u"], S0, plain=plain)
    o = group_norm_heads(cfg, p, o)
    out = torch.einsum("btd,de->bte", o * g, p["Wo"].to(cfg.compute_dtype))
    return out, {"S": S, "x_tm": x[:, -1]}


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, state=None):
    dt = cfg.compute_dtype
    prev = None if state is None else state["x_cm"]
    sx = _shift(x, prev) - x
    xk = x + sx * p["mu_k"].to(dt)
    xr = x + sx * p["mu_r"].to(dt)
    kk = F.relu(torch.einsum("btd,df->btf", xk, p["Wk"].to(dt))).square()
    vv = torch.einsum("btf,fd->btd", kk, p["Wv"].to(dt))
    rr = torch.sigmoid(torch.einsum("btd,de->bte", xr, p["Wr"].to(dt)))
    return rr * vv, {"x_cm": x[:, -1]}


def run_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, plain=False):
    h, _ = time_mix(cfg, p["tm"], _norm(cfg, p["ln1"], x), plain=plain)
    x = x + h
    h, _ = channel_mix(cfg, p["cm"], _norm(cfg, p["ln2"], x))
    return x + h


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor, *, plain=False):
    x = _norm(cfg, params["ln0"], x)
    layer_fn = _maybe_remat(cfg, lambda lp, x: run_layer(cfg, lp, x, plain))
    for lp in _layers(cfg, params["units"]):
        x = layer_fn(lp, x)
    return _norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: tokens [B,S], labels [B,S] (-1 masked) -> the scalar chunked
    CE loss, through the plain WKV (`plain=True`: the kernel has no
    backward)."""
    x = embed_tokens(cfg, params["emb"], batch["tokens"])
    h = backbone(cfg, params, x, plain=True)
    return chunked_ce_loss(cfg, params, h, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _layer_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, D = n_heads(cfg), cfg.head_dim
    return {"S": torch.zeros((batch, H, D, D), dtype=torch.float32, device=device),
            "x_tm": torch.zeros((batch, cfg.d_model), dtype=cfg.compute_dtype,
                                device=device),
            "x_cm": torch.zeros((batch, cfg.d_model), dtype=cfg.compute_dtype,
                                device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> Any:
    """Zero decode state: per layer {S [B,H,D,D] f32, x_tm, x_cm [B,d]},
    stacked [L, ...] with cfg.scan_layers, else a list.  `seq` is unused:
    the state does not grow with the sequence."""
    del seq
    return _stack_layers(cfg, [_layer_state(cfg, batch, device)
                               for _ in range(cfg.n_layers)])


def layer_decode(cfg: ModelConfig, p: dict, x, st):
    """x: [B,1,d] one token."""
    xin = _norm(cfg, p["ln1"], x)
    r, k, v, logw, g = time_mix_inputs(cfg, p["tm"], xin, st["x_tm"])
    r, k, v, logw = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]
    o, S = wkv_step(r, k, v, logw, p["tm"]["u"], st["S"])
    o = group_norm_heads(cfg, p["tm"], o[:, None, :, :])   # [B,1,H*D]
    x = x + torch.einsum("btd,de->bte", o * g,
                         p["tm"]["Wo"].to(cfg.compute_dtype))
    x_tm = xin[:, -1]
    xin2 = _norm(cfg, p["ln2"], x)
    h, _ = channel_mix(cfg, p["cm"], xin2, state={"x_cm": st["x_cm"]})
    x = x + h
    return x, {"S": S, "x_tm": x_tm, "x_cm": xin2[:, -1]}


def decode_step(cfg: ModelConfig, params: dict, token, cache, pos):
    """token: [B,1] ids -> (logits [B,V] f32, new cache)."""
    del pos   # attention-free: position enters only through state
    x = embed_tokens(cfg, params["emb"], token)
    x = _norm(cfg, params["ln0"], x)
    new_cache = []
    for lp, lc in zip(_layers(cfg, params["units"]), _layers(cfg, cache)):
        x, nc = layer_decode(cfg, lp, x, lc)
        new_cache.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h)[:, 0], _stack_layers(cfg, new_cache)


def prefill(cfg: ModelConfig, params: dict, tokens, *, plain=False):
    """Full-seq forward collecting per-layer final states.
    tokens: [B,S] ids -> (last-position logits [B,V] f32, cache).  `plain`
    runs the plain WKV in place of the kernel wrapper (the dry-run's meta
    tensors, which no kernel takes)."""
    x = embed_tokens(cfg, params["emb"], tokens)
    x = _norm(cfg, params["ln0"], x)
    cache = []
    for lp in _layers(cfg, params["units"]):
        xin = _norm(cfg, lp["ln1"], x)
        h, st_tm = time_mix(cfg, lp["tm"], xin, plain=plain)
        x = x + h
        xin2 = _norm(cfg, lp["ln2"], x)
        h, _ = channel_mix(cfg, lp["cm"], xin2)
        x = x + h
        # copies of the last rows: a view would keep each layer's whole
        # [B, S, d] input alive until the cache is stacked
        cache.append({"S": st_tm["S"], "x_tm": xin[:, -1].clone(),
                      "x_cm": xin2[:, -1].clone()})
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h[:, -1:])[:, 0], _stack_layers(cfg, cache)
