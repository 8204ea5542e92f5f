"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention, in PyTorch.

Counterpart of `repro.models.rglru`.  The layer pattern is 1 attention :
2 recurrent, a repeating unit (rec, rec2, attn), with the remainder layers
appended as recurrent layers (38 = 12 * 3 + 2).  With ``cfg.scan_layers``
the units' parameters and decode state are stacked ``[U, ...]`` tensors,
else a list; the remainder layers (``rem``) are always a list, as in the
reference.

The RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
is diagonal.  Training and prefill run it as a log-depth scan in torch ops
(`rglru_scan`, Hillis-Steele: ceil(log2 T) elementwise steps over the
whole sequence, where the reference uses `lax.associative_scan`); decode
runs one step.  The cell-level RG-LRU with exact diagonal RTRL is
`repro_torch.cells.rglru`.

`prefill(..., max_seq=N)` leaves room to decode, as the decoder's does:
the local attention layers get a ring of min(N, window) slots holding
position p at slot p % smax, the slot that `decode_step` reads it from,
so a prefill of S tokens followed by n decode steps equals the full
forward over S + n.  The reference sizes the ring to the prompt and
stores its last keys at slots 0..smax-1 (ROADMAP Queue 3, fault 9).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_tokens, embedding_specs, lm_logits,
                                       mlp, mlp_specs, rmsnorm_spec)
from repro_torch.models.module import (ParamSpec, constant_init, fan_in_normal,
                                       stack_specs, uniform_init)
from repro_torch.models.transformer import (_fill, _maybe_remat, _norm,
                                            chunked_ce_loss)
from repro_torch.tree import stack, unstack

C_RGLRU = 8.0   # recurrence-gate exponent constant (Griffin)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def rglru_specs(cfg: ModelConfig) -> dict:
    d, w, pd = cfg.d_model, cfg.lru_width, cfg.param_dtype
    return {
        "wx": ParamSpec((d, w), pd, fan_in_normal(), ("embed_tp", "lru")),
        "wy": ParamSpec((d, w), pd, fan_in_normal(), ("embed_tp", "lru")),
        "conv_w": ParamSpec((cfg.conv_width, w), pd, fan_in_normal(0),
                            (None, "lru")),
        "conv_b": ParamSpec((w,), pd, constant_init(0.0), ("lru",)),
        # input and recurrence gates: dense [w, w], as in the reference
        "w_in_gate": ParamSpec((w, w), pd, fan_in_normal(), ("lru", "lru_tp")),
        "w_a_gate": ParamSpec((w, w), pd, fan_in_normal(), ("lru", "lru_tp")),
        "lambda": ParamSpec((w,), torch.float32, uniform_init(2.2, 5.5), ("lru",)),
        "wo": ParamSpec((w, d), pd, fan_in_normal(), ("lru", "embed_tp")),
    }


def rec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln_mix": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "lru": rglru_specs(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": mlp_specs(cfg),
    }


def attn_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln_attn": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": attn.attn_specs(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": mlp_specs(cfg),
    }


UNIT_LAYOUT = ("rec", "rec2", "attn")


def n_units(cfg: ModelConfig) -> tuple[int, int]:
    """(full units, remainder rec layers)."""
    return cfg.n_layers // 3, cfg.n_layers % 3


def unit_specs(cfg: ModelConfig) -> dict:
    return {"rec": rec_layer_specs(cfg), "rec2": rec_layer_specs(cfg),
            "attn": attn_layer_specs(cfg)}


def rglru_model_specs(cfg: ModelConfig) -> dict:
    U, rem = n_units(cfg)
    specs: dict[str, Any] = {"emb": embedding_specs(cfg)}
    u = unit_specs(cfg)
    specs["units"] = stack_specs(u, U, "layers") if cfg.scan_layers \
        else [u for _ in range(U)]
    specs["rem"] = [rec_layer_specs(cfg) for _ in range(rem)]
    specs["ln_f"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    return specs


def _units(cfg: ModelConfig, tree) -> list:
    """Per-unit views of `units` (parameters or decode state)."""
    return unstack(tree, n_units(cfg)[0]) if cfg.scan_layers else list(tree)


def _restack(cfg: ModelConfig, per_unit: list):
    return stack(per_unit) if cfg.scan_layers else per_unit


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) in the reference's form (`jax.nn.softplus`:
    max(x, 0) + log1p(exp(-|x|))), with no threshold."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _gates(cfg: ModelConfig, p: dict, u: torch.Tensor):
    """u: [..., w] conv output -> (log_a [..., w] f32, gated input [..., w] f32)."""
    dt = cfg.compute_dtype
    r = torch.sigmoid((u @ p["w_a_gate"].to(dt)).float())
    i = torch.sigmoid(u @ p["w_in_gate"].to(dt))
    log_a = -C_RGLRU * r * _softplus(p["lambda"])               # < 0
    a2 = torch.exp(2.0 * log_a)
    x_in = (i * u).float() * torch.sqrt((1.0 - a2).clamp(min=1e-9))
    return log_a, x_in


def rglru_scan(log_a: torch.Tensor, x_in: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t along axis 1 (time), from h0 (default 0).

    log_a, x_in: [B, T, w] (f32); h0: [B, w].  Returns h: [B, T, w].  A
    Hillis-Steele scan of the pairs (a, b) under (a1, b1) o (a2, b2) =
    (a1 a2, a2 b1 + b2): after the step at offset o, position t holds the
    composition of the 2o steps ending at t; ceil(log2 T) steps in all."""
    a = torch.exp(log_a)
    b = x_in
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    T, off = b.shape[1], 1
    while off < T:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        if off * 2 < T:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def conv1d_causal(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv, width K. x: [B,T,w]. state: [B,K-1,w] history.
    Returns (out [B,T,w], the new history [B,K-1,w])."""
    K, T = cfg.conv_width, x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = p["conv_w"].to(x.dtype)
    out = xp[:, :T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + p["conv_b"].to(x.dtype), xp[:, -(K - 1):]


def _rec_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor, conv_state=None):
    """The block's branches: (log_a, x_in, the gelu branch uy, conv history)."""
    dt = cfg.compute_dtype
    ux = x @ p["wx"].to(dt)
    uy = F.gelu(x @ p["wy"].to(dt), approximate="tanh")
    ux, conv = conv1d_causal(cfg, p, ux, conv_state)
    log_a, x_in = _gates(cfg, p, ux)
    return log_a, x_in, uy, conv


def rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Griffin recurrent temporal-mixing block (training/prefill, full seq)."""
    dt = cfg.compute_dtype
    log_a, x_in, uy, _ = _rec_inputs(cfg, p, x)
    h = rglru_scan(log_a, x_in).to(dt)
    return (h * uy) @ p["wo"].to(dt)


def rglru_block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict):
    """x: [B,1,d]; state: {'h': [B,w] f32, 'conv': [B,K-1,w]}."""
    dt = cfg.compute_dtype
    log_a, x_in, uy, conv = _rec_inputs(cfg, p, x, state["conv"])
    h = torch.exp(log_a[:, 0]) * state["h"] + x_in[:, 0]          # [B,w]
    out = (h.to(dt) * uy[:, 0]) @ p["wo"].to(dt)
    return out[:, None], {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# Layers / model
# ---------------------------------------------------------------------------

def _mlp_residual(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x))


def run_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, kind: str):
    if kind == "attn":
        h = attn.self_attention(cfg, p["attn"], _norm(cfg, p["ln_attn"], x),
                                positions, causal=True,
                                window=cfg.local_window)
    else:
        h = rglru_block(cfg, p["lru"], _norm(cfg, p["ln_mix"], x))
    return _mlp_residual(cfg, p, x + h)


def _kind(name: str) -> str:
    return "attn" if name == "attn" else "rec"


def run_unit(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    for name in UNIT_LAYOUT:
        x = run_layer(cfg, p[name], x, positions, _kind(name))
    return x


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor, positions):
    """Embedded input -> final-norm hidden states.  The remat policy wraps
    each unit; the remainder layers run bare, as in the reference."""
    unit_fn = _maybe_remat(cfg, functools.partial(run_unit, cfg))
    for up in _units(cfg, params["units"]):
        x = unit_fn(up, x, positions)
    for lp in params["rem"]:
        x = run_layer(cfg, lp, x, positions, "rec")
    return _norm(cfg, params["ln_f"], x)


def forward_logits(cfg: ModelConfig, params: dict, tokens,
                   start: int = 0) -> torch.Tensor:
    """The full forward's f32 logits at positions start..S-1 [B, S-start, V]
    (the yardstick of prefill and decode)."""
    x = embed_tokens(cfg, params["emb"], tokens)
    h = backbone(cfg, params, x, torch.arange(tokens.shape[1],
                                              device=tokens.device))
    return lm_logits(cfg, params["emb"], h[:, start:])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_tokens(cfg, params["emb"], tokens)
    h = backbone(cfg, params, x, torch.arange(tokens.shape[1],
                                              device=tokens.device))
    return chunked_ce_loss(cfg, params, h, labels)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _rec_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                                dtype=cfg.compute_dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """Zero decode state: per unit {'rec', 'rec2': {'h' [B,w] f32, 'conv'
    [B,K-1,w]}, 'attn': a ring of min(seq, window) KV slots}, stacked
    [U, ...] with cfg.scan_layers, else a list; 'rem' a list of rec states."""
    U, rem = n_units(cfg)

    def unit():
        return {"rec": _rec_state(cfg, batch, device),
                "rec2": _rec_state(cfg, batch, device),
                "attn": attn.init_kv_cache(cfg, batch, seq, cfg.local_window,
                                           device)}
    return {"units": _restack(cfg, [unit() for _ in range(U)]),
            "rem": [_rec_state(cfg, batch, device) for _ in range(rem)]}


def layer_decode(cfg: ModelConfig, p: dict, x, lc, pos, kind: str):
    if kind == "attn":
        h, nc = attn.self_attention_decode(
            cfg, p["attn"], _norm(cfg, p["ln_attn"], x), lc, pos,
            window=cfg.local_window)
    else:
        h, nc = rglru_block_decode(cfg, p["lru"], _norm(cfg, p["ln_mix"], x), lc)
    return _mlp_residual(cfg, p, x + h), nc


def unit_decode(cfg: ModelConfig, p: dict, x, uc, pos):
    new = {}
    for name in UNIT_LAYOUT:
        x, new[name] = layer_decode(cfg, p[name], x, uc[name], pos, _kind(name))
    return x, new


def decode_step(cfg: ModelConfig, params: dict, token, cache, pos):
    """token: [B,1] int; pos: [B] int -> (logits [B,V] f32, new_cache)."""
    x = embed_tokens(cfg, params["emb"], token)
    new_units = []
    for up, uc in zip(_units(cfg, params["units"]), _units(cfg, cache["units"])):
        x, nc = unit_decode(cfg, up, x, uc, pos)
        new_units.append(nc)
    new_rem = []
    for lp, lc in zip(params["rem"], cache["rem"]):
        x, nc = layer_decode(cfg, lp, x, lc, pos, "rec")
        new_rem.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return (lm_logits(cfg, params["emb"], h)[:, 0],
            {"units": _restack(cfg, new_units), "rem": new_rem})


def _rec_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, st: dict):
    """A recurrent layer over the prompt; its state is the scan's last h
    and the conv's last K-1 inputs."""
    dt = cfg.compute_dtype
    log_a, x_in, uy, conv = _rec_inputs(cfg, p["lru"], _norm(cfg, p["ln_mix"], x))
    h = rglru_scan(log_a, x_in)
    o = (h.to(dt) * uy) @ p["lru"]["wo"].to(dt)
    # copies: views would keep the layer's whole [B, S, w] scan and conv
    # input alive for as long as the state
    new = {"h": h[:, -1].clone(), "conv": conv.to(st["conv"].dtype, copy=True)}
    return _mlp_residual(cfg, p, x + o), new


def _attn_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, st):
    hin = _norm(cfg, p["ln_attn"], x)
    q = attn.project_q(cfg, p["attn"], hin, positions)
    k, v = attn.project_kv(cfg, p["attn"], hin, positions)
    new = {"k": _fill(st["k"], k), "v": _fill(st["v"], v)}
    o = attn.flash_attention(cfg, q, k, v, causal=True, window=cfg.local_window)
    return _mlp_residual(cfg, p, x + attn.out_proj(cfg, p["attn"], o)), new


def prefill(cfg: ModelConfig, params: dict, tokens, *,
            max_seq: int | None = None):
    """tokens: [B,S] -> (next-token logits [B,V] f32, decode state with room
    for max_seq positions (default S); see the module docstring)."""
    B, S = tokens.shape
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} < the prompt's {S}")
    x = embed_tokens(cfg, params["emb"], tokens)
    positions = torch.arange(S, device=tokens.device)
    cache = init_cache(cfg, B, max_seq, tokens.device)
    new_units = []
    for up, uc in zip(_units(cfg, params["units"]), _units(cfg, cache["units"])):
        nc = {}
        x, nc["rec"] = _rec_prefill(cfg, up["rec"], x, uc["rec"])
        x, nc["rec2"] = _rec_prefill(cfg, up["rec2"], x, uc["rec2"])
        x, nc["attn"] = _attn_prefill(cfg, up["attn"], x, positions, uc["attn"])
        new_units.append(nc)
    new_rem = []
    for lp, lc in zip(params["rem"], cache["rem"]):
        x, nc = _rec_prefill(cfg, lp, x, lc)
        new_rem.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return (lm_logits(cfg, params["emb"], h[:, -1:])[:, 0],
            {"units": _restack(cfg, new_units), "rem": new_rem})
