"""Roofline costing of the port's steps (counterpart of
`repro.launch.costing`).

Two halves:

* The analytic half, value for value the reference's: `model_param_counts`,
  `attention_model_flops` and `model_flops` (6ND for training, 2ND for
  prefill and decode, with the MoE's active experts, plus the attention
  products the algorithm needs).
* The counter, `count_step(fn, *args)`: it runs a step (on the `meta`
  device for the dry-run, where only shapes exist) under
  `torch.utils.flop_counter.FlopCounterMode` and under `_OpCounter`, a
  `TorchDispatchMode` of this module, and `MemTracker` where asked.
  `FlopCounterMode` counts the matmul-class ops (mm, bmm, addmm, baddbmm,
  convolutions, attention): 2 FLOPs a multiply-add, nothing for
  elementwise ops.  `_OpCounter` sums each aten op's input and output
  bytes (the distinct elements a strided operand addresses; views move
  nothing): an unfused upper bound, as XLA's "bytes accessed" is.  It
  also splits the FLOPs and bytes by top-level part (embedding, each
  layer or unit, LM head): an op belongs to the part whose parameter it
  or an op before it last read.

Not ported: the reference's XLA half (`cost_analysis_dict`,
`parse_collective_bytes`, `Part`, `PartBuilder`, `family_children`).  XLA's
cost analysis counts a loop body once, and the reference corrects that by
lowering each loop body alone and composing the counts; it reads the
collectives' bytes from HLO text.  The dispatch mode sees every op that
runs, each trip of every loop included, so no correction is needed; on a
mesh the port's SPMD code issues every collective itself, and
`collectives.counts_bytes` keeps their result bytes by kind.

The card: one H100 SXM's published peaks (NVIDIA's data sheet), at its
700 W maximum power limit; a card set lower runs slower under load.  A
mesh's collectives are reckoned against its NVLink 4: 450 GB/s a
direction (900 GB/s both ways) between the 8 cards of one HGX H100 node.
A 16-wide mesh axis spans two such nodes, whose link is the nodes'
network, slower than NVLink: the collective time is a lower bound.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import get_model
from repro_torch.models.module import count_params
from repro_torch.tree import tree_flatten_with_path, tree_leaves

# --- one H100 SXM (per card; NVIDIA data sheet, 700 W) ---------------------
BF16_FLOP_S = 989e12      # dense bf16 on the tensor cores
F32_FLOP_S = 67e12        # f32 on the CUDA cores
HBM_BYTES_S = 3.35e12     # HBM3 bytes/s
CARD_BYTES = 80e9         # device memory, the "80 GB" of the card's name
POWER_LIMIT_W = 700.0     # the limit these peaks are published at
NVLINK_BYTES_S = 450e9    # NVLink 4, one direction (900 GB/s both ways)
NVLINK_CARDS = 8          # cards an NVLink switch joins in one HGX H100 node


# ---------------------------------------------------------------------------
# MODEL_FLOPS (analytic 6ND / 2ND with MoE activation)
# ---------------------------------------------------------------------------

def model_param_counts(cfg: ModelConfig) -> dict:
    api = get_model(cfg)
    specs = api.specs(cfg)
    total = count_params(specs)
    embed = cfg.vocab_size * cfg.d_model
    expert = 0
    if cfg.moe:
        from repro_torch.models.moe import moe_specs
        expert = count_params(moe_specs(cfg)) * cfg.n_layers
        router = cfg.d_model * cfg.n_experts * cfg.n_layers
        expert -= router
    active = total - embed - expert * (1.0 - cfg.top_k / max(1, cfg.n_experts))
    return {"total": total, "active": active, "embed_table": embed}


def attention_model_flops(cfg: ModelConfig, shape: ShapeSuite) -> float:
    """Score+PV matmul FLOPs the *algorithm* requires (fwd, global).

    4*B*Sq*Skv_eff*H*Dh per layer; causal halves, local windows cap Skv."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "rwkv6":
        # chunked WKV: intra ~ 2*T*L*D + state 2*D^2 per chunk, per head
        L = cfg.rwkv_chunk
        H, D = cfg.d_model // cfg.head_dim, cfg.head_dim
        if shape.kind == "decode":
            return 4.0 * B * H * D * D * cfg.n_layers
        per_tok = 2 * L * D + 4 * D * D / L
        return 2.0 * B * S * H * per_tok * cfg.n_layers
    hd = cfg.n_heads * cfg.head_dim

    def layer_attn(sq, skv, window):
        skv_eff = min(skv, window) if window else skv
        causal = 0.5 if (window == 0 and sq == skv) else 1.0
        return 4.0 * B * sq * skv_eff * hd * causal

    n_local = n_global = 0
    if cfg.family == "decoder":
        if cfg.layer_pattern == "local_global":
            n_local = n_global = cfg.n_layers // 2
        else:
            n_global = cfg.n_layers
    elif cfg.family == "rglru":
        n_local = cfg.n_layers // 3
    elif cfg.family == "encdec":
        n_global = cfg.n_layers          # decoder self-attn

    if shape.kind == "decode":
        total = (n_global * layer_attn(1, S, 0)
                 + n_local * layer_attn(1, S, cfg.local_window))
        if cfg.family == "encdec":
            total += cfg.n_layers * layer_attn(1, cfg.enc_seq, 0)
        if cfg.family == "rglru":
            total += 2 * (cfg.n_layers // 3 + cfg.n_layers % 3) \
                * 2.0 * B * cfg.lru_width * 8   # lru update, tiny
        return total
    total = (n_global * layer_attn(S, S, 0)
             + n_local * layer_attn(S, S, cfg.local_window))
    if cfg.family == "encdec":
        total += cfg.enc_layers * 4.0 * B * cfg.enc_seq ** 2 * hd \
            + cfg.n_layers * 4.0 * B * S * cfg.enc_seq * hd
    if shape.kind == "train":
        total *= 3.0                     # bwd ~ 2x fwd
    return total


def model_flops(cfg: ModelConfig, shape: ShapeSuite) -> float:
    """6ND / 2ND (MoE-active) + algorithmic attention FLOPs.

    For enc-dec, encoder params see B*enc_seq tokens, not B*seq_len."""
    counts = model_param_counts(cfg)
    n = counts["active"]
    attn = attention_model_flops(cfg, shape)
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        from repro_torch.models.encdec import enc_layer_specs
        n_enc = count_params(enc_layer_specs(cfg)) * cfg.enc_layers
        n_dec = n - n_enc
        if shape.kind == "decode":
            # encoder runs once at prefill; decode touches decoder params only
            return mult * n_dec * B + attn
        return mult * (n_dec * B * S + n_enc * B * cfg.enc_seq) + attn
    if shape.kind == "decode":
        return mult * n * B + attn
    return mult * n * B * S + attn


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a strided tensor addresses (a
    broadcast dimension, stride 0, reads one element)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a tree (each tensor counted once)."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _top_part(path: tuple) -> str:
    """A parameter's (or a parameter-shaped leaf's) top-level part from its
    tree path: `emb` (the embedding, or the head once a layer has run),
    `unit i` / `layer i` of a listed stack, `units` for a stacked one
    (its `unbind` names the slices), `head` for the final norm."""
    key = path[0]
    if key == "emb":
        return "head" if path[1:2] == ("head",) else "emb"
    if key in ("ln0", "vproj"):
        return "embedding"
    if key in ("ln_f", "ln_enc_f"):
        return {"ln_f": "head", "ln_enc_f": "encoder norm"}[key]
    names = {"units": "unit", "rem": "rem", "enc": "enc layer",
             "dec": "dec layer"}
    if key in names:
        if len(path) > 1 and isinstance(path[1], int):
            return f"{names[key]} {path[1]}"
        return f"stacked:{names[key]}"
    return str(key)


class _PartMap:
    """tensor -> part, keyed by identity (a tensor's `==` is elementwise,
    so a WeakKeyDictionary cannot key on it); an entry leaves with its
    tensor."""

    def __init__(self):
        self._d: dict = {}

    def __setitem__(self, t, part):
        key = id(t)
        self._d[key] = (weakref.ref(t, lambda _, k=key: self._d.pop(k, None)),
                        part)

    def get(self, t):
        hit = self._d.get(id(t))
        return hit[1] if hit is not None and hit[0]() is t else None


class _OpCounter(TorchDispatchMode):
    """Sums every aten op's FLOPs (`flop_registry`, FlopCounterMode's own
    formulas) and bytes (inputs and outputs, `tensor_bytes`; views move
    nothing), in total and by the part of the parameter the op, or the
    last op before it that read one, read."""

    def __init__(self, tagged: list):
        super().__init__()
        self.part_of = _PartMap()
        for t, part in tagged:
            self.part_of[t] = part
        self.parts: dict = {}
        self.current = "other"
        self.ran_layer = False
        self.ops = 0

    def _resolve(self, part: str) -> str:
        if part == "emb":          # a tied table: the embedding, then the head
            return "head" if self.ran_layer else "embedding"
        if part not in ("embedding", "head", "encoder norm", "other"):
            self.ran_layer = True
        return part

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = _FUNC_INFO.get(func)
        if info is None:
            info = _FUNC_INFO[func] = (
                _is_view(func), func.overloadpacket,
                flop_registry.get(func.overloadpacket),
                func in _NO_TRAFFIC)
        view, packet, flop_fn, no_traffic = info
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        outs = _tensors((out,))
        tags = [self.part_of.get(t) for t in ins]
        tag = next((p for p in tags if p is not None), None)
        if tag is not None:
            if tag.startswith("stacked:"):
                if view:       # slices of a stacked leaf: unbind names each
                    kind = tag.split(":", 1)[1]
                    if packet is torch.ops.aten.unbind:
                        for i, o in enumerate(outs):
                            self.part_of[o] = f"{kind} {i}"
                    elif packet is torch.ops.aten.select and args[1] == 0:
                        self.part_of[outs[0]] = f"{kind} {int(args[2])}"
            else:
                if all(p == tag for p in tags) and (
                        view or packet in (torch.ops.aten._to_copy,
                                           torch.ops.aten.clone)):
                    for o in outs:     # a view or a cast of a parameter
                        self.part_of[o] = tag
                self.current = self._resolve(tag)
        flops = int(flop_fn(*args, **kwargs, out_val=out)) if flop_fn else 0
        nbytes = 0
        if not view and not no_traffic:
            nbytes = (sum(tensor_bytes(t) for t in ins)
                      + sum(tensor_bytes(t) for t in outs))
        acc = self.parts.get(self.current)
        if acc is None:
            acc = self.parts[self.current] = [0, 0, 0]
        acc[0] += flops
        acc[1] += nbytes
        acc[2] += 1
        self.ops += 1
        return out


_FUNC_INFO: dict = {}


def _tensors(xs) -> list:
    """The tensors among xs, one level of lists and tuples opened (the
    aten schemas' `Tensor[]` arguments and tuple returns)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def part_tags(tree) -> list:
    """[(leaf, part)] of a parameter tree (or one of its shape: an
    optimizer state leaf keeps its parameter's part)."""
    return [(t, _top_part(path)) for path, t in tree_flatten_with_path(tree)
            if isinstance(t, torch.Tensor)]


def count_step(fn: Callable, *args, tagged: list = (), peak: bool = False,
               track: Any = None) -> dict:
    """Run fn(*args) once under FlopCounterMode and `_OpCounter` (and,
    with `peak`, torch's MemTracker, which follows every tensor's storage
    from allocation to free, `track`'s tensors counted as live from the
    start).  `tagged` is [(tensor, part)] (`part_tags`).  Returns
    {"flops", "bytes", "ops", "parts": [{"name", "flops", "bytes",
    "ops"}], "peak_bytes" (with `peak`), "out": fn's result}."""
    counter = _OpCounter(list(tagged))
    flop_mode = FlopCounterMode(display=False)
    with contextlib.ExitStack() as stack:
        mem = None
        if peak:
            from torch.distributed._tools.mem_tracker import MemTracker
            mem = MemTracker()
            mem.track_external(*[t for t in tree_leaves(track)
                                 if isinstance(t, torch.Tensor)])
            stack.enter_context(mem)
        stack.enter_context(flop_mode)
        stack.enter_context(counter)
        out = fn(*args)
    parts = [{"name": k, "flops": v[0], "bytes": v[1], "ops": v[2]}
             for k, v in counter.parts.items()]
    res = {"flops": int(flop_mode.get_total_flops()),
           "bytes": sum(p["bytes"] for p in parts), "ops": counter.ops,
           "parts": parts, "out": out}
    if mem is not None:
        snap = mem.get_tracker_snapshot("peak")
        res["peak_bytes"] = int(max(v["Total"] for v in snap.values()))
    return res


def roofline(flops: float, nbytes: float, model_flops_global: float,
             params: dict, n_chips: int = 1,
             collective_bytes: float = 0.0) -> dict:
    """The step's least times on one card, reckoned against the published
    peaks (not measured): the counted FLOPs over the bf16 tensor-core
    peak, the counted bytes over HBM bandwidth.  On a mesh of `n_chips`
    the counts are one rank's, and its collectives' result bytes over
    NVLink's one-direction rate give `collective_s` (a lower bound where
    a mesh axis is wider than one node's 8 cards)."""
    compute_s = flops / BF16_FLOP_S
    memory_s = nbytes / HBM_BYTES_S
    out = {"n_chips": n_chips, "compute_s": compute_s, "memory_s": memory_s}
    basis = ("reckoned against one H100 SXM's published peaks "
             f"({BF16_FLOP_S:.3g} bf16 FLOP/s, {HBM_BYTES_S:.3g} HBM "
             f"bytes/s, at {POWER_LIMIT_W:.0f} W)")
    if n_chips > 1:
        out["collective_s"] = collective_bytes / NVLINK_BYTES_S
        basis += (f" and NVLink 4's {NVLINK_BYTES_S:.3g} bytes/s a "
                  f"direction; a 16-wide mesh axis spans two {NVLINK_CARDS}"
                  "-card nodes, so collective_s is a lower bound")
    terms = [k for k in ("compute_s", "memory_s", "collective_s") if k in out]
    out.update(
        dominant=max(terms, key=lambda k: out[k]),
        model_flops_global=model_flops_global, params=params,
        useful_flops_ratio=(model_flops_global / (flops * n_chips)
                            if flops else 0.0),
        basis=basis + "; not measured")
    return out
