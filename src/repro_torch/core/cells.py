"""Event-based recurrent cells (the paper's model family), in PyTorch.

Counterpart of `repro.core.cells`.  The state is

    a_t = H(v_t),   v_t = F(a_{t-1}, x_t; w) - theta,

with H the Heaviside step (strict v > 0) and pseudo-derivative
H'(v) = gamma * max(0, 1 - |v| / (2*eps)).  ``kind="rnn"`` is the vanilla
map v = x W + a R + b; ``kind="gru"`` the GRU-gated EGRU map.  ``dense=True``
replaces H by tanh (the paper's no-activity-sparsity ablation).

Parameters are plain dicts in the JAX package's structure and layout
(W is [n_in, n], used as ``x @ W``).  Initialisation draws from a
`torch.Generator` (on the CPU, then moved to `device`), so a seed gives the
same weights on every device; it does not reproduce `jax.random` — parity
tests hand both packages the same numpy arrays (`repro_torch.weights`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class EGRUConfig:
    n_hidden: int = 16
    n_in: int = 2
    n_out: int = 2
    kind: str = "gru"              # 'gru' | 'rnn'
    dense: bool = False            # True -> tanh cell (no activity sparsity)
    gamma: float = 1.0             # pseudo-derivative height
    eps: float = 0.3               # pseudo-derivative half-width
    # experiment settings (paper Sec. 6)
    seq_len: int = 17
    batch_size: int = 32
    iterations: int = 1700
    lr: float = 5e-3
    param_dtype: Any = torch.float32

    @property
    def m(self) -> int:
        """Per-unit parameter group size (paper's m = n + n_in + 1 [+1 theta])."""
        return self.n_in + self.n_hidden + 2

    @property
    def n_rec_params(self) -> int:
        """p: number of recurrent parameters."""
        per_gate = self.n_hidden * (self.n_in + self.n_hidden + 1)
        if self.kind == "rnn":
            return per_gate + self.n_hidden                 # + theta
        return 3 * per_gate + self.n_hidden                 # u, r, z gates + theta

    def replace(self, **kw) -> "EGRUConfig":
        return dataclasses.replace(self, **kw)


def pseudo_derivative(v: torch.Tensor, cfg: EGRUConfig) -> torch.Tensor:
    """H'(v) = gamma * max(0, 1 - |v|/(2 eps))   (paper Sec. 4, Fig. 1)."""
    return cfg.gamma * torch.clamp(1.0 - v.abs() / (2.0 * cfg.eps), min=0.0)


def heaviside(v: torch.Tensor) -> torch.Tensor:
    return (v > 0.0).to(v.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _gate_init(gen, n_in, n, dtype):
    s_in = 1.0 / math.sqrt(max(1, n_in))
    s_rec = 1.0 / math.sqrt(max(1, n))
    return {"W": (s_in * _normal(gen, (n_in, n))).to(dtype),
            "R": (s_rec * _normal(gen, (n, n))).to(dtype),
            "b": torch.zeros((n,), dtype=dtype)}


def init_params(cfg: EGRUConfig, gen: torch.Generator, *,
                device: torch.device | str) -> dict:
    """Draws, in order: each gate's W then R (gates u, r, z or v), theta,
    the readout W — all from `gen` on the CPU."""
    n, n_in, dt = cfg.n_hidden, cfg.n_in, cfg.param_dtype
    if cfg.kind == "rnn":
        p = {"v": _gate_init(gen, n_in, n, dt)}
    else:
        p = {g: _gate_init(gen, n_in, n, dt) for g in ("u", "r", "z")}
    # thresholds: positive init so units start moderately sparse
    p["theta"] = (0.1 * _normal(gen, (n,)).abs()).to(dt)
    p["out"] = {"W": (1.0 / math.sqrt(n) * _normal(gen, (n, cfg.n_out))).to(dt),
                "b": torch.zeros((cfg.n_out,), dtype=dt)}
    return tree_map(lambda t: t.to(device), p)


def rec_param_tree(params: dict) -> dict:
    """The recurrent parameters w (everything except the readout)."""
    return {k: v for k, v in params.items() if k != "out"}


def init_state(cfg: EGRUConfig, batch: int, *,
               device: torch.device | str) -> torch.Tensor:
    return torch.zeros((batch, cfg.n_hidden), dtype=torch.float32,
                       device=device)


def slot_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D a and b, as the products ``a[i, k] * b[k, j]`` and
    one sum over k, the innermost axis.

    A slot of the stream fleet (`runtime.fleet`, under `torch.func.vmap`)
    then rounds as the same call alone: the sum over an innermost axis this
    short runs in an order set by its length, on the CPU and on the card,
    whatever the leading axes.  A library product does not: vmapped over
    two slot tensors it becomes a batched product, which ATen on the CPU
    computes with its own loop below 400 multiply-adds a product while the
    unbatched ``mm`` goes to BLAS, and for which cuBLAS picks its kernel by
    the batch count (on the H100 a fleet's products differed from the
    session's own by 1e-7, which adamw's first step spread to 6.7e-6).  The
    products here are the cell's and the readout's: a few hundred to a few
    thousand multiply-adds."""
    return (a[:, None, :] * b.T[None, :, :]).sum(-1)


# ---------------------------------------------------------------------------
# Cell step
# ---------------------------------------------------------------------------

def pre_activation(cfg: EGRUConfig, w: dict, a_prev: torch.Tensor,
                   x_t: torch.Tensor) -> torch.Tensor:
    """v_t = F(a_{t-1}, x_t) - theta.  a_prev: [B,n], x_t: [B,n_in]."""
    if cfg.kind == "rnn":
        g = w["v"]
        f = x_t @ g["W"] + a_prev @ g["R"] + g["b"]
    else:
        u = torch.sigmoid(x_t @ w["u"]["W"] + a_prev @ w["u"]["R"] + w["u"]["b"])
        r = torch.sigmoid(x_t @ w["r"]["W"] + a_prev @ w["r"]["R"] + w["r"]["b"])
        z = torch.tanh(x_t @ w["z"]["W"] + (r * a_prev) @ w["z"]["R"] + w["z"]["b"])
        f = u * z + (1.0 - u) * a_prev
    return f - w["theta"]


def step(cfg: EGRUConfig, w: dict, a_prev: torch.Tensor, x_t: torch.Tensor):
    """One step: -> (a_t, stats). stats: v_t, H'(v_t), alpha, beta."""
    v = pre_activation(cfg, w, a_prev, x_t)
    if cfg.dense:
        a = torch.tanh(v)
        hp = 1.0 - a.square()               # dense 'pseudo'-derivative
    else:
        a = heaviside(v)
        hp = pseudo_derivative(v, cfg)
    stats = {"v": v, "hp": hp,
             "alpha": (a == 0.0).float().mean(),
             "beta": (hp == 0.0).float().mean()}
    return a, stats


class _HeavisideST(torch.autograd.Function):
    """Heaviside forward, pseudo-derivative H'(v) in the backward pass.

    In the `setup_context` form with a generated vmap rule, so that
    `torch.func` transforms (`jacrev`, `vmap`; the jacrev RTRL oracle of
    `core.rtrl`) go through it as autograd does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v, gamma, eps):
        return heaviside(v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, gamma, eps = inputs
        ctx.save_for_backward(v)
        ctx.gamma, ctx.eps = gamma, eps

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        hp = ctx.gamma * torch.clamp(1.0 - v.abs() / (2.0 * ctx.eps), min=0.0)
        return hp * grad, None, None


def step_straight_through(cfg: EGRUConfig, w: dict, a_prev: torch.Tensor,
                          x_t: torch.Tensor) -> torch.Tensor:
    """Autograd-compatible step: Heaviside forward, pseudo-derivative in the
    backward pass (tanh when `cfg.dense`).  This is what BPTT differentiates,
    so every training algorithm shares one surrogate gradient."""
    v = pre_activation(cfg, w, a_prev, x_t)
    return torch.tanh(v) if cfg.dense else _HeavisideST.apply(v, cfg.gamma,
                                                              cfg.eps)


def readout(params: dict, a: torch.Tensor) -> torch.Tensor:
    return a @ params["out"]["W"] + params["out"]["b"]


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy, mean over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def sequence_logits(cfg: EGRUConfig, params: dict, xs: torch.Tensor):
    """xs: [T, B, n_in] -> (per-step logits [T, B, n_out], stats)."""
    w = rec_param_tree(params)
    a = init_state(cfg, xs.shape[1], device=xs.device)
    logits, alpha = [], []
    for x_t in xs:
        a = step_straight_through(cfg, w, a, x_t)
        logits.append(readout(params, a))
        alpha.append((a == 0.0).float().mean())
    return torch.stack(logits), {"alpha": torch.stack(alpha).mean()}


def sequence_loss(cfg: EGRUConfig, params: dict, xs: torch.Tensor,
                  labels: torch.Tensor):
    """Online-decomposable loss L = (1/T) sum_t CE(logits_t, y)."""
    logits_t, stats = sequence_logits(cfg, params, xs)
    losses = torch.stack([xent(lg, labels) for lg in logits_t])
    stats["logits_mean"] = logits_t.mean(dim=0)
    return losses.mean(), stats


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


# ---------------------------------------------------------------------------
# Stacked networks: L event-based layers, layer l driven by a^{l-1}_t
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackedEGRUConfig:
    """A stack of EGRU/ERNN layers with a shared readout from the top layer.

    Layer 0 sees the input x_t; layer l >= 1 sees the current-step activity
    a^{l-1}_t of the layer below.  The stacked state Jacobian is block
    lower-triangular, so exact RTRL factors into (l, j) influence blocks
    (`core.stacked_rtrl`)."""
    layer_sizes: tuple = (16, 16)
    n_in: int = 2
    n_out: int = 2
    kind: str = "gru"              # 'gru' | 'rnn'  (homogeneous stack)
    dense: bool = False
    gamma: float = 1.0
    eps: float = 0.3
    seq_len: int = 17
    batch_size: int = 32
    iterations: int = 1700
    lr: float = 5e-3
    param_dtype: Any = torch.float32

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes)

    def layer_in(self, l: int) -> int:
        """Input width of layer l (x for l=0, the layer below otherwise)."""
        return self.n_in if l == 0 else self.layer_sizes[l - 1]

    def layer_cfg(self, l: int) -> EGRUConfig:
        """The single-layer view of layer l (its cell math is unchanged)."""
        return EGRUConfig(
            n_hidden=self.layer_sizes[l], n_in=self.layer_in(l),
            n_out=self.n_out, kind=self.kind, dense=self.dense,
            gamma=self.gamma, eps=self.eps, seq_len=self.seq_len,
            batch_size=self.batch_size, iterations=self.iterations,
            lr=self.lr, param_dtype=self.param_dtype)

    @property
    def n_rec_params(self) -> int:
        return sum(self.layer_cfg(l).n_rec_params
                   for l in range(self.n_layers))

    def replace(self, **kw) -> "StackedEGRUConfig":
        return dataclasses.replace(self, **kw)


def stacked_config(cfg: EGRUConfig, n_layers: int,
                   layer_sizes: tuple | None = None) -> StackedEGRUConfig:
    """Lift a single-layer config to an L-layer stack (same width per layer
    unless explicit `layer_sizes` are given)."""
    sizes = tuple(layer_sizes) if layer_sizes is not None \
        else (cfg.n_hidden,) * n_layers
    if len(sizes) != n_layers:
        raise ValueError(f"layer_sizes {sizes} do not give {n_layers} layers")
    return StackedEGRUConfig(
        layer_sizes=sizes, n_in=cfg.n_in, n_out=cfg.n_out, kind=cfg.kind,
        dense=cfg.dense, gamma=cfg.gamma, eps=cfg.eps, seq_len=cfg.seq_len,
        batch_size=cfg.batch_size, iterations=cfg.iterations, lr=cfg.lr,
        param_dtype=cfg.param_dtype)


def init_stacked_params(cfg: StackedEGRUConfig, gen: torch.Generator, *,
                        device: torch.device | str) -> dict:
    """{"layers": [w^0, ..., w^{L-1}], "out": readout from the top layer};
    layers drawn bottom-up from `gen`, then the readout W."""
    layers = []
    for l in range(cfg.n_layers):
        p = init_params(cfg.layer_cfg(l), gen, device=device)
        p.pop("out")
        layers.append(p)
    n_top = cfg.layer_sizes[-1]
    out = {"W": (1.0 / math.sqrt(n_top)
                 * _normal(gen, (n_top, cfg.n_out))).to(cfg.param_dtype),
           "b": torch.zeros((cfg.n_out,), dtype=cfg.param_dtype)}
    return {"layers": layers, "out": tree_map(lambda t: t.to(device), out)}


def init_stacked_state(cfg: StackedEGRUConfig, batch: int, *,
                       device: torch.device | str) -> tuple:
    return tuple(torch.zeros((batch, n), dtype=torch.float32, device=device)
                 for n in cfg.layer_sizes)


def stacked_step_straight_through(cfg: StackedEGRUConfig, ws, a_prevs: tuple,
                                  x_t: torch.Tensor) -> tuple:
    """One stacked step with the shared surrogate gradient; layer l's input
    is the freshly computed a^{l-1}_t (bottom-up within the step)."""
    inp = x_t
    outs = []
    for l in range(cfg.n_layers):
        inp = step_straight_through(cfg.layer_cfg(l), ws[l], a_prevs[l], inp)
        outs.append(inp)
    return tuple(outs)


def stacked_sequence_loss(cfg: StackedEGRUConfig, params: dict,
                          xs: torch.Tensor, labels: torch.Tensor):
    """Online-decomposable stacked loss L = (1/T) sum_t CE(logits_t, y);
    logits read from the top layer only (shared readout)."""
    ws = params["layers"]
    a = init_stacked_state(cfg, xs.shape[1], device=xs.device)
    losses, alpha = [], []
    for x_t in xs:
        a = stacked_step_straight_through(cfg, ws, a, x_t)
        losses.append(xent(readout(params, a[-1]), labels))
        alpha.append(torch.stack([(al == 0.0).float().mean() for al in a]))
    alpha_t = torch.stack(alpha)
    stats = {"alpha": alpha_t.mean(), "alpha_layers": alpha_t.mean(dim=0)}
    return torch.stack(losses).mean(), stats
