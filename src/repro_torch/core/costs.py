"""Table-1 cost model + the paper's compute-adjusted iteration measure.

Formulas (paper Table 1; n hidden units, p recurrent params, T seq length,
alpha/beta/omega sparsities with tilde = 1 - sparsity = density):

  method                        memory              time per step
  BPTT (dense)                  T n + p             n^2 + p
  RTRL (dense)                  n + n p             n^2 + n^2 p
  RTRL + param sparsity         n + w~ n p          w~ n^2 + w~^2 n^2 p
  RTRL + activity sparsity      a~ n + b~ n p       a~ n^2 + b~^2 n^2 p
  RTRL + both                   a~ n + w~ b~ n p    w~ a~ n^2 + w~^2 b~^2 n^2 p
  SnAp-1                        n + w~ n p/n ...    w~ n^2 + w~ p
  SnAp-2                        n + w~^2 n p        w~ n^2 + w~^3 n^2 p

The *compute-adjusted iteration* (paper Sec. 6) integrates the savings factor
w~^2 b~(t) b~(t-1)  per step — "an analytical measure for the total compute
used in an optimal case where the underlying hardware is optimised for the
algorithm".  `tpu_block_factor` reports the block-granular fraction a
block-skipping kernel realises.

Counterpart of `repro.core.costs`, numpy only: every function gives the
JAX package's numbers bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cells import EGRUConfig


@dataclasses.dataclass(frozen=True)
class CostInputs:
    n: int
    p: int
    n_in: int
    T: int
    alpha: float = 0.0          # forward activity sparsity
    beta: float = 0.0           # backward (derivative) sparsity
    omega: float = 0.0          # parameter sparsity

    @property
    def at(self):  # alpha tilde
        return 1.0 - self.alpha

    @property
    def bt(self):
        return 1.0 - self.beta

    @property
    def wt(self):
        return 1.0 - self.omega


def from_config(cfg: EGRUConfig, **sparsities) -> CostInputs:
    return CostInputs(n=cfg.n_hidden, p=cfg.n_rec_params, n_in=cfg.n_in,
                      T=cfg.seq_len, **sparsities)


def table1(ci: CostInputs) -> dict:
    n, p, T = ci.n, ci.p, ci.T
    at, bt, wt = ci.at, ci.bt, ci.wt
    return {
        "bptt": {"memory": T * n + p, "time_per_step": n * n + p},
        "rtrl_dense": {"memory": n + n * p, "time_per_step": n * n + n * n * p},
        "rtrl_param_sparse": {"memory": n + wt * n * p,
                              "time_per_step": wt * n * n + wt ** 2 * n * n * p},
        "rtrl_activity_sparse": {"memory": at * n + bt * n * p,
                                 "time_per_step": at * n * n + bt ** 2 * n * n * p},
        "rtrl_both": {"memory": at * n + wt * bt * n * p,
                      "time_per_step": wt * at * n * n + wt ** 2 * bt ** 2 * n * n * p},
        "snap1": {"memory": n + wt * n * (p / n),
                  "time_per_step": wt * n * n + wt * p},
        "snap2": {"memory": n + wt ** 2 * n * p,
                  "time_per_step": wt * n * n + wt ** 3 * n * n * p},
    }


def savings_factor(beta_t: float, beta_prev: float, omega: float) -> float:
    """Per-step influence-update savings  w~^2 b~(t) b~(t-1)  (Secs. 4-5)."""
    wt = 1.0 - omega
    return wt * wt * (1.0 - beta_t) * (1.0 - beta_prev)


def compute_adjusted_iterations(betas: np.ndarray, betas_prev: np.ndarray,
                                omega: float) -> np.ndarray:
    """Cumulative compute (in dense-RTRL-iteration units) over training.

    betas: [iters, T] per-step backward sparsity measurements."""
    per_step = savings_factor(betas, betas_prev, omega)   # elementwise
    per_iter = per_step.mean(axis=-1)
    return np.cumsum(per_iter)


def tpu_block_factor(mask: np.ndarray, block: int = 8) -> float:
    """Fraction of [block x block] tiles with any nonzero — the block-granular
    density a TPU kernel can actually skip at (vs unstructured w~)."""
    h = -(-mask.shape[0] // block) * block
    w = -(-mask.shape[1] // block) * block
    padded = np.zeros((h, w), mask.dtype)
    padded[: mask.shape[0], : mask.shape[1]] = mask
    tiles = padded.reshape(h // block, block, w // block, block)
    return float((tiles.sum(axis=(1, 3)) > 0).mean())


def influence_update_flops(n: int, P: int, K: int | None = None,
                           K_prev: int | None = None,
                           Pc: int | None = None) -> float:
    """MXU FLOPs of one influence update (madd = 2 ops).

    Dense (masked or not): 2 n^2 P.  Row-compact with static capacities
    K/K_prev: 2 K K_prev P — the executable form of the paper's
    beta~(t) beta~(t-1) n^2 p factor (kernels/compact.py).  DUAL compact
    (row + column, Pc = live column count ~= w~ P): 2 K K_prev Pc — the
    combined  w~ beta~(t) beta~(t-1) n^2 p  as executable work, i.e. the
    Table-1 "RTRL + both" time row up to the w~ n^2 J-side term."""
    width = P if Pc is None else Pc
    if K is None:
        return 2.0 * n * n * width
    return 2.0 * K * (K if K_prev is None else K_prev) * width


def influence_carry_bytes(B: int, K: int, P: int,
                          dtype_bytes: int = 4) -> int:
    """Carried-influence memory: [B, K, P] values + [B, K] int32 indices.
    At full width P this is the paper's beta~ n p; at compact column width
    Pc it is the combined w~ beta~ n p (Table-1 "RTRL + both" memory row)."""
    return B * K * P * dtype_bytes + B * K * 4


def ragged_influence_update_flops(Kbs, Kbs_prev, Pc: int) -> float:
    """MXU FLOPs of one RAGGED fused influence update: Sigma_b 2 K_b K'_b Pc
    (madd = 2 ops).  This is what the fused kernel EXECUTES — per-example
    capacities instead of the batch-wide max of `influence_update_flops`;
    the ratio of the two is the batch tax the ragged grid skips."""
    Kbs = np.asarray(Kbs, float)
    Kbs_prev = np.asarray(Kbs_prev, float)
    return float(2.0 * Pc * np.sum(Kbs * Kbs_prev))


def influence_update_bytes(B: int, K: int, K_prev: int, Pc: int, n: int,
                           dtype_bytes: int = 4) -> int:
    """Minimum HBM traffic of one fused influence update: the carry read
    [B, K_prev, Pc] + write [B, K, Pc] at the carry dtype (bf16 halves
    both), plus the f32 J-hat pass [B, n, n], the gathered M-bar rows
    [B, K, Pc] (f32), and the int32 index/count side arrays.  With the fused
    kernel this is ALSO the total traffic — gather, contraction, M-bar add
    and hp scale share one read and one write of the carry; the unfused
    chain re-streams the [B, K, Pc] intermediate at least twice more.
    Pairs with `influence_update_flops` to place a config on a roofline."""
    carry = (B * K_prev * Pc + B * K * Pc) * dtype_bytes
    jhat = B * n * n * 4
    mbar = B * K * Pc * 4
    side = 2 * B * K * 4 + B * K * 4 + 2 * B * 4     # idx pair, hp rows, counts
    return carry + jhat + mbar + side


def diag_influence_flops(n: int, p: int, omega: float = 0.0) -> float:
    """FLOPs of one DIAGONAL-Jacobian exact-RTRL trace update (madd = 2):
    e <- a*e + mbar over p per-parameter trace entries, so 2 w~ p — LINEAR
    in p with NO n² factor at all (the `engine="diag_exact"` regime; each
    of the p traces touches exactly one of the n state entries, hence
    O(n·p) total work n-scaling but 2p executable ops).  Compare
    `influence_update_flops`' 2 n² P for the dense-Jacobian family: the
    diagonal family is cheaper by a full factor of n², which is why exact
    RTRL is tractable at LM scale for RG-LRU/RWKV-style cells."""
    return 2.0 * (1.0 - omega) * p


def eprop_trace_bytes(B: int, n: int, n_in: int, dtype_bytes: int = 4,
                      adaptive: bool = True) -> int:
    """e-prop trace memory (repro.cells.snn): rank-1 membrane traces
    eps_v over inputs [B, n_in] and recurrent spikes [B, n] (rank-1 because
    the decay alpha is a constant, independent of the postsynaptic unit),
    plus — only for ADAPTIVE thresholds (ALIF, beta_a > 0) — the full
    [B, j, n] adaptation traces eps_a whose decay rho - psi_k beta_a DOES
    depend on the postsynaptic unit k."""
    membrane = B * (n_in + n) * dtype_bytes
    adaptation = B * (n_in + n) * n * dtype_bytes if adaptive else 0
    return membrane + adaptation


def live_col_fraction(live_cols: int, total_cols: int) -> float:
    """Live fraction of a parameter-column axis — the w~ factor.  The ONE
    definition shared by `sparse_rtrl.flat_col_density` (layout-level) and
    `carry_footprint` (byte-level), so density and size accounting can never
    drift apart."""
    return live_cols / max(total_cols, 1)


def carry_footprint(B: int, K: int, n_cols: int, live_cols: int | None = None,
                    dtype_bytes: int = 4) -> dict:
    """Allocated vs LIVE influence-carry footprint of one [B, K, n_cols]
    buffer, via `influence_carry_bytes` for both widths.

    `live_cols` (e.g. ColLayout.Pc, or a column-mask popcount) prices the
    buffer at its live width — the true O(w~ beta~ n p) footprint a
    prune-and-regrow rewire event shrinks or grows, as opposed to the
    lane-padded allocation which is static."""
    alloc = influence_carry_bytes(B, K, n_cols, dtype_bytes)
    live = alloc if live_cols is None else \
        influence_carry_bytes(B, K, live_cols, dtype_bytes)
    return {"alloc_bytes": alloc, "live_bytes": live,
            "col_density": (1.0 if live_cols is None
                            else live_col_fraction(live_cols, n_cols))}


def stacked_influence_update_flops(ns, Ps, betas_t=None, betas_prev=None,
                                   omegas=None) -> dict:
    """Op accounting for ONE stacked influence update as the sum over the
    block lower-triangular (l, j) blocks (core/stacked_rtrl).

    Per block (l, j <= l), with per-layer densities b~_l = 1 - beta_l and
    w~_l = 1 - omega_l (madd = 2 ops):

      J-term      2 w~_l b~_l(t) b~_l(t-1) n_l^2 . w~_j P_j
      cross-term  2 w~_l b~_l(t) b~_{l-1}(t) n_l n_{l-1} . w~_j P_j  (l > 0)

    — the cross-layer injection is event-sparse on BOTH sides because layer
    l's input is the layer below's sparse activity.  betas/omegas default to
    0 (dense).  Returns {"dense", "sparse", "savings", "blocks"} where
    blocks maps (l, j) -> (J-term flops, cross-term flops)."""
    L = len(ns)
    ns = np.asarray(ns, float)
    Ps = np.asarray(Ps, float)
    bt = 1.0 - np.asarray(betas_t if betas_t is not None else [0.0] * L)
    btp = 1.0 - np.asarray(betas_prev if betas_prev is not None
                           else (betas_t if betas_t is not None
                                 else [0.0] * L))
    wt = 1.0 - np.asarray(omegas if omegas is not None else [0.0] * L)
    blocks, dense, sparse = {}, 0.0, 0.0
    for l in range(L):
        for j in range(l + 1):
            jterm = 2.0 * wt[l] * bt[l] * btp[l] * ns[l] ** 2 * wt[j] * Ps[j]
            jdense = 2.0 * ns[l] ** 2 * Ps[j]
            xterm = xdense = 0.0
            if l > 0:
                xterm = (2.0 * wt[l] * bt[l] * bt[l - 1]
                         * ns[l] * ns[l - 1] * wt[j] * Ps[j])
                xdense = 2.0 * ns[l] * ns[l - 1] * Ps[j]
            blocks[(l, j)] = (jterm, xterm)
            dense += jdense + xdense
            sparse += jterm + xterm
    return {"dense": dense, "sparse": sparse,
            "savings": sparse / dense if dense else 1.0, "blocks": blocks}


def stacked_savings_factor(betas_t, betas_prev, omegas=None) -> float:
    """Aggregate per-step savings of the stacked update vs its dense form —
    the depth generalization of `savings_factor` (uses unit widths/params,
    so it is exact when all layers share one width)."""
    L = len(betas_t)
    acc = stacked_influence_update_flops([1.0] * L, [1.0] * L, betas_t,
                                         betas_prev, omegas)
    return float(acc["savings"])


def measured_op_count(ci: CostInputs, beta_t: float, beta_prev: float) -> dict:
    """Exact op counts for one influence update with given measured sparsity
    (what the hardware-optimal implementation would execute)."""
    n, p = ci.n, ci.p
    dense = n * n * p
    return {
        "dense_ops": dense,
        "activity_ops": (1 - beta_t) * (1 - beta_prev) * dense,
        "both_ops": savings_factor(beta_t, beta_prev, ci.omega) * dense,
    }
