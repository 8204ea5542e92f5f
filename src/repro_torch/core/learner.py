"""Streaming learner API, in PyTorch: one protocol over the gradient engines
the port has so far.

Counterpart of `repro.core.learner`:

    learner = make_learner(LearnerSpec(engine=..., cfg=..., backend=...))
    carry   = learner.init(params, masks, (x_0, y_0), t_total=T)
    carry, out = learner.step(carry, x_t, y_t)    # any number of times
    grads   = learner.grads(carry)                # whenever a consumer wants
    carry   = learner.reset_grads(carry, new_params)   # after an update

``carry`` is a dict holding everything that evolves (params, activity,
influence state, gradient accumulators ``gw``/``gout``, running ``loss``,
the loss scale ``t_total``); it is O(1) in stream length.  Per-step loss is
``xent(readout(a_t), y_t) / t_total``.  The spec strings mean what they
mean in the JAX package.

Ported: engine "sparse" with all four backends — "dense" (masked-dense
per-gate reference), "pallas" (block-sparse update on the dense flat carry,
the CUDA kernel of `kernels.influence`), "compact" and "compact_fused" —
with or without the column-compact carry (f32, or bf16 for the compact
ones); engine "stacked" at any depth (one layer delegates to "sparse", as
the JAX package does); the cell zoo's engines "diag_exact" (exact
diagonal traces for any jac_kind "diagonal" cell, "diag" its alias),
"eprop" (the SNN) and "snap" (SnAp-1/2 on the dense per-gate backend); and
engine "bptt", the streaming BPTT oracle; and engine "scaled"
(`core.scaled_rtrl`: the compact carry of a wide RNN, single layer or
stacked, backends "compact" and "compact_fused").  The sparse, stacked and
scaled learners are rewirable (``LearnerSpec(rewirable=True)``, every
backend but compact_fused): ``learner.rewire(carry, event_key)`` prunes
and regrows the masks between windows with exact carry migration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.cells import resolve_cell
from repro_torch.core import cells, sparse_rtrl as SP, stacked_rtrl as ST
from repro_torch.core.cells import EGRUConfig, StackedEGRUConfig
from repro_torch.kernels import compact as CK, ops as kops
from repro_torch.obs.trace import span
from repro_torch import sharding as SH
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class StepOut(NamedTuple):
    """What one online step yields to the consumer."""
    loss: torch.Tensor             # instantaneous loss L_t (1/t_total-scaled)
    readout: torch.Tensor | None   # logits [B, n_out] at this step
    stats: dict                    # per-step sparsity/overflow stats
    grads: Tree | None = None      # THIS step's gradient term (per_step_grads)


@dataclasses.dataclass(frozen=True)
class LearnerSpec:
    """Everything needed to construct a learner (the JAX package's fields;
    see `repro.core.learner.LearnerSpec` for their meaning)."""
    engine: str = "sparse"
    cfg: Any = None
    backend: str = "dense"
    col_compact: bool | None = None
    influence_dtype: str = "float32"
    layers: int = 1
    capacity: float = 1.0
    interpret: bool | None = None
    order: int = 1
    horizon: int | None = None
    per_step_grads: bool = False
    delegate_single_layer: bool = True
    rewirable: bool = False


class _LearnerBase:
    """Shared carry conventions: dict carry with 'params', 'loss', 't_total'
    and gradient accumulators 'gw'/'gout'."""
    spec: LearnerSpec

    def rewire(self, carry: Tree, event_key: tuple, *, frac: float = 0.1,
               method: str = "rigl", block: int = 1, scores=None) -> Tree:
        """Prune-and-regrow mask rewire event (`repro_torch.sparsity`).
        Defined for the sparse/stacked learners constructed with
        ``LearnerSpec(rewirable=True)``; everywhere else there is no mask
        state to evolve, so this is an error, not a silent no-op."""
        raise NotImplementedError(
            f"{type(self).__name__} has no dynamic-sparsity support: rewire "
            "is defined for the sparse/stacked exact-RTRL learners "
            "constructed with LearnerSpec(rewirable=True)")

    def opt_mask_of(self, carry: Tree) -> Tree:
        """The CURRENT mask tree in the optimizer's parameter structure
        (what `optim.optimizers.set_opt_mask` consumes after a rewire)."""
        raise NotImplementedError(
            f"{type(self).__name__} carries no mask state")

    def reset_grads(self, carry: Tree, params: Tree | None = None) -> Tree:
        carry = dict(carry)
        if params is not None:
            carry["params"] = params
        for k in ("gw", "gout"):
            if k in carry:
                carry[k] = tree_map(torch.zeros_like, carry[k])
        carry["loss"] = torch.zeros_like(carry["loss"])
        return carry

    def params_of(self, carry: Tree) -> Tree:
        """The current parameters in the structure the optimizer sees."""
        return carry["params"]

    def read_window(self, carry: Tree, stats: dict, grads: bool = True):
        """(loss, gradients or None, stats) at the end of an update window:
        the whole batch's, on every rank of a sharded carry.  `stats` are
        the window's per-step stats stacked (`runtime.online.stream_grads`).
        One device's carry holds them as they are."""
        return carry["loss"], (self.grads(carry) if grads else None), stats

    def _freeze_static(self, **kv):
        """Bind init-derived static structure (masks, layouts) to this
        learner instance ONCE; re-initialising with different structure
        raises (make a new learner instead)."""
        prev = getattr(self, "_frozen", None)
        if prev is None:
            self._frozen = kv
            return
        for k, v in kv.items():
            old = prev[k]
            same = old is v or (
                isinstance(v, (int, float, bool, type(None))) and old == v)
            if not same:
                raise ValueError(
                    f"learner already initialized with a different {k!r}; "
                    "carries are bound to the init-time structure — create "
                    "a fresh learner via make_learner(spec) instead")

    # -- mask-derived state -------------------------------------------------
    #
    # The column layout, column masks, J patterns and K2's block masks are
    # derived from the masks.  Without rewire they are fixed at init.  A
    # rewirable carry holds its masks (and the layout's arrays) in
    # carry["rw"]; `_sync` re-derives that state whenever the learner is
    # handed a carry whose rw it has not derived it from (after an event,
    # a checkpoint restore or a guard rollback).  The test is one identity
    # comparison a step: rw is never changed in place, only replaced.

    def _sync(self, carry: Tree) -> None:
        rw = carry.get("rw")
        if rw is not None and rw is not self._bound:
            self._bind(rw)

    @staticmethod
    def _check_rewirable(carry: Tree) -> None:
        if "rw" not in carry:
            raise NotImplementedError(
                "rewire needs LearnerSpec(rewirable=True) (mask state must "
                "live in the carry)")

    @staticmethod
    def _attach_rw(carry, rw, x0, y0):
        if rw is not None:
            carry["rw"] = rw
            # the last (x, y) seen: the rewire event's RigL scoring input
            carry["last"] = {"x": torch.zeros_like(x0, dtype=torch.float32),
                             "y": torch.zeros_like(y0, dtype=torch.int32)}
        return carry

    @staticmethod
    def _dense_scores(loss_of, params: Tree) -> Tree:
        """Gradient of loss_of(params) by autograd, detached, in params'
        structure (zeros for an unused leaf): RigL's dense scoring pass."""
        from repro_torch.tree import tree_flatten_with_path, tree_map_with_path
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        paths, leaves = zip(*tree_flatten_with_path(p))
        with torch.enable_grad():
            gs = torch.autograd.grad(loss_of(p), leaves, allow_unused=True)
        by_path = {path: torch.zeros_like(x) if g is None else g
                   for path, x, g in zip(paths, leaves, gs)}
        return tree_map_with_path(lambda path, _: by_path[path], p)

    @staticmethod
    def _base_carry(params: Tree, t_total: float, device) -> dict:
        f32 = dict(dtype=torch.float32, device=device)
        return {"params": params, "loss": torch.zeros((), **f32),
                "t_total": torch.tensor(float(t_total), **f32)}

    @staticmethod
    def _inst_loss_and_grads(po: Tree, a: torch.Tensor, y: torch.Tensor,
                             tt: torch.Tensor, batch: int | None = None):
        """Instantaneous loss xent(a W + b, y) / tt with its gradients in
        closed form: (loss, logits, {"W", "b"} readout grads, c-bar =
        dL/da).  `batch`: the global batch of which `a` holds a shard's
        rows (a sharded carry): the loss and every gradient are then this
        shard's partial sums of the global batch mean."""
        mm = cells.slot_mm          # rounds alike in a vmapped fleet slot
        logits = mm(a, po["W"]) + po["b"]
        logp = torch.log_softmax(logits, dim=-1)
        yl = y.long()[:, None]
        if batch is None:
            batch = a.shape[0]
            loss = -logp.gather(1, yl).mean() / tt
        else:
            loss = -logp.gather(1, yl).sum() / batch / tt
        # out of place: vmap has a batching rule for `scatter`, not for
        # `scatter_`
        onehot = torch.zeros_like(logp).scatter(1, yl, 1.0)
        dlogits = (logp.exp() - onehot) / (batch * tt)
        gout = {"W": mm(a.T, dlogits), "b": dlogits.sum(dim=0)}
        return loss, logits, gout, mm(dlogits, po["W"].T)


# ---------------------------------------------------------------------------
# Exact single-layer sparse RTRL (dense / pallas / compact x col-compact)
# ---------------------------------------------------------------------------

_CL_FIELDS = ("src", "layer", "gate", "q", "j", "live")


def _cl_arrays(cl) -> dict:
    """The ColLayout's array fields as a carry-able dict; the ints (Pc,
    Pc_pad, P_pad) stay on the learner, since count-preserving rewire never
    changes them."""
    return {f: getattr(cl, f) for f in _CL_FIELDS}


_FUSED_REWIRE = ("backend='compact_fused' compiles a static gate-segment "
                 "table from the ColLayout, so runtime mask rewiring is not "
                 "supported — use backend='compact' with rewirable=True")


class SparseLearner(_LearnerBase):
    """`repro.core.sparse_rtrl` as a streaming learner — all four backends,
    the flat ones optionally (by default whenever masks are given)
    column-compact.  Exact.

    With ``spec.rewirable`` the masks and the state derived from them
    (column layout or mask, J pattern) live in ``carry["rw"]``, so that
    `rewire` can evolve them with every buffer shape unchanged
    (count-preserving prune-and-regrow keeps Pc)."""

    def __init__(self, spec: LearnerSpec):
        if spec.backend not in SP.BACKENDS:
            raise ValueError(
                f"backend must be one of {SP.BACKENDS}, got {spec.backend!r}")
        if spec.backend == "compact_fused" and spec.rewirable:
            raise ValueError(_FUSED_REWIRE)
        if (SP.influence_carry_dtype(spec.influence_dtype) != torch.float32
                and spec.backend in ("dense", "pallas")):
            raise ValueError("influence_dtype='bfloat16' needs a compact "
                             "carry (backend 'compact' or 'compact_fused')")
        self.spec = spec
        self.cfg: EGRUConfig = spec.cfg
        self.cell = resolve_cell(spec.cfg)
        self.backend = spec.backend

    def init(self, params, masks, batch, t_total: float = 1.0):
        cfg = self.cfg
        x0, y0 = batch
        B = x0.shape[0]
        device = params["out"]["W"].device
        col_compact = self.spec.col_compact
        if self.backend == "compact_fused":
            if col_compact is False:
                raise ValueError("compact_fused always carries the "
                                 "parameter axis column-compact")
            col_compact = True
        elif col_compact is None:
            col_compact = masks is not None and self.backend != "dense"
        if self.spec.rewirable and masks is None:
            raise ValueError("rewirable=True requires parameter masks")
        self._freeze_static(masks=masks, col_compact=col_compact)
        self.masks = masks
        carry = self._base_carry(params, t_total, device)
        carry["a"] = cells.init_state(cfg, B, device=device)
        carry["gout"] = tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), params["out"])
        carry["beta_prev"] = torch.ones((), dtype=torch.float32,
                                        device=device)
        # the mask-derived state, under carry["rw"]'s keys
        state = {"masks": masks}
        self._cl = None
        if self.backend == "dense":
            carry["M"] = SP.init_influence(cfg, B, device=device)
            carry["gw"] = tree_map(
                lambda x: torch.zeros_like(x, dtype=torch.float32),
                cells.rec_param_tree(params))
        else:
            layout = SP.flat_layout(cfg, self.spec.influence_dtype)
            self.layout = layout
            if col_compact:
                self._cl = SP.col_layout(layout, masks, device=device)
                state["cl"] = _cl_arrays(self._cl)
            else:
                # [P_pad] liveness; padding columns are dead even without
                # masks
                state["colm"] = SP.flat_col_mask(layout, masks, device=device)
            if self.backend == "pallas":
                state["jmask"] = SP.flat_jmask(cfg, masks)
            if self.backend == "compact_fused":
                from repro_torch.kernels import compact_fused as CF
                # checks the fused layout contract: gate columns contiguous
                self._segs = CF.fused_segments(layout, self._cl)
            P_carry = self._cl.Pc_pad if col_compact else layout.P_pad
            carry["gw"] = torch.zeros((P_carry,), dtype=torch.float32,
                                      device=device)
            f32 = dict(dtype=torch.float32, device=device)
            if self.backend == "pallas":
                # full width: the flat axis itself, dead columns zeroed
                carry["M"] = torch.zeros((B, cfg.n_hidden, P_carry), **f32)
            else:
                # compact backends: [B, K, Pc_pad] column-compact, else
                # [B, K, P_pad] with the dead columns masked out of M-bar
                K = SP.capacity_K(cfg.n_hidden, self.spec.capacity)
                carry["vals"] = torch.zeros((B, K, P_carry),
                                            dtype=layout.carry_dtype,
                                            device=device)
                carry["idx"] = torch.full((B, K), CK.DEAD, dtype=torch.int32,
                                          device=device)
        self._bind(state)
        return self._attach_rw(carry, state if self.spec.rewirable else None,
                               x0, y0)

    def _bind(self, rw: dict) -> None:
        """Derive the learner's mask state from rw (the carry's "rw", or
        init's own): the masks of the dense update, the ColLayout, the
        carry axis's column liveness, the J pattern and K2's two constant
        block masks."""
        self._bound = rw
        self._mk = rw["masks"]
        if self.backend == "dense":
            return
        if self._cl is not None:
            self._cl = dataclasses.replace(self._cl, **rw["cl"])
        if self.backend == "pallas":
            # the column liveness of the carry's axis
            self._colm = self._cl.live if self._cl is not None \
                else rw["colm"]
            self._jm = rw["jmask"]
            # the kernel's column and J block masks, fixed between events
            self._kmasks = kops.constant_block_masks(
                self.cfg.n_hidden, self._colm.shape[0], self._jm, self._colm,
                device=self._colm.device)
        else:
            self._colm = None if self._cl is not None else rw["colm"]

    def step(self, carry, x_t, y_t):
        self._sync(carry)
        cfg, params = self.cfg, carry["params"]
        w = cells.rec_param_tree(params)
        new = dict(carry)
        extra_stats = {}
        if self.backend == "dense":
            a_new, hp, Jhat, mbar = self.cell.partials(w, carry["a"], x_t)
            M_new = SP.influence_update(cfg, carry["M"], hp, Jhat, mbar,
                                        self._mk)
            lt, logits, gout_t, cbar = self._inst_loss_and_grads(
                params["out"], a_new, y_t, carry["t_total"])
            gw_t = SP.influence_grads(cfg, M_new, cbar)
            new["gw"] = tree_map(torch.add, carry["gw"], gw_t)
            new["M"] = M_new
            row_density = SP._row_density(M_new)
        elif self.backend == "pallas":
            a_new, hp, operands = SP.pallas_step_operands(
                cfg, w, self.layout, carry["a"], carry["M"], x_t, cl=self._cl,
                col_mask=self._colm, jmask=self._jm)
            M_new = kops.influence_update(*operands,
                                          block_masks=self._kmasks)
            lt, logits, gout_t, cbar = self._inst_loss_and_grads(
                params["out"], a_new, y_t, carry["t_total"])
            gw_t = CK.row_contract(cbar, M_new)
            new["gw"] = carry["gw"] + gw_t
            new["M"] = M_new
            row_density = (M_new != 0.0).any(dim=2).float().mean()
        else:
            if self.backend == "compact_fused":
                a_new, hp, vals_new, idx_new, count, overflow = \
                    SP.flat_compact_fused_step(
                        cfg, w, self.layout, carry["a"], carry["vals"],
                        carry["idx"], x_t, cl=self._cl)
            else:
                a_new, hp, vals_new, idx_new, count, overflow = \
                    SP.flat_compact_step(cfg, w, self.layout, carry["a"],
                                         carry["vals"], carry["idx"], x_t,
                                         self._colm, cl=self._cl)
            lt, logits, gout_t, cbar = self._inst_loss_and_grads(
                params["out"], a_new, y_t, carry["t_total"])
            gw_t = CK.compact_grads(vals_new, idx_new, cbar)
            new["gw"] = carry["gw"] + gw_t
            new["vals"], new["idx"] = vals_new, idx_new
            row_density = ((idx_new >= 0).sum(dim=1).float().mean()
                           / cfg.n_hidden)
            extra_stats["overflow"] = overflow.max()
        new["a"] = a_new
        new["gout"] = tree_map(torch.add, carry["gout"], gout_t)
        new["loss"] = carry["loss"] + lt
        if "rw" in carry:
            new["last"] = {"x": x_t.float(), "y": y_t.int()}
        stats = {"alpha": (a_new == 0.0).float().mean(),
                 "beta": (hp == 0.0).float().mean(),
                 "beta_prev": carry["beta_prev"],
                 "m_row_density": row_density, **extra_stats}
        new["beta_prev"] = stats["beta"]
        step_grads = None
        if self.spec.per_step_grads:
            step_grads = self._finish_gw(gw_t)
            step_grads["out"] = gout_t
        return new, StepOut(lt, logits, stats, step_grads)

    def _finish_gw(self, gw):
        if self.backend == "dense":
            return dict(gw)
        if self._cl is not None:
            gw = SP.cols_to_flat(self._cl, gw)
        return SP.unflatten_flat_grads(self.cfg, self.layout, gw)

    def grads(self, carry):
        self._sync(carry)
        grads = self._finish_gw(carry["gw"])
        grads["out"] = carry["gout"]
        return grads

    # -- dynamic sparsity ---------------------------------------------------

    def _rigl_scores(self, carry):
        """Dense one-step gradient (straight-through surrogate) from the
        carry's activity and last (x, y): RigL's dense scoring pass, run
        only at rewire events."""
        cfg, last = self.cfg, carry["last"]

        def loss_of(params):
            a_new = cells.step_straight_through(
                cfg, cells.rec_param_tree(params), carry["a"], last["x"])
            return cells.xent(cells.readout(params, a_new), last["y"])

        return cells.rec_param_tree(self._dense_scores(loss_of,
                                                       carry["params"]))

    @torch.no_grad()
    def rewire(self, carry, event_key, *, frac: float = 0.1,
               method: str = "rigl", block: int = 1, scores=None):
        """One prune-and-regrow event with EXACT carry migration, between
        windows: fire it at an update boundary (after `reset_grads`), where
        the pruned columns' accumulator entries were just consumed.  Every
        carry shape is kept; the masks, the column maps and the state the
        learner derives from them change.  `scores` ({gate: {W, R}}) hands
        SET its scores instead of drawing them from `event_key`."""
        from repro_torch import sparsity as DS
        self._check_rewirable(carry)
        self._sync(carry)
        cfg = self.cfg
        carry = dict(carry)
        rw = dict(carry["rw"])
        old_masks = rw["masks"]
        params = carry["params"]
        grads = self._rigl_scores(carry) if method == "rigl" else None
        new_masks = DS.rewire_masks(old_masks, cells.rec_param_tree(params),
                                    grads, frac=frac, key=event_key,
                                    method=method, block=block, scores=scores)
        rw["masks"] = new_masks
        # old-then-new masking: pruned weights -> 0, grown weights exactly 0
        carry["params"] = SP.apply_masks(SP.apply_masks(params, old_masks),
                                         new_masks)
        if self.backend == "dense":
            carry["M"] = DS.migrate_dense(cfg, carry["M"], new_masks)
            carry["gw"] = SP.apply_masks(
                carry["gw"], {k: v for k, v in new_masks.items()
                              if k != "out"})
        else:
            buf = "M" if self.backend == "pallas" else "vals"
            device = carry[buf].device
            if self._cl is not None:
                new_cl = SP.col_layout(self.layout, new_masks, device=device)
                plan = DS.migration_plan(self._cl, new_cl)
                for k in (buf, "gw"):
                    carry[k] = DS.migrate_influence(self._cl, new_cl,
                                                    carry[k], plan)
                rw["cl"] = _cl_arrays(new_cl)
            else:
                # full-width carry: the new column mask kills the pruned
                # columns (grown ones are already exactly zero)
                colm = SP.flat_col_mask(self.layout, new_masks, device=device)
                for k in (buf, "gw"):
                    carry[k] = DS.migrate_flat(colm, carry[k])
                rw["colm"] = colm
            if self.backend == "pallas":
                rw["jmask"] = SP.flat_jmask(cfg, new_masks)
        carry["rw"] = rw
        self._bind(rw)
        return carry

    def opt_mask_of(self, carry):
        masks = dict(carry["rw"]["masks"])
        masks.setdefault("out", None)
        return masks


# ---------------------------------------------------------------------------
# Stacked RTRL: the one-layer delegation
# ---------------------------------------------------------------------------

class _SingleLayerStackedLearner(_LearnerBase):
    """Stacked L=1 delegation: the single-layer engine, with params/grads
    re-wrapped into the stacked {'layers': [...], 'out': ...} structure."""

    def __init__(self, spec: LearnerSpec, scfg: StackedEGRUConfig):
        self.spec = spec
        self.cfg = scfg
        self.inner = SparseLearner(
            dataclasses.replace(spec, engine="sparse", cfg=scfg.layer_cfg(0)))

    def init(self, params, masks, batch, t_total: float = 1.0):
        sparams = dict(params["layers"][0])
        sparams["out"] = params["out"]
        # memoize the single-layer mask view, so re-init with the SAME
        # stacked masks hands the inner learner the same object
        if masks is None:
            self._smasks = None
        elif getattr(self, "_smasks_src", None) is not masks:
            self._smasks_src = masks
            self._smasks = dict(masks[0])
            self._smasks["out"] = None
        return self.inner.init(sparams, self._smasks, batch, t_total)

    def step(self, carry, x_t, y_t):
        carry, out = self.inner.step(carry, x_t, y_t)
        stats = dict(out.stats)
        stats["alpha_layers"] = stats["alpha"][None]
        stats["beta_layers"] = stats["beta"][None]
        grads = out.grads
        if grads is not None:
            grads = self._rewrap(grads)
        return carry, StepOut(out.loss, out.readout, stats, grads)

    @staticmethod
    def _rewrap(g):
        return {"layers": [{k: v for k, v in g.items() if k != "out"}],
                "out": g["out"]}

    def grads(self, carry):
        return self._rewrap(self.inner.grads(carry))

    def params_of(self, carry):
        return self._rewrap(carry["params"])

    def reset_grads(self, carry, params=None):
        if params is not None:                  # stacked -> single-layer view
            sparams = dict(params["layers"][0])
            sparams["out"] = params["out"]
            params = sparams
        return self.inner.reset_grads(carry, params)

    def rewire(self, carry, event_key, *, frac: float = 0.1,
               method: str = "rigl", block: int = 1, scores=None):
        # layer 0 of a stacked rewire folds 0 into the event key
        # (rewire_stacked_masks' convention): keep the delegation aligned
        from repro_torch.sparsity.schedule import fold_in
        return self.inner.rewire(
            carry, fold_in(event_key, 0), frac=frac, method=method,
            block=block, scores=None if scores is None else scores[0])

    def opt_mask_of(self, carry):
        masks = self.inner.opt_mask_of(carry)
        return {"layers": [{k: v for k, v in masks.items() if k != "out"}],
                "out": None}


class StackedLearner(_LearnerBase):
    """`repro.core.stacked_rtrl` as a streaming learner: the block
    lower-triangular influence carried per layer, every backend.  Exact.
    One layer delegates to the single-layer engine (unless
    `spec.delegate_single_layer` is False).  Rewirable as SparseLearner,
    with one mask tree a layer and one migration plan for every layer's
    buffer (they share the stacked column axis)."""

    def __new__(cls, spec: LearnerSpec):
        scfg = cls._stacked_cfg(spec)
        if scfg.n_layers == 1 and spec.delegate_single_layer:
            return _SingleLayerStackedLearner(spec, scfg)
        return super().__new__(cls)

    @staticmethod
    def _stacked_cfg(spec: LearnerSpec) -> StackedEGRUConfig:
        if isinstance(spec.cfg, StackedEGRUConfig):
            return spec.cfg
        return cells.stacked_config(spec.cfg, spec.layers)

    def __init__(self, spec: LearnerSpec):
        if spec.backend not in SP.BACKENDS:
            raise ValueError(
                f"backend must be one of {SP.BACKENDS}, got {spec.backend!r}")
        if spec.backend == "compact_fused" and spec.rewirable:
            raise ValueError(_FUSED_REWIRE)
        if (SP.influence_carry_dtype(spec.influence_dtype) != torch.float32
                and spec.backend in ("dense", "pallas")):
            raise ValueError("influence_dtype='bfloat16' needs a compact "
                             "carry (backend 'compact' or 'compact_fused')")
        self.spec = spec
        self.cfg = self._stacked_cfg(spec)
        self.backend = spec.backend
        self.lcfgs = [self.cfg.layer_cfg(l) for l in range(self.cfg.n_layers)]

    def init(self, params, masks, batch, t_total: float = 1.0):
        cfg = self.cfg
        x0, y0 = batch
        B = x0.shape[0]
        L = cfg.n_layers
        device = params["out"]["W"].device
        col_compact = self.spec.col_compact
        if self.backend == "compact_fused":
            if col_compact is False:
                raise ValueError("compact_fused always carries the "
                                 "parameter axis column-compact")
            col_compact = True
        elif col_compact is None:
            col_compact = masks is not None and self.backend != "dense"
        if self.spec.rewirable and masks is None:
            raise ValueError("rewirable=True requires parameter masks")
        self._freeze_static(masks=masks, col_compact=col_compact)
        slayout = ST.stacked_layout(cfg)
        self.slayout = slayout
        # the mask-derived state, under carry["rw"]'s keys
        state = {"masks": None if masks is None else tuple(masks)}
        self._cl = ST.stacked_col_layout(slayout, masks, device=device) \
            if col_compact else None
        if self._cl is not None:
            state["cl"] = _cl_arrays(self._cl)
        else:
            state["colms"] = ST.layer_col_masks(
                slayout, ST.stacked_col_mask(slayout, masks, device=device))
        if self.backend == "pallas":
            state["jms"] = tuple(
                SP.flat_jmask(self.lcfgs[l], None if masks is None
                              else masks[l]) for l in range(L))
        if self.backend == "compact_fused":
            from repro_torch.kernels import compact_fused as CF
            # checks the fused layout contract: gate columns contiguous
            self._segs = tuple(
                CF.fused_segments(slayout.layers[l], self._cl, layer=l)
                for l in range(L))
        P_carry = self._cl.Pc_pad if self._cl is not None else slayout.P_pad
        carry = self._base_carry(params, t_total, device)
        carry["a"] = cells.init_stacked_state(cfg, B, device=device)
        carry["gw"] = torch.zeros((P_carry,), dtype=torch.float32,
                                  device=device)
        carry["gout"] = tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), params["out"])
        carry["beta_prev"] = torch.ones((L,), dtype=torch.float32,
                                        device=device)
        f32 = dict(dtype=torch.float32, device=device)
        if self.backend in ("dense", "pallas"):
            carry["M"] = tuple(torch.zeros((B, n, P_carry), **f32)
                               for n in cfg.layer_sizes)
        else:
            Ks = [SP.capacity_K(n, self.spec.capacity)
                  for n in cfg.layer_sizes]
            cdtype = SP.influence_carry_dtype(self.spec.influence_dtype)
            carry["vals"] = tuple(
                torch.zeros((B, K, P_carry), dtype=cdtype, device=device)
                for K in Ks)
            carry["idx"] = tuple(
                torch.full((B, K), CK.DEAD, dtype=torch.int32, device=device)
                for K in Ks)
        self._bind(state)
        return self._attach_rw(carry, state if self.spec.rewirable else None,
                               x0, y0)

    def _bind(self, rw: dict) -> None:
        """Derive the learner's mask state from rw: the ColLayout, the
        full-width per-layer column masks (`colms`), the column liveness
        each layer's update sees (`_klives`, j > l killed) and, for pallas,
        every layer's two constant K2 block masks."""
        self._bound = rw
        if self._cl is not None:
            self._cl = dataclasses.replace(self._cl, **rw["cl"])
            self.colms = None
            self._klives = ST.layer_col_lives(self.slayout, self._cl)
        else:
            self.colms = self._klives = rw["colms"]
        if self.backend == "pallas":
            P_carry = self._klives[0].shape[0]
            self._kmasks = tuple(
                kops.constant_block_masks(
                    self.cfg.layer_sizes[l], P_carry, rw["jms"][l],
                    self._klives[l], device=self._klives[l].device)
                for l in range(self.cfg.n_layers))

    def _flat_layer_step(self, l, ws, M_prev, a_prev, inp, M_below):
        """Layer l of the dense/pallas step: (a_new, hp, M_new), the cross
        term B-hat M^(l-1)_t added to M-bar in f32 before the update."""
        a_new, hp, ops = SP.pallas_step_operands(
            self.lcfgs[l], ws[l], self.slayout.layers[l], a_prev, M_prev,
            inp, cl=self._cl, col_mask=self._klives[l], jmask=None, layer=l,
            offset=self.slayout.offsets[l], total_pad=self.slayout.P_pad,
            M_below=M_below)
        if self.backend == "pallas":
            return a_new, hp, kops.influence_update(
                *ops, block_masks=self._kmasks[l])
        hp, Jhat, M_prev, Mb = ops[:4]
        return a_new, hp, hp[:, :, None] * (torch.bmm(Jhat, M_prev) + Mb)

    def step(self, carry, x_t, y_t):
        self._sync(carry)
        cfg, params = self.cfg, carry["params"]
        ws = params["layers"]
        new = dict(carry)
        extra_stats = {}
        if self.backend in ("dense", "pallas"):
            inp, a_news, hps, M_news = x_t, [], [], []
            for l in range(cfg.n_layers):
                a_new, hp, M_new = self._flat_layer_step(
                    l, ws, carry["M"][l], carry["a"][l], inp,
                    M_news[-1] if l else None)
                a_news.append(a_new)
                hps.append(hp)
                M_news.append(M_new)
                inp = a_new
            lt, logits, gout_t, cbar = self._inst_loss_and_grads(
                params["out"], a_news[-1], y_t, carry["t_total"])
            gw_t = CK.row_contract(cbar, M_news[-1])
            new["M"] = tuple(M_news)
            row_density = torch.stack([(M != 0.0).any(dim=2).float().mean()
                                       for M in M_news]).mean()
        else:
            a_news, hps, vals_new, idx_new, ovs = ST.stacked_compact_step(
                cfg, ws, self.slayout, carry["a"], carry["vals"],
                carry["idx"], x_t, self.colms, cl=self._cl,
                backend=self.backend)
            lt, logits, gout_t, cbar = self._inst_loss_and_grads(
                params["out"], a_news[-1], y_t, carry["t_total"])
            gw_t = CK.compact_grads(vals_new[-1], idx_new[-1], cbar)
            new["vals"], new["idx"] = vals_new, idx_new
            row_density = torch.stack([
                (i >= 0).sum(dim=1).float().mean() / n
                for i, n in zip(idx_new, cfg.layer_sizes)]).mean()
            extra_stats["overflow"] = ovs.max()
        new["a"] = tuple(a_news)
        new["gw"] = carry["gw"] + gw_t
        new["gout"] = tree_map(torch.add, carry["gout"], gout_t)
        new["loss"] = carry["loss"] + lt
        if "rw" in carry:
            new["last"] = {"x": x_t.float(), "y": y_t.int()}
        alpha_l = torch.stack([(a == 0.0).float().mean() for a in a_news])
        beta_l = torch.stack([(h == 0.0).float().mean() for h in hps])
        stats = {"alpha": alpha_l.mean(), "beta": beta_l.mean(),
                 "alpha_layers": alpha_l, "beta_layers": beta_l,
                 "beta_prev": carry["beta_prev"],
                 "m_row_density": row_density, **extra_stats}
        new["beta_prev"] = beta_l
        step_grads = None
        if self.spec.per_step_grads:
            step_grads = self._finish_gw(gw_t)
            step_grads["out"] = gout_t
        return new, StepOut(lt, logits, stats, step_grads)

    def _finish_gw(self, gw):
        if self._cl is not None:
            gw = SP.cols_to_flat(self._cl, gw)
        return ST.unflatten_stacked_grads(self.cfg, self.slayout, gw)

    def grads(self, carry):
        self._sync(carry)
        grads = self._finish_gw(carry["gw"])
        grads["out"] = carry["gout"]
        return grads

    # -- dynamic sparsity ---------------------------------------------------

    def _rigl_scores(self, carry):
        cfg, last = self.cfg, carry["last"]

        def loss_of(params):
            a_new = cells.stacked_step_straight_through(
                cfg, params["layers"], carry["a"], last["x"])
            return cells.xent(cells.readout(params, a_new[-1]), last["y"])

        return self._dense_scores(loss_of, carry["params"])["layers"]

    @torch.no_grad()
    def rewire(self, carry, event_key, *, frac: float = 0.1,
               method: str = "rigl", block: int = 1, scores=None):
        """Stacked prune-and-regrow event: per-layer criteria (layer l folds
        l into the key) on the shared concatenated column axis; ONE
        migration plan remaps every layer's buffer.  See
        SparseLearner.rewire for the exactness contract."""
        from repro_torch import sparsity as DS
        self._check_rewirable(carry)
        self._sync(carry)
        carry = dict(carry)
        rw = dict(carry["rw"])
        old_masks = list(rw["masks"])
        params = dict(carry["params"])
        grads = self._rigl_scores(carry) if method == "rigl" else None
        new_masks = DS.rewire_stacked_masks(
            old_masks, params["layers"], grads, frac=frac, key=event_key,
            method=method, block=block, scores=scores)
        params["layers"] = [
            SP.apply_masks(SP.apply_masks(p, om), nm)
            for p, om, nm in zip(params["layers"], old_masks, new_masks)]
        carry["params"] = params
        rw["masks"] = tuple(new_masks)
        buf = "M" if self.backend in ("dense", "pallas") else "vals"
        device = carry["gw"].device
        if self._cl is not None:
            new_cl = ST.stacked_col_layout(self.slayout, new_masks,
                                           device=device)
            plan = DS.migration_plan(self._cl, new_cl)
            carry[buf] = tuple(DS.migrate_influence(self._cl, new_cl, M, plan)
                               for M in carry[buf])
            carry["gw"] = DS.migrate_influence(self._cl, new_cl, carry["gw"],
                                               plan)
            rw["cl"] = _cl_arrays(new_cl)
        else:
            colm = ST.stacked_col_mask(self.slayout, new_masks, device=device)
            colms = ST.layer_col_masks(self.slayout, colm)
            carry[buf] = tuple(DS.migrate_flat(cm, M)
                               for cm, M in zip(colms, carry[buf]))
            carry["gw"] = DS.migrate_flat(colm, carry["gw"])
            rw["colms"] = colms
        if self.backend == "pallas":
            rw["jms"] = tuple(SP.flat_jmask(self.lcfgs[l], new_masks[l])
                              for l in range(self.cfg.n_layers))
        carry["rw"] = rw
        self._bind(rw)
        return carry

    def opt_mask_of(self, carry):
        return {"layers": list(carry["rw"]["masks"]), "out": None}


# ---------------------------------------------------------------------------
# Scaled compact RTRL (n in the thousands)
# ---------------------------------------------------------------------------

class ScaledLearner(_LearnerBase):
    """`core.scaled_rtrl` as a streaming learner: the row-compact
    (optionally dual-compact) carry of a wide thresholded RNN, single layer
    or stacked, under ``carry["state"] = {"a", "vals", "idx"}`` (a tuple a
    layer each when stacked).  Exact up to row-capacity overflow, reported
    every step in ``stats["overflow"]``.

    The scaled engine is compact by construction: backend "compact_fused"
    runs one K1 launch a layer a step, every other backend string the
    "compact" step (as in the JAX package, whose scaled specs carry the
    LearnerSpec default "dense").  Rewirable on "compact" with masks and a
    column-compact carry; the ColLayout follows the carry's masks as in
    `SparseLearner._bind`.

    The sharded carry (`place(carry, mesh)`, by
    `scaled_rtrl.sharded_step_specs`): the batch over the mesh's batch
    axes ('data', with 'pod' in front) and the influence's compact column
    axis over 'model'.  `step` then runs the same compact step on every
    rank's local tensors: its rows of the batch and its slice of the
    column axis (the ColLayout's arrays cut to its columns), one K1
    launch a layer a step on its own columns under compact_fused, and NO
    collective: the contraction has no cross-column reduction, and the
    readout's loss and gradients accumulate as partial sums of the global
    batch mean (DTensor `Partial` over the batch axes).  `grads` issues
    the update's two collectives (`sharding`): one all_reduce over the
    batch axes of the accumulators, one all_gather over 'model' of the
    flat gradient's columns.  `read_window` (an update window's end, the
    `OnlineTrainer`'s) folds the loss, the window's stats and each
    example's live-row count into that one all_reduce, so every rank reads
    the whole batch's.  A rewire event on a sharded carry issues one
    all_gather over 'model' (every buffer's columns, then each rank keeps
    its new columns) and, with more than one batch shard, one all_reduce
    of the RigL scores over the batch axes.  A step's stats (overflow) are
    this rank's rows'."""

    def __init__(self, spec: LearnerSpec):
        self.fused = spec.backend == "compact_fused"
        if self.fused and spec.rewirable:
            raise ValueError(_FUSED_REWIRE)
        SP.influence_carry_dtype(spec.influence_dtype)   # validate early
        self.spec = spec
        self.cfg = spec.cfg                 # scaled_rtrl.ScaledRTRLConfig
        self.stacked = self.cfg.n_layers > 1
        self._shard_views = {}

    def init(self, params, masks, batch, t_total: float = 1.0):
        from repro_torch.core import scaled_rtrl as SC
        cfg = self.cfg
        x0, y0 = batch
        device = params["out"]["W"].device
        col_compact = self.spec.col_compact
        if self.fused:
            if col_compact is False:
                raise ValueError("compact_fused always carries the "
                                 "parameter axis column-compact")
            col_compact = True
        elif col_compact is None:
            col_compact = masks is not None
        if self.spec.rewirable and not (masks is not None and col_compact):
            raise ValueError(
                "rewirable ScaledLearner requires masks and col_compact "
                "(the full-width scaled carry tracks dead columns, so "
                "grow-at-zero exactness only holds on the compact carry)")
        self._freeze_static(masks=masks, col_compact=col_compact)
        self._device = device
        self._cl = cfg.col_layout(masks, device=device) if col_compact \
            else None
        if self.fused:
            from repro_torch.kernels import compact_fused as CF
            # checks the fused layout contract: gate columns contiguous
            lays = cfg.slayout().layers if self.stacked else (cfg.layout(),)
            for l, lay in enumerate(lays):
                CF.fused_segments(lay, self._cl, layer=l)
        carry = self._base_carry(params, t_total, device)
        carry["state"] = SC.init_state(cfg, self._cl,
                                       self.spec.influence_dtype,
                                       device=device)
        carry["gw"] = torch.zeros((self._carry_width(),), dtype=torch.float32,
                                  device=device)
        carry["gout"] = tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), params["out"])
        # the mask-derived state, under carry["rw"]'s keys
        rw = {"masks": tuple(masks) if self.stacked and masks is not None
              else masks}
        if self._cl is not None:
            rw["cl"] = _cl_arrays(self._cl)
        self._bind(rw)
        return self._attach_rw(carry, rw if self.spec.rewirable else None,
                               x0, y0)

    def _bind(self, rw: dict) -> None:
        """Derive the ColLayout's arrays from rw (the carry's "rw", or
        init's own)."""
        self._bound = rw
        self._shard_views = {}
        if self._cl is not None:
            self._cl = dataclasses.replace(self._cl, **rw["cl"])

    def step(self, carry, x_t, y_t):
        self._sync(carry)
        mesh = _carry_mesh(carry)
        if mesh is None:
            return self._step(carry, x_t, y_t, self._cl)
        if self.spec.per_step_grads:
            raise ValueError("per_step_grads reads the whole gradient every "
                             "step: not on a sharded carry (its gradient is "
                             "gathered once an update, in grads)")
        sh = self._shards(mesh)
        local = sh.local(carry)
        new, out = self._step(local, sh.rows(x_t), sh.rows(y_t), sh.cl(),
                              batch=self.cfg.batch)
        return sh.wrap(new), out

    def _step(self, carry, x_t, y_t, cl, batch: int | None = None):
        from repro_torch.core import scaled_rtrl as SC
        cfg, params = self.cfg, carry["params"]
        w = params["layers"] if self.stacked else cells.rec_param_tree(params)
        state, overflow = SC.compact_step(
            cfg, w, carry["state"], x_t, cl=cl,
            backend="compact_fused" if self.fused else "compact")
        # the readout and the gradient read the top layer
        a, vals, idx = ((state[k][-1] for k in ("a", "vals", "idx"))
                        if self.stacked else
                        (state["a"], state["vals"], state["idx"]))
        with span("engine.readout"):
            lt, logits, gout_t, cbar = self._inst_loss_and_grads(
                params["out"], a, y_t, carry["t_total"], batch)
        new = dict(carry)
        new["state"] = state
        with span("engine.grads"):
            gw_t = CK.compact_grads(vals, idx, cbar)
            new["gw"] = carry["gw"] + gw_t
            new["gout"] = tree_map(torch.add, carry["gout"], gout_t)
            new["loss"] = carry["loss"] + lt
        if "rw" in carry:
            new["last"] = {"x": x_t.float(), "y": y_t.int()}
        stats = {"overflow": overflow if self.stacked else overflow.max()}
        step_grads = None
        if self.spec.per_step_grads:
            step_grads = self._finish_gw(gw_t)
            step_grads["out"] = gout_t
        return new, StepOut(lt, logits, stats, step_grads)

    def _carry_width(self) -> int:
        """The carry's column axis: Pc_pad, or the full P_pad."""
        if self._cl is not None:
            return self._cl.Pc_pad
        return (self.cfg.slayout().P_pad if self.stacked
                else self.cfg.layout().P_pad)

    def _finish_gw(self, gw):
        cfg = self.cfg
        if self._cl is not None:
            gw = SP.cols_to_flat(self._cl, gw)
        if self.stacked:
            return ST.unflatten_stacked_grads(cfg.stacked_cfg(),
                                              cfg.slayout(), gw)
        return SP.unflatten_flat_grads(cfg.cell_cfg(), cfg.layout(), gw)

    def grads(self, carry):
        self._sync(carry)
        mesh = _carry_mesh(carry)
        if mesh is None:
            grads = self._finish_gw(carry["gw"])
            grads["out"] = carry["gout"]
            return grads
        return self.read_window(carry, {})[1]

    def read_window(self, carry, stats, grads=True):
        """On a sharded carry the update's two collectives: the
        accumulators, the loss, the stats and the live-row counts summed
        over the batch axes in one all_reduce (each rank's stats and counts
        in its own slot of a zero buffer, so the sum holds every rank's),
        then the gradient's columns gathered over 'model'.  The stats come
        back whole: overflow the max over the ranks' rows, every other
        stat the mean of the ranks' means; ``stats["kb"]`` the live rows of
        every example ([L * B], layer-major, in batch order) for the
        metric pack, whose carry holds only this rank's rows."""
        self._sync(carry)
        mesh = _carry_mesh(carry)
        if mesh is None:
            return super().read_window(carry, stats, grads)
        sh = self._shards(mesh)
        local = sh.local(carry)
        idx = local["state"]["idx"]
        idx = idx if isinstance(idx, tuple) else (idx,)
        kb = torch.stack([(i >= 0).sum(dim=-1) for i in idx]).float()
        acc = (local["gw"], local["gout"]) if grads else ()
        acc, loss, slots = sh.reduce_batch(
            (acc, local["loss"], tree_map(sh.slot, (dict(stats), kb))))
        every, kb = slots
        stats = {k: v.amax(dim=0) if k == "overflow" else v.mean(dim=0)
                 for k, v in every.items()}
        stats["kb"] = kb.movedim(0, 1).reshape(-1)
        if not grads:
            return loss, None, stats
        gw, gout = acc
        out = self._finish_gw(SH.all_gather(gw, mesh, "model"))
        out["out"] = gout
        return loss, out, stats

    def reset_grads(self, carry, params=None):
        mesh = _carry_mesh(carry)
        if mesh is None:
            return super().reset_grads(carry, params)
        sh = self._shards(mesh)
        return sh.wrap(super().reset_grads(sh.local(carry), params))

    # -- the sharded carry ----------------------------------------------------

    def _shards(self, mesh) -> "_Shards":
        """This rank's share of a carry on `mesh`, kept until the next
        `_bind` (a rewire changes the layout it cuts)."""
        sh = self._shard_views.get(mesh)
        if sh is None:
            sh = self._shard_views[mesh] = _Shards(self, mesh)
        return sh

    def place(self, carry, mesh):
        """The carry placed on `mesh` (this rank's share, no collective):
        the influence state by `scaled_rtrl.sharded_step_specs`, the last
        inputs over the batch axes, the gradient accumulator's columns over
        'model' and every accumulator (loss, gw, gout) a partial sum over
        the batch axes (the rank at batch coordinate 0 keeps the values
        the carry holds).  The parameters, masks and layout stay whole on
        every rank.  The compact column axis must split into whole 8-column
        groups (K1's rows are 16-byte aligned): Pc_pad / model a multiple
        of 8, or this raises; no column is dropped."""
        sh = self._shards(mesh)
        return sh.wrap(sh.local(carry))

    def shardings(self, carry, mesh):
        """Target shardings of every tensor leaf of a carry on `mesh` (a
        restore's `shardings`, the re-mesh of a checkpoint): the state by
        `sharded_step_specs`, the last inputs over the batch axes, the
        gradient accumulator's columns over 'model', the rest replicated.
        The accumulators are whole on disk: a restore places them whole,
        and the sharded step counts each once (see `place`)."""
        from repro_torch.core import scaled_rtrl as SC
        from repro_torch.models.module import NamedSharding
        from repro_torch.sharding import batch_axes
        rep = NamedSharding(mesh, ())
        out = tree_map(lambda _: rep, {k: v for k, v in carry.items()
                                       if k not in ("state", "gw", "last")})
        out["state"] = SC.sharded_step_specs(self.cfg, mesh)[0]
        out["gw"] = NamedSharding(mesh, ("model",))
        if "last" in carry:
            rows = NamedSharding(mesh, (batch_axes(mesh),))
            out["last"] = {k: rows for k in carry["last"]}
        return out

    def gather(self, carry):
        """A sharded carry's whole value on every rank, as plain tensors
        (the influence state gathered, the partial sums summed): the
        comparison with a one-rank run.  Collectives: one all_gather per
        state leaf and mesh axis it is split over, one all_reduce per
        accumulator."""
        mesh = _carry_mesh(carry)
        if mesh is None:
            return carry
        return self._shards(mesh).gather(carry)

    # -- dynamic sparsity ---------------------------------------------------

    def _rigl_scores(self, carry):
        cfg, last, a = self.cfg, carry["last"], carry["state"]["a"]
        if self.stacked:
            scfg = cfg.stacked_cfg()

            def loss_of(params):
                a_new = cells.stacked_step_straight_through(
                    scfg, params["layers"], a, last["x"])
                return cells.xent(cells.readout(params, a_new[-1]),
                                  last["y"])

            return self._dense_scores(loss_of, carry["params"])["layers"]
        ccfg = cfg.cell_cfg()

        def loss_of(params):
            a_new = cells.step_straight_through(
                ccfg, cells.rec_param_tree(params), a, last["x"])
            return cells.xent(cells.readout(params, a_new), last["y"])

        return cells.rec_param_tree(self._dense_scores(loss_of,
                                                       carry["params"]))

    @torch.no_grad()
    def rewire(self, carry, event_key, *, frac: float = 0.1,
               method: str = "rigl", block: int = 1, scores=None):
        """Prune-and-regrow event on the dual-compact carry, single layer
        or stacked (one migration plan for every layer's buffer): see
        SparseLearner.rewire for the exactness contract."""
        from repro_torch import sparsity as DS
        self._check_rewirable(carry)
        self._sync(carry)
        cfg = self.cfg
        mesh = _carry_mesh(carry)
        sh = None if mesh is None else self._shards(mesh)
        carry = dict(carry)
        rw = dict(carry["rw"])
        grads = None
        if method == "rigl":
            if sh is None:
                grads = self._rigl_scores(carry)
            else:       # this rank's rows' share of the batch mean, summed
                grads = sh.reduce_batch(self._rigl_scores(sh.local(carry)),
                                        mean=True)
        params = dict(carry["params"])
        if self.stacked:
            old_masks = list(rw["masks"])
            new_masks = DS.rewire_stacked_masks(
                old_masks, params["layers"], grads, frac=frac, key=event_key,
                method=method, block=block, scores=scores)
            params["layers"] = [
                SP.apply_masks(SP.apply_masks(p, om), nm)
                for p, om, nm in zip(params["layers"], old_masks, new_masks)]
            rw["masks"] = tuple(new_masks)
        else:
            old_masks = rw["masks"]
            new_masks = DS.rewire_masks(
                old_masks, cells.rec_param_tree(params), grads, frac=frac,
                key=event_key, method=method, block=block, scores=scores)
            params = SP.apply_masks(SP.apply_masks(params, old_masks),
                                    new_masks)
            rw["masks"] = new_masks
        carry["params"] = params
        new_cl = cfg.col_layout(new_masks, device=self._cl.src.device)
        plan = DS.migration_plan(self._cl, new_cl)
        if sh is not None:
            carry = sh.migrate(carry, plan)
            rw["cl"] = _cl_arrays(new_cl)
            carry["rw"] = rw
            self._bind(rw)
            return carry
        state = dict(carry["state"])
        if self.stacked:
            state["vals"] = tuple(
                DS.migrate_influence(self._cl, new_cl, v, plan)
                for v in state["vals"])
        else:
            state["vals"] = DS.migrate_influence(self._cl, new_cl,
                                                 state["vals"], plan)
        carry["state"] = state
        carry["gw"] = DS.migrate_influence(self._cl, new_cl, carry["gw"],
                                           plan)
        rw["cl"] = _cl_arrays(new_cl)
        carry["rw"] = rw
        self._bind(rw)
        return carry

    def opt_mask_of(self, carry):
        masks = carry["rw"]["masks"]
        if self.stacked:
            return {"layers": list(masks), "out": None}
        masks = dict(masks)
        masks.setdefault("out", None)
        return masks


def _carry_mesh(carry: Tree):
    """The DeviceMesh of a sharded scaled carry (its vals a DTensor), or
    None."""
    from repro_torch.sharding import is_dtensor
    v = carry["state"]["vals"]
    v = v[0] if isinstance(v, tuple) else v
    return v.device_mesh if is_dtensor(v) else None


class _Shards:
    """This rank's share of a `ScaledLearner` carry on a mesh: its rows of
    the batch (the mesh's batch axes, 'pod' major) and its columns of the
    compact axis ('model'), and the DTensor placements the sharded carry
    keeps (see `ScaledLearner.place`)."""

    def __init__(self, learner: "ScaledLearner", mesh):
        import math
        from torch.distributed.tensor import Partial, Replicate, Shard
        from repro_torch.core import scaled_rtrl as SC
        cfg = learner.cfg
        self.learner, self.mesh = learner, mesh
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.shape))
        if "model" not in sizes:
            raise ValueError(f"a scaled carry shards its columns over a "
                             f"'model' mesh dim; the mesh has {names}")
        self.batch_dims = tuple(a for a in ("pod", "data") if a in sizes)
        self.coord = dict(zip(names, mesh.get_coordinate()))
        self.n_batch = math.prod(sizes[a] for a in self.batch_dims)
        if cfg.batch % self.n_batch:
            raise ValueError(f"batch {cfg.batch} does not split over "
                             f"{self.n_batch} batch shards")
        bi = 0
        for a in self.batch_dims:
            bi = bi * sizes[a] + self.coord[a]
        self.bi = bi
        self.B = cfg.batch // self.n_batch
        self.r0 = bi * self.B
        # the rank that keeps a whole (replicated) accumulator's value
        self.lead = all(self.coord[a] == 0 for a in self.batch_dims)
        width = learner._carry_width()
        n_model = sizes["model"]
        if width % (8 * n_model):
            raise ValueError(
                f"the compact column axis ({width} columns) does not split "
                f"into {n_model} shards of whole 8-column groups (K1 reads "
                f"16-byte rows): use a 'model' size dividing {width // 8}")
        self.w = width // n_model
        self.c0 = self.coord["model"] * self.w
        self.state_sh = SC.sharded_step_specs(cfg, mesh)[0]
        self.pl_rows = tuple(Shard(0) if a in self.batch_dims else Replicate()
                             for a in names)
        self.pl_gw = tuple(Partial() if a in self.batch_dims else
                           Shard(0) if a == "model" else Replicate()
                           for a in names)
        self.pl_acc = tuple(Partial() if a in self.batch_dims else Replicate()
                            for a in names)
        self._local_cl = None

    # -- local views --------------------------------------------------------

    def rows(self, t):
        """This rank's batch rows of a whole [B, ...] input (a DTensor
        placed over the batch axes is its local shard already)."""
        from repro_torch.sharding import is_dtensor
        if is_dtensor(t):
            return t.to_local()
        return t[self.r0:self.r0 + self.B]

    def _cut(self, x, sharding):
        from repro_torch.sharding import is_dtensor, local_index
        idx = local_index(x.shape, sharding.placements,
                          self.mesh.get_coordinate(), self.mesh.shape)
        if not is_dtensor(x):
            return x[idx].contiguous()
        if tuple(x.placements) != tuple(sharding.placements):
            raise ValueError(
                f"a scaled carry's state is placed by sharded_step_specs "
                f"({sharding.placements}); got {tuple(x.placements)}")
        return x.to_local()

    def _partial(self, x, cols: bool = False):
        """An accumulator's local partial sum: a Partial DTensor's local
        value; a whole value (plain, or replicated over the batch axes, as
        a restore places it) kept by the lead rank and zero elsewhere."""
        from torch.distributed.tensor import Partial
        from repro_torch.sharding import is_dtensor
        if is_dtensor(x):
            whole = not all(isinstance(p, Partial) for p, a in
                            zip(x.placements, self.mesh.mesh_dim_names)
                            if a in self.batch_dims)
            x = x.to_local()
        else:
            whole = True
        if cols and x.shape[-1] != self.w:
            x = x[..., self.c0:self.c0 + self.w]
        if whole and not self.lead:
            return torch.zeros_like(x)
        return x.clone() if whole else x

    def local(self, carry: Tree) -> Tree:
        """The carry as this rank's plain local tensors."""
        out = dict(carry)
        out["state"] = tree_map(self._cut, carry["state"], self.state_sh)
        out["gw"] = self._partial(carry["gw"], cols=True)
        out["gout"] = tree_map(self._partial, carry["gout"])
        out["loss"] = self._partial(carry["loss"])
        if "last" in carry:
            out["last"] = {k: self.rows(v) for k, v in carry["last"].items()}
        return out

    def wrap(self, local: Tree) -> Tree:
        """`local`'s tensors as the sharded carry's DTensors."""
        from torch.distributed.tensor import DTensor

        def dt(x, pl):
            return DTensor.from_local(x, self.mesh, pl, run_check=False)
        out = dict(local)
        out["state"] = tree_map(lambda x, s: dt(x, s.placements),
                                local["state"], self.state_sh)
        out["gw"] = dt(local["gw"], self.pl_gw)
        out["gout"] = tree_map(lambda x: dt(x, self.pl_acc), local["gout"])
        out["loss"] = dt(local["loss"], self.pl_acc)
        if "last" in local:
            out["last"] = {k: dt(v, self.pl_rows)
                           for k, v in local["last"].items()}
        return out

    def cl(self):
        """The ColLayout cut to this rank's columns (an all-live layout
        stands in for a full-width carry), built once (the learner drops
        this view at a rewire); under compact_fused its gate-segment table
        is built from the local columns, which may start inside a gate's
        run or hold none of a gate's columns."""
        lr = self.learner
        cl = self._local_cl
        if cl is None:
            full = lr._cl if lr._cl is not None else lr.cfg.col_layout(
                None, device=lr._device)
            sl = slice(self.c0, self.c0 + self.w)
            cl = dataclasses.replace(
                full, Pc=int(full.live[sl].sum()), Pc_pad=self.w,
                **{f: getattr(full, f)[sl] for f in _CL_FIELDS})
            if lr.fused:
                from repro_torch.kernels import compact_fused as CF
                cfg = lr.cfg
                lays = (cfg.slayout().layers if lr.stacked
                        else (cfg.layout(),))
                for l, lay in enumerate(lays):
                    CF.fused_segments(lay, cl, layer=l)
            self._local_cl = cl
        return cl

    def slot(self, x):
        """`x` in this rank's slot (its batch index) of a zero [n_batch,
        ...] buffer: summed over the batch axes, the buffer holds every
        batch shard's `x`."""
        out = x.new_zeros((self.n_batch,) + tuple(x.shape))
        out[self.bi] = x
        return out

    # -- collectives --------------------------------------------------------

    def reduce_batch(self, tree: Tree, mean: bool = False) -> Tree:
        """Every leaf of `tree` summed (or averaged) over the batch axes in
        ONE all_reduce of their concatenation (none with one batch
        shard)."""
        leaves = tree_leaves(tree)
        flat = torch.cat([x.float().reshape(-1) for x in leaves])
        if self.n_batch > 1:
            flat = SH.all_reduce(flat, self.mesh, self.batch_dims)
            if mean:
                flat = flat / self.n_batch
        parts = iter(flat.split([x.numel() for x in leaves]))
        return tree_map(lambda x: next(parts).reshape(x.shape).to(x.dtype),
                        tree)

    def gather(self, carry: Tree) -> Tree:
        local = self.local(carry)
        names = self.mesh.mesh_dim_names

        def whole(x, placements):
            from torch.distributed.tensor import Shard
            # minor mesh dims first: rebuilds a dim split major to minor
            for a, p in reversed(list(zip(names, placements))):
                if isinstance(p, Shard):
                    x = SH.all_gather(x, self.mesh, a, axis=p.dim)
            return x
        out = dict(local)
        out["state"] = tree_map(lambda x, s: whole(x, s.placements),
                                local["state"], self.state_sh)
        gw, gout, loss = self.reduce_batch(
            (local["gw"], local["gout"], local["loss"]))
        out["gw"] = SH.all_gather(gw, self.mesh, "model")
        out["gout"], out["loss"] = gout, loss
        if "last" in local:
            out["last"] = {k: whole(v, self.pl_rows)
                           for k, v in local["last"].items()}
        return out

    def migrate(self, carry: Tree, plan) -> Tree:
        """A rewire's migration of the sharded carry: every column buffer
        (each layer's vals, the gradient accumulator) gathered over
        'model' in one all_gather, each rank then keeping its new columns
        (`sparsity.migrate.migrate_sharded`)."""
        from repro_torch import sparsity as DS
        local = self.local(carry)
        state = dict(local["state"])
        vals = list(state["vals"]) if self.learner.stacked \
            else [state["vals"]]
        new = DS.migrate_sharded(plan, vals + [local["gw"]], self.mesh,
                                 self.c0)
        state["vals"] = tuple(new[:-1]) if self.learner.stacked else new[0]
        local["state"], local["gw"] = state, new[-1]
        return self.wrap(local)


# ---------------------------------------------------------------------------
# Diagonal-recurrence eligibility traces (exact) and e-prop (approximate)
# ---------------------------------------------------------------------------

def _trace_contract(cbar: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """sum_b cbar[b, k] e[b, ..., k], as a product and one sum over the
    leading batch axis (`kernels.compact.row_contract`'s form: no library
    product, whose kernel cuBLAS picks by the batch count)."""
    shape = (cbar.shape[0],) + (1,) * (e.ndim - 2) + (cbar.shape[-1],)
    return (cbar.reshape(shape) * e).sum(dim=0)


class _TraceLearner(_LearnerBase):
    """What the trace engines share: the carry ({"h": cell state, "tr":
    traces, gw/gout accumulators}), masking of the per-step increments,
    the closed-form instantaneous loss and the gradient finish."""

    def __init__(self, spec: LearnerSpec):
        self.spec = spec
        self.cfg = spec.cfg
        self.cell = resolve_cell(spec.cfg)

    def init(self, params, masks, batch, t_total: float = 1.0):
        x0, _ = batch
        B = x0.shape[0]
        device = params["out"]["W"].device
        self._freeze_static(masks=masks)
        self.masks = masks
        carry = self._base_carry(params, t_total, device)
        carry["h"] = self.cell.init_state(B, device=device)
        carry["tr"] = self.cell.init_traces(B, device=device)
        carry["gw"] = tree_map(torch.zeros_like, self.cell.rec_params(params))
        carry["gout"] = tree_map(torch.zeros_like, params["out"])
        return carry

    def _masked(self, inc: Tree) -> Tree:
        """Dead parameters' increments zeroed, so their traces and
        gradients stay exactly 0."""
        if self.masks is None:
            return inc
        return tree_map(lambda m, mk: m * mk, inc,
                        {k: self.masks[k] for k in inc})

    def _finish(self, carry, y_t, h_new, tr_new, e, readout_state, stats):
        """Loss and readout gradients at readout_state, the step's
        gradient term c-bar . e, and the accumulated carry."""
        params = carry["params"]
        lt, logits, gout_t, cbar = self._inst_loss_and_grads(
            params["out"], readout_state, y_t.clamp(min=0), carry["t_total"])
        gw_t = tree_map(lambda el: _trace_contract(cbar, el), e)
        new = dict(carry)
        new["h"], new["tr"] = h_new, tr_new
        new["gw"] = tree_map(torch.add, carry["gw"], gw_t)
        new["gout"] = tree_map(torch.add, carry["gout"], gout_t)
        new["loss"] = carry["loss"] + lt
        step_grads = None
        if self.spec.per_step_grads:
            step_grads = dict(gw_t)
            step_grads["out"] = gout_t
        return new, StepOut(lt, logits, stats, step_grads)

    def grads(self, carry):
        grads = dict(carry["gw"])
        grads["out"] = carry["gout"]
        return grads


class DiagExactLearner(_TraceLearner):
    """Exact eligibility-trace RTRL for any jac_kind "diagonal" zoo cell
    (RG-LRU, the diag_rtrl toy cell): J_t = diag(a_t) factors the
    influence matrix into independent per-parameter traces

        e_t[w] = a_t * e_{t-1}[w] + mbar_t[w]

    at O(n p) a step and O(p) trace memory.  `engine="diag"` is the same
    engine.  With masks the dead parameters' increments are zeroed every
    step, so their traces and gradients stay exactly 0."""

    def __init__(self, spec: LearnerSpec):
        super().__init__(spec)
        if self.cell.jac_kind != "diagonal":
            raise ValueError(
                f"engine='diag_exact' needs a diagonal-Jacobian cell; "
                f"{self.cell.name!r} has jac_kind={self.cell.jac_kind!r}")

    def step(self, carry, x_t, y_t):
        w = self.cell.rec_params(carry["params"])
        h_new, _, adiag, mbar = self.cell.partials(w, carry["h"], x_t)
        mbar = self._masked(mbar)

        def decay(leaf):            # a_t [B, n] over a leaf [B, ..., n]
            return adiag.reshape((adiag.shape[0],) + (1,) * (leaf.ndim - 2)
                                 + (adiag.shape[-1],))

        tr_new = tree_map(lambda t, m: decay(t) * t + m, carry["tr"], mbar)
        return self._finish(carry, y_t, h_new, tr_new, tr_new, h_new, {})


# the historical name
DiagLearner = DiagExactLearner


class EpropLearner(_TraceLearner):
    """Bellec-style e-prop for cells exposing `eprop_step` (the SNN of
    `cells.snn`): rank-1 membrane traces plus full adaptation traces, the
    learning signal broadcast exactly from the readout.  An approximation:
    the explicit spike recurrence through R is dropped."""

    def __init__(self, spec: LearnerSpec):
        super().__init__(spec)
        if not hasattr(self.cell, "eprop_step"):
            raise ValueError(
                f"engine='eprop' needs a cell exposing eprop_step; "
                f"{self.cell.name!r} does not")

    def step(self, carry, x_t, y_t):
        w = self.cell.rec_params(carry["params"])
        state_new, tr_new, e = self.cell.eprop_step(w, carry["h"],
                                                    carry["tr"], x_t)
        z_new = state_new["z"]
        stats = {"alpha": (z_new != 0.0).float().mean()}
        return self._finish(carry, y_t, state_new, tr_new, self._masked(e),
                            z_new, stats)


# ---------------------------------------------------------------------------
# SnAp-1 / SnAp-2 approximations
# ---------------------------------------------------------------------------

class SnapLearner(_LearnerBase):
    """`core.snap` as a streaming learner: the dense per-gate influence
    pruned to the SnAp-n pattern every step (an approximation: the Table-1
    baseline the exact engines are measured against)."""

    def __init__(self, spec: LearnerSpec):
        self.spec = spec
        self.cfg: EGRUConfig = spec.cfg
        self.cell = resolve_cell(spec.cfg)
        self.order = spec.order

    def init(self, params, masks, batch, t_total: float = 1.0):
        from repro_torch.core import snap as SN
        cfg = self.cfg
        x0, _ = batch
        B = x0.shape[0]
        device = params["out"]["W"].device
        self._freeze_static(masks=masks)
        self.masks = masks
        self.keep = (torch.eye(cfg.n_hidden, device=device)
                     if self.order == 1
                     else SN.snap2_pattern(cfg, masks, device=device))
        carry = self._base_carry(params, t_total, device)
        carry["a"] = cells.init_state(cfg, B, device=device)
        carry["M"] = SP.init_influence(cfg, B, device=device)
        carry["gw"] = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                               cells.rec_param_tree(params))
        carry["gout"] = tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), params["out"])
        return carry

    def _prune(self, M):
        keep = self.keep
        return {g: Mg * (keep[None, :, :, None] if Mg.ndim == 4
                         else keep[None]) for g, Mg in M.items()}

    def step(self, carry, x_t, y_t):
        cfg, params = self.cfg, carry["params"]
        w = cells.rec_param_tree(params)
        a_new, hp, Jhat, mbar = self.cell.partials(w, carry["a"], x_t)
        M_new = self._prune(SP.influence_update(cfg, carry["M"], hp, Jhat,
                                                mbar, self.masks))
        lt, logits, gout_t, cbar = self._inst_loss_and_grads(
            params["out"], a_new, y_t, carry["t_total"])
        gw_t = SP.influence_grads(cfg, M_new, cbar)
        new = dict(carry)
        new["a"], new["M"] = a_new, M_new
        new["gw"] = tree_map(torch.add, carry["gw"], gw_t)
        new["gout"] = tree_map(torch.add, carry["gout"], gout_t)
        new["loss"] = carry["loss"] + lt
        stats = {"beta": (hp == 0.0).float().mean()}
        step_grads = None
        if self.spec.per_step_grads:
            step_grads = dict(gw_t)
            step_grads["out"] = gout_t
        return new, StepOut(lt, logits, stats, step_grads)

    def grads(self, carry):
        grads = dict(carry["gw"])
        grads["out"] = carry["gout"]
        return grads


# ---------------------------------------------------------------------------
# BPTT sequence-adapter oracle
# ---------------------------------------------------------------------------

class BPTTLearner(_LearnerBase):
    """BPTT behind the streaming protocol: the oracle that shows what RTRL
    buys.  Buffers the last `horizon` inputs ([H, B, n_in] + labels) in the
    carry; `grads` re-runs the window forward from its first activity and
    differentiates it by autograd (memory O(H), NOT O(1)).

    `reset_grads` restarts the window at the current activity (truncated
    BPTT): with an update every k <= horizon steps this is TBPTT-k.  Steps
    beyond the horizon overwrite the last slot and set the 'bptt_overflow'
    stat: size the horizon to the update window."""

    def __init__(self, spec: LearnerSpec):
        self.spec = spec
        self.cfg: EGRUConfig = spec.cfg

    def init(self, params, masks, batch, t_total: float = 1.0):
        cfg = self.cfg
        x0, y0 = batch
        B = x0.shape[0]
        device = params["out"]["W"].device
        H = self.spec.horizon
        if H is None:
            H = max(1, int(round(float(t_total))))
        self._freeze_static(horizon=H)
        self.horizon = H
        carry = self._base_carry(params, t_total, device)
        carry["a"] = cells.init_state(cfg, B, device=device)
        carry["a0"] = cells.init_state(cfg, B, device=device)
        carry["xbuf"] = torch.zeros((H,) + tuple(x0.shape),
                                    dtype=torch.float32, device=device)
        carry["ybuf"] = torch.zeros((H,) + tuple(y0.shape),
                                    dtype=torch.int32, device=device)
        carry["pos"] = torch.zeros((), dtype=torch.int32, device=device)
        return carry

    def step(self, carry, x_t, y_t):
        cfg, params = self.cfg, carry["params"]
        a_new = cells.step_straight_through(
            cfg, cells.rec_param_tree(params), carry["a"], x_t)
        logits = cells.readout(params, a_new)
        lt = cells.xent(logits, y_t) / carry["t_total"]
        slot = carry["pos"].clamp(max=self.horizon - 1).long()
        new = dict(carry)
        new["a"] = a_new
        new["xbuf"] = carry["xbuf"].index_copy(
            0, slot[None], x_t.float()[None])
        new["ybuf"] = carry["ybuf"].index_copy(
            0, slot[None], y_t.int()[None])
        new["pos"] = carry["pos"] + 1
        new["loss"] = carry["loss"] + lt
        stats = {"alpha": (a_new == 0.0).float().mean(),
                 "bptt_overflow": (carry["pos"] >= self.horizon).int()}
        return new, StepOut(lt, logits, stats, None)

    def grads(self, carry):
        from repro_torch.core.bptt import _loss_and_grads
        cfg, H = self.cfg, self.horizon
        xbuf, ybuf, tt = carry["xbuf"], carry["ybuf"], carry["t_total"]
        wmask = (torch.arange(H, device=xbuf.device) < carry["pos"]).float()

        def loss_fn(params):
            w = cells.rec_param_tree(params)
            a, losses = carry["a0"], []
            for t in range(H):
                a = cells.step_straight_through(cfg, w, a, xbuf[t])
                losses.append(cells.xent(cells.readout(params, a), ybuf[t]))
            return (torch.stack(losses) * wmask).sum() / tt, {}

        return _loss_and_grads(loss_fn, carry["params"])[1]

    def reset_grads(self, carry, params=None):
        carry = super().reset_grads(carry, params)
        carry["a0"] = carry["a"]
        carry["pos"] = torch.zeros_like(carry["pos"])
        return carry


_NOT_PORTED_ENGINES: dict = {}

ENGINES = {
    "sparse": SparseLearner,
    "stacked": StackedLearner,
    "scaled": ScaledLearner,
    "diag": DiagExactLearner,        # the historical name, same engine
    "diag_exact": DiagExactLearner,
    "eprop": EpropLearner,
    "snap": SnapLearner,
    "bptt": BPTTLearner,
}


def make_learner(spec: LearnerSpec):
    """Construct the learner named by `spec.engine`."""
    if spec.engine in _NOT_PORTED_ENGINES:
        raise NotImplementedError(
            f"engine {spec.engine!r} is not ported yet: "
            f"{_NOT_PORTED_ENGINES[spec.engine]}")
    if spec.engine not in ENGINES:
        raise ValueError(
            f"engine must be one of "
            f"{tuple(ENGINES) + tuple(_NOT_PORTED_ENGINES)}, "
            f"got {spec.engine!r}")
    if spec.cfg is None:
        raise ValueError("LearnerSpec.cfg is required")
    return ENGINES[spec.engine](spec)


def scan_learner(learner, params: Tree, masks: Tree | None,
                 xs: torch.Tensor, labels: torch.Tensor):
    """Whole-sequence driver: step the learner over xs [T, B, ...] with a
    fixed label, normalizing the per-step loss by T.  Returns (loss, grads,
    stats) with every stat stacked over T."""
    T = xs.shape[0]
    carry = learner.init(params, masks, (xs[0], labels), t_total=T)
    per_step = []
    for t in range(T):
        carry, out = learner.step(carry, xs[t], labels)
        per_step.append(out.stats)
    stats = {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
    return carry["loss"], learner.grads(carry), stats
