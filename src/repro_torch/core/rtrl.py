"""Generic exact RTRL engine (the oracle), in PyTorch.

Counterpart of `repro.core.rtrl`.  Implements Eqs. (2)-(4) of the paper for
any cell a_t = step(w, a_{t-1}, x_t), computing the per-step Jacobian J_t
and the immediate influence M-bar_t by autodiff: `torch.func.vmap` of
`torch.func.jacrev` through the same straight-through surrogate that BPTT
differentiates.  This is O(n^2 p) a step, the intractable baseline the
paper starts from, and the reference the structured engines
(`core.sparse_rtrl`, `core.stacked_rtrl`) are held against.

The recurrent parameters are raveled into one flat vector in the JAX
package's `ravel_pytree` order (dict keys sorted, lists in order), so the
columns of M here are the JAX oracle's columns.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value, jacrev, vmap

from repro_torch.core import cells
from repro_torch.core.cells import EGRUConfig
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path


def _ravel(tree):
    """(flat [p] float32 vector, unravel): the leaves in sorted-key order,
    each raveled; unravel(flat) rebuilds a tree of the structure of `tree`
    from slices of `flat`."""
    items = tree_flatten_with_path(tree)
    sizes = [leaf.numel() for _, leaf in items]
    flat = torch.cat([leaf.reshape(-1).float() for _, leaf in items])

    def unravel(vec):
        parts = dict(zip((path for path, _ in items), torch.split(vec, sizes)))
        return tree_map_with_path(
            lambda path, leaf: parts[path].reshape(leaf.shape), tree)

    return flat, unravel


def _inst_loss(T: int, labels):
    def loss(po, a):
        return cells.xent(cells.readout({"out": po}, a), labels) / T
    return loss


def _oracle_step(step_flat, w_flat, s, x_t, M):
    """(s_new, M_new): J by a vmapped jacrev over the state, M-bar by a
    jacrev over the flat parameters, M_new = J M + M-bar."""
    J = vmap(jacrev(lambda si, xi: step_flat(w_flat, si[None], xi[None])[0]))(
        s, x_t)                                                 # [B, N, N]
    Mbar = jacrev(lambda wf: step_flat(wf, s, x_t))(w_flat)      # [B, N, p]
    s_new = step_flat(w_flat, s, x_t)
    return s_new, torch.einsum("bkl,blp->bkp", J, M) + Mbar


def rtrl_loss_and_grads(cfg: EGRUConfig, params: dict, xs: torch.Tensor,
                        labels: torch.Tensor):
    """Exact RTRL forward pass: returns (loss, grads, stats).

    xs: [T, B, n_in]; labels: [B].  Memory is O(B n p), independent of T."""
    T, B, _ = xs.shape
    w_flat, unravel = _ravel(cells.rec_param_tree(params))
    p = w_flat.shape[0]

    def step_flat(wf, a, x):
        return cells.step_straight_through(cfg, unravel(wf), a, x)

    inst = _inst_loss(T, labels)
    a = cells.init_state(cfg, B, device=xs.device)
    M = torch.zeros((B, cfg.n_hidden, p), device=xs.device)
    gw = torch.zeros((p,), device=xs.device)
    gout = {k: torch.zeros_like(v) for k, v in params["out"].items()}
    loss = torch.zeros((), device=xs.device)
    alpha, density = [], []
    for x_t in xs:
        a, M = _oracle_step(step_flat, w_flat, a, x_t, M)
        (g_out, cbar), lt = grad_and_value(inst, argnums=(0, 1))(
            params["out"], a)
        gw = gw + torch.einsum("bk,bkp->p", cbar, M)
        gout = {k: gout[k] + g_out[k] for k in gout}
        loss = loss + lt
        alpha.append((a == 0.0).float().mean())
        density.append((M != 0.0).any(dim=2).float().mean())
    grads = dict(unravel(gw))
    grads["out"] = gout
    stats = {"alpha": torch.stack(alpha).mean(),
             "m_row_density": torch.stack(density).mean()}
    return loss, grads, stats


def stacked_rtrl_loss_and_grads(cfg, params: dict, xs: torch.Tensor,
                                labels: torch.Tensor):
    """Generic exact stacked-RTRL oracle (cfg: cells.StackedEGRUConfig).

    Treats the whole stack as ONE cell with state s_t = (a^0_t, ..,
    a^{L-1}_t) concatenated to [B, N_tot] and influence M [B, N_tot,
    p_tot] by jacrev, O(N_tot^2 p_tot) a step: the baseline the block
    engine (`core.stacked_rtrl`) must match.  The Jacobian it
    differentiates is block lower-triangular; this oracle does not use
    that."""
    T, B, _ = xs.shape
    sizes = cfg.layer_sizes
    N = sum(sizes)
    bounds = [sum(sizes[:l]) for l in range(cfg.n_layers + 1)]
    w_flat, unravel = _ravel({"layers": params["layers"]})
    p = w_flat.shape[0]

    def step_flat(wf, s, x):
        a_prevs = tuple(s[:, bounds[l]:bounds[l + 1]]
                        for l in range(cfg.n_layers))
        a_new = cells.stacked_step_straight_through(
            cfg, unravel(wf)["layers"], a_prevs, x)
        return torch.cat(a_new, dim=1)

    top = slice(N - sizes[-1], N)

    def inst(po, s):
        return cells.xent(cells.readout({"out": po}, s[:, top]), labels) / T

    s = torch.cat(cells.init_stacked_state(cfg, B, device=xs.device), dim=1)
    M = torch.zeros((B, N, p), device=xs.device)
    gw = torch.zeros((p,), device=xs.device)
    gout = {k: torch.zeros_like(v) for k, v in params["out"].items()}
    loss = torch.zeros((), device=xs.device)
    for x_t in xs:
        s, M = _oracle_step(step_flat, w_flat, s, x_t, M)
        (g_out, cbar), lt = grad_and_value(inst, argnums=(0, 1))(
            params["out"], s)
        gw = gw + torch.einsum("bk,bkp->p", cbar, M)
        gout = {k: gout[k] + g_out[k] for k in gout}
        loss = loss + lt
    grads = unravel(gw)
    grads["out"] = gout
    return loss, grads, {}


def rtrl_online_train(cfg: EGRUConfig, params: dict, xs: torch.Tensor,
                      labels: torch.Tensor, opt, opt_state, step0: int):
    """Truly online RTRL: a parameter update EVERY timestep.  Memory O(B n
    p), no stored history.  Returns (params, opt_state, step, mean loss).

    The O(n^2 p) jacrev demonstration; the production online path is the
    streaming learner API (`core.learner` + `runtime.online.OnlineTrainer`),
    which makes the same mid-stream updates on the sparse engines."""
    T, B, _ = xs.shape
    w_flat, _ = _ravel(cells.rec_param_tree(params))
    a = cells.init_state(cfg, B, device=xs.device)
    M = torch.zeros((B, cfg.n_hidden, w_flat.shape[0]), device=xs.device)
    inst = _inst_loss(T, labels)
    step, losses = step0, []
    for x_t in xs:
        w_flat, unravel = _ravel(cells.rec_param_tree(params))

        def step_flat(wf, ai, xi):
            return cells.step_straight_through(cfg, unravel(wf), ai, xi)

        a, M = _oracle_step(step_flat, w_flat, a, x_t, M)
        (gout, cbar), lt = grad_and_value(inst, argnums=(0, 1))(
            params["out"], a)
        grads = dict(unravel(torch.einsum("bk,bkp->p", cbar, M)))
        grads["out"] = gout
        params, opt_state = opt.update(grads, opt_state, params, step)
        step += 1
        losses.append(lt)
    return params, opt_state, step, torch.stack(losses).mean()
