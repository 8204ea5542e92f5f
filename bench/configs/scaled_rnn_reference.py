"""Plain PyTorch reference of the scaled thresholded RNN trained online by
exact RTRL with masked adamw: the benchmark's yardstick for the
`scaled_online` system.

It imports nothing of the program and reads nothing the program made.
From the parameters, the fixed masks and the inputs the benchmark drew, it
works out again what the program derives: the live parameter columns, the
active rows, the influence and the update.

The network (the paper's Sec. 7 outlook, kind "rnn"), for unit k:

    v_t   = x_t W + a_{t-1} R + b - theta
    a_t   = H(v_t)                                    (H: v > 0)
    h'_t  = gamma * max(0, 1 - |v_t| / (2 eps))       (pseudo-derivative)
    L_t   = xent(a_t W_out + b_out, y_t) / k          (mean over the batch)

The influence M_t[b, k, c] = d a_t[b, k] / d w_c over the live recurrent
parameters c (W and R where their masks are 1, every b and theta),
grouped by unit q and, inside a unit, in the order (W column, R column, b,
theta):

    M_t = h'_t * (J M_{t-1} + M-bar_t),   J[k, l] = R[l, k],
    M-bar_t[b, k, c] = [q(c) == k] * (x_t, a_{t-1}, 1, -1)[b, j(c)]

carried with every row of the batch (rows where h' = 0 are zero), so
there is no capacity and no overflow.  The gradient of a window of k steps
is sum_t c-bar_t^T M_t with c-bar_t = dL_t / da_t; the readout's in closed
form.  After each window masked adamw updates the parameters; the
influence and the activity carry over.

Work is done in blocks of columns, so that the carry [B, n, Pc] in f32 is
the largest buffer: 3.9 GB at n = 1,024.

`precision` "f32" runs every product in full float32 (TF32 off);
"tf32" rounds both operands of every product to TF32 (10 explicit mantissa
bits, round to nearest) and multiplies in float32, which is what the
card's TF32 tensor cores compute: the control.

`follow`: the activity [T, B, n] of the run under test.  The reference
then takes a_t from it (its own v_t and h'_t stay its own), so that a unit
whose v lies within rounding of the threshold cannot send the two runs
apart; `v` and `spikes` report its own pre-activations and spikes for the
judge to hold the followed activity against.  `follow_params`: the run's
parameters at the start of each window (leaves by name); window w then
runs from them, so that adamw, which turns a gradient entry within
rounding of zero into a step of about lr either way, cannot send the two
runs apart either.  The reference's own adamw steps (from its own moments
and gradients) still add up to the "params" it returns: p_0 plus its own
steps.

`fault` plants one of the faults the check must catch, for the reference
put in the program's place: "half_batch" (examples B/2.. left out, the
loss and gradients the mean over the rest), "flip" (one spike of example
0 at step 1 inverted where it is produced), "carry_unchanged" (every step
returns the influence unchanged), "params_unchanged" (the update leaves
the parameters unchanged).
"""
from __future__ import annotations

import contextlib

import torch

LEAVES = ("W", "R", "b", "theta", "out_W", "out_b")
FAULTS = ("half_batch", "flip", "carry_unchanged", "params_unchanged")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: the low 13 of float32's 23 mantissa bits cleared,
    to nearest (ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def full_f32():
    """Every float32 product in full float32 while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def live_columns(mask_W: torch.Tensor, mask_R: torch.Tensor):
    """(q, j) of every live recurrent parameter, by unit q then by its
    place j in the unit's group (W column, R column, b, theta)."""
    n = mask_R.shape[0]
    ones = mask_R.new_ones((n, 2))
    group = torch.cat([mask_W.T, mask_R.T, ones], dim=1) > 0    # [n, m]
    q, j = group.nonzero(as_tuple=True)
    return q, j


def unflatten(g: torch.Tensor, q, j, n_in: int, n: int) -> dict:
    """A gradient over the live columns -> the leaves W, R, b, theta."""
    G = g.new_zeros((n, n_in + n + 2))
    G[q, j] = g
    return {"W": G[:, :n_in].T.contiguous(),
            "R": G[:, n_in:n_in + n].T.contiguous(),
            "b": G[:, n_in + n].clone(), "theta": G[:, n_in + n + 1].clone()}


def run(params: dict, masks: dict, xs: torch.Tensor, ys: torch.Tensor, *,
        k: int, windows: int, opt: dict, gamma: float, eps: float,
        follow: torch.Tensor | None = None,
        follow_params: list | None = None, precision: str = "f32",
        fault: str | None = None, col_block: int = 8192) -> dict:
    """Train for `windows` windows of `k` steps from xs [T, B, n_in], ys
    [T, B] (T >= windows * k).  `params`: the leaves of LEAVES, masked;
    `masks`: {"W", "R"} of 0/1; `opt`: adamw's lr, b1, b2, eps,
    weight_decay.

    Returns {"v", "spikes", "activity": [T, B, n]; "kb": [T, B] rows with
    h' != 0; "losses": [windows] floats; "grad1": the first window's
    gradient by leaf (masked, as the optimizer gets it); "params": the
    leaves after the last update (p_0 plus its own steps); "window_params":
    the leaves each window ran from; "carry": M [B, n, Pc]; "cols":
    (q, j)}."""
    if precision not in ("f32", "tf32"):
        raise ValueError(f"precision must be 'f32' or 'tf32', got "
                         f"{precision!r}")
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    with torch.no_grad(), full_f32():
        return _run(params, masks, xs, ys, k, windows, opt, gamma, eps,
                    follow, follow_params, precision, fault, col_block)


def _run(params, masks, xs, ys, k, windows, opt, gamma, eps, follow,
         follow_params, precision, fault, col_block):
    rnd = tf32 if precision == "tf32" else (lambda t: t)

    def mm(a, b):
        return torch.matmul(rnd(a), rnd(b))

    own = {name: params[name].detach().clone().float() for name in LEAVES}
    mW, mR = masks["W"].float(), masks["R"].float()
    leaf_mask = {"W": mW, "R": mR}
    T, B, n_in = xs.shape
    n = own["R"].shape[0]
    dev = xs.device
    q, j = live_columns(mW, mR)
    Pc = q.numel()
    M = torch.zeros((B, n, Pc), dtype=torch.float32, device=dev)
    a = torch.zeros((B, n), dtype=torch.float32, device=dev)
    m1 = {name: torch.zeros_like(t) for name, t in own.items()}
    m2 = {name: torch.zeros_like(t) for name, t in own.items()}
    keep = torch.ones((B, 1), device=dev)
    n_keep = B
    if fault == "half_batch":
        keep[B // 2:] = 0.0
        n_keep = B // 2
    ones = torch.ones((B, 1), device=dev)
    tt = float(k)
    out = {"v": [], "spikes": [], "activity": [], "kb": [], "losses": [],
           "window_params": []}
    for w in range(windows):
        p = own
        if follow_params is not None:
            p = {name: follow_params[w][name].to(dev).float()
                 for name in LEAVES}
        out["window_params"].append({name: t.clone() for name, t in p.items()})
        gw = torch.zeros((Pc,), dtype=torch.float32, device=dev)
        g_out = {"out_W": torch.zeros_like(p["out_W"]),
                 "out_b": torch.zeros_like(p["out_b"])}
        loss = torch.zeros((), dtype=torch.float64, device=dev)
        RT = p["R"].T
        for s in range(k):
            t = w * k + s
            x, y = xs[t].float(), ys[t].long()
            v = mm(x, p["W"]) + mm(a, p["R"]) + p["b"] - p["theta"]
            spike = (v > 0).float() * keep
            hp = gamma * torch.clamp(1.0 - v.abs() / (2.0 * eps), min=0.0)
            hp = hp * keep
            a_new = spike if follow is None else follow[t].float()
            if fault == "flip" and t == 1:
                kk = int(v[0].abs().argmax())
                a_new = a_new.clone()
                a_new[0, kk] = 1.0 - a_new[0, kk]
            # the readout, its loss and c-bar = dL_t / da_t
            logits = mm(a_new, p["out_W"]) + p["out_b"]
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(1, y[:, None])
            loss += (nll * keep).sum().double() / n_keep / tt
            onehot = torch.zeros_like(logp).scatter(1, y[:, None], 1.0)
            dlog = (logp.exp() - onehot) * keep / (n_keep * tt)
            g_out["out_W"] += mm(a_new.T, dlog)
            g_out["out_b"] += dlog.sum(dim=0)
            cbar = mm(dlog, p["out_W"].T)
            g = torch.cat([x, a, ones, -ones], dim=1)           # [B, m]
            if fault != "carry_unchanged":
                for c0 in range(0, Pc, col_block):
                    c1 = min(Pc, c0 + col_block)
                    blk = mm(RT, M[:, :, c0:c1])                 # [B, n, cb]
                    cols = torch.arange(c1 - c0, device=dev)
                    blk[:, q[c0:c1], cols] += g[:, j[c0:c1]]
                    blk *= hp[:, :, None]
                    M[:, :, c0:c1] = blk
                    gw[c0:c1] += torch.einsum(
                        "bk,bkc->c", rnd(cbar), rnd(blk))
            else:
                for c0 in range(0, Pc, col_block):
                    c1 = min(Pc, c0 + col_block)
                    gw[c0:c1] += torch.einsum(
                        "bk,bkc->c", rnd(cbar), rnd(M[:, :, c0:c1]))
            a = a_new
            out["v"].append(v)
            out["spikes"].append(spike)
            out["activity"].append(a_new)
            out["kb"].append((hp != 0).sum(dim=1))
        grads = unflatten(gw, q, j, n_in, n)
        grads.update(g_out)
        grads = {name: g * leaf_mask[name] if name in leaf_mask else g
                 for name, g in grads.items()}
        out["losses"].append(float(loss))
        if w == 0:
            out["grad1"] = {name: g.clone() for name, g in grads.items()}
        if fault != "params_unchanged":
            _adamw(own, m1, m2, grads, leaf_mask, w, opt)
    out["params"] = own
    out["carry"] = M
    out["cols"] = (q, j)
    for key in ("v", "spikes", "activity", "kb"):
        out[key] = torch.stack(out[key])
    return out


def _adamw(p, m1, m2, grads, leaf_mask, step, opt):
    """Masked adamw: the gradient and the new parameters masked; bias
    corrections 1 - b^(step + 1)."""
    lr, b1, b2 = opt["lr"], opt["b1"], opt["b2"]
    eps, wd = opt["eps"], opt.get("weight_decay", 0.0)
    c1 = 1.0 - b1 ** (step + 1)
    c2 = 1.0 - b2 ** (step + 1)
    for name in LEAVES:
        g = grads[name]
        m1[name] = b1 * m1[name] + (1.0 - b1) * g
        m2[name] = b2 * m2[name] + (1.0 - b2) * g * g
        upd = (m1[name] / c1) / ((m2[name] / c2).sqrt() + eps)
        if wd:
            upd = upd + wd * p[name]
        p[name] = p[name] - lr * upd
        if name in leaf_mask:
            p[name] = p[name] * leaf_mask[name]
