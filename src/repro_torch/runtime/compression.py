"""Error-feedback int8 gradient compression for the cross-pod all-reduce.

Counterpart of `repro.runtime.compression`.  The slow axis in a multi-pod
job is the network between pods; the classic mitigation is a quantized
all-reduce with error feedback:

    q = quantize_int8(g + e)          # e: residual carried across steps
    g_hat = psum(q) * scale           # int8 on the wire (4x fewer bytes)
    e'   = (g + e) - dequant(q)       # feedback keeps the update unbiased
                                      # over time (compression error decays)

The reference runs it as a shard_map over the mesh with every gradient
leaf replicated (the pure-DP-across-pods mode, grads already reduced
in-pod).  Here each rank runs it on its own leaves and reduces over the
group of one mesh dim (default ``pod``), with two collectives a leaf
(`sharding`): an all_reduce SUM of the int8 codes widened to int32 and
an all_reduce MAX of the scale.  The group size n is the mesh dim's.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import sharding as SH
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_map_with_path

Tree = Any


def _quant_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization -> (q, scale).  `round` is
    half-to-even, as jnp.round."""
    amax = x.abs().max()
    scale = amax.clamp(min=1e-12) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def ef_int8_allreduce(g: torch.Tensor, err: torch.Tensor, mesh,
                      axis_name: str):
    """One error-feedback compressed all-reduce step over mesh dim
    `axis_name`.  Returns (g_hat averaged over the dim, new_err)."""
    x = g.float() + err
    q, scale = _quant_int8(x)
    # int8 summed in int32 on the wire; scales reduced separately (max)
    qsum = SH.all_reduce(q.to(torch.int32), mesh, axis_name)
    scale_max = SH.all_reduce(scale.reshape(1), mesh, axis_name, op="max")[0]
    n = float(mesh[axis_name].size())
    g_hat = qsum.float() * scale_max / n
    new_err = x - q.float() * scale
    return g_hat, new_err


def compressed_psum(grads: Tree, err: Tree, mesh, axis_name: str = "pod"):
    """Tree-level compressed mean over `axis_name` with error feedback.
    Every leaf is this rank's whole gradient (replicated over the other
    mesh dims); only the `axis_name` reduction goes through int8.
    Returns (g_hat tree, new err tree)."""
    errs = dict(tree_flatten_with_path(err))
    outs = {}

    def one(path, g):
        outs[path] = ef_int8_allreduce(g, errs[path], mesh, axis_name)
        return outs[path][0]

    g_hat = tree_map_with_path(one, grads)
    new_err = tree_map_with_path(lambda path, _: outs[path][1], grads)
    return g_hat, new_err


def init_error_state(grads_like: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                                          device=g.device), grads_like)
