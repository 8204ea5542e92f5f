"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of the work the metrics divide by.

Frozen here, beside the benchmark, so that a change to the program cannot
move the yardstick.  The counts follow `repro_torch/core/costs.py`
(`ragged_influence_update_flops`, `influence_update_bytes`,
`carry_footprint`) and the K1 bound of `chip_smoke.py` (`k1_bound`), taken
per example at the row counts a launch actually had.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates.  The compute
peak of every share here is the TF32 tensor-core rate: the fastest rate at
which the card forms a product held to an f32 tolerance (3xTF32 included),
so no implementation of the same work can read above it.
"""
from __future__ import annotations

import numpy as np

PEAK_FLOP_S = 495e12          # TF32 dense, tensor cores
HBM_BYTES_S = 3.35e12         # HBM3


def k1_flops(kb, kb_prev, pc: int) -> float:
    """Operations of one launch of the fused influence update (K1):
    2 K_b K'_b Pc multiply-adds' worth for the contraction, and 2 K_b Pc for
    the M-bar add and the hp scale, summed over the examples b."""
    kb = np.asarray(kb, np.float64)
    kp = np.asarray(kb_prev, np.float64)
    return float(2.0 * pc * np.sum(kb * kp) + 2.0 * pc * np.sum(kb))


def k1_bytes(kb, kb_prev, pc: int, capacity: int,
             carry_bytes: int = 4) -> float:
    """Least HBM traffic of one K1 launch at these row counts: the previous
    carry's live rows read once, the M-bar rows of the live new rows read
    once (f32), the gathered J-hat entries (f32), hp, both index rows and
    the counts, and the whole new carry [B, capacity, Pc] written once."""
    kb = np.asarray(kb, np.float64)
    kp = np.asarray(kb_prev, np.float64)
    B = kb.size
    return float(kp.sum() * pc * carry_bytes        # previous carry rows
                 + kb.sum() * pc * 4                # M-bar rows
                 + np.sum(kb * kp) * 4              # gathered J-hat
                 + kb.sum() * 4                     # hp rows
                 + 2 * B * capacity * 4 + 2 * B * 4  # index rows, counts
                 + B * capacity * pc * carry_bytes)  # the new carry


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """(least time, what bounds it) on one card."""
    t_ops, t_bytes = flops / PEAK_FLOP_S, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rnn_step_flops(batch: int, n: int, n_in: int, n_out: int, kb,
                   pc: int) -> float:
    """Operations of one stream step of the thresholded RNN outside K1: the
    cell's forward (x W + a R), the readout and its gradient, and the
    gradient extraction c-bar^T M over the live rows of the compact carry."""
    kb = np.asarray(kb, np.float64)
    forward = 2.0 * batch * n * (n_in + n)
    readout = 2.0 * batch * n * n_out * 3          # logits, dW_out, c-bar
    extraction = 2.0 * pc * kb.sum()
    return float(forward + readout + extraction)

