"""The paper's own experiment: EGRU, 16 hidden units, 2-D spiral task.

"We trained an EGRU with 16 hidden units for 1700 iterations with Adam and a
batch size of 32" on 10,000 spirals of 17 timesteps (Sec. 6).
`stacked(L)` lifts it to an L-layer stack trained with exact block
lower-triangular RTRL (`core.stacked_rtrl`); `launch.train --arch
egru-spiral --layers L` drives it.  Counterpart of
`repro.configs.egru_spiral`.
"""
from repro_torch.core.cells import EGRUConfig, StackedEGRUConfig, stacked_config

CONFIG = EGRUConfig(
    n_hidden=16, n_in=2, n_out=2,
    seq_len=17, batch_size=32, iterations=1700,
    lr=5e-3,
    # pseudo-derivative H'(v) = gamma * max(0, 1 - |v| / (2*eps))
    gamma=1.0, eps=0.3,
)


def stacked(n_layers: int = 2,
            layer_sizes: tuple | None = None) -> StackedEGRUConfig:
    """The spiral experiment as an L-layer stack (16 units per layer unless
    explicit `layer_sizes` are given); n_layers=1 is the paper's setup."""
    return stacked_config(CONFIG, n_layers, layer_sizes)


STACKED_CONFIG = stacked(2)
