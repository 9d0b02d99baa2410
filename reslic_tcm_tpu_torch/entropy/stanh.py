"""STanH: the learnable sum-of-tanh soft-to-hard quantizer (port of
reslic_tcm_tpu/entropy/stanh.py).

A staircase of L steps with learnable heights ``w`` and positions ``b``,
smoothed by a temperature beta:

    soft(x) = sum_i (w_i / 2) * (2 * sigmoid(2 * beta * (x - b_i)) - 1)
    hard(x) = the beta -> inf limit, an exact staircase over the levels cum_w

The derived state (levels ``cum_w``, decision midpoints, half-widths) is a
pure function of (w, b). Its two sums are rounded as the JAX package's
CPU programs round them (``_xla_cumsum``, ``_xla_sum``): the coding tables
and the decoder's levels are built from them, so they must agree with the
JAX package bit for bit. The per-rate-level quantizers are one stacked
``[n_rates, L]`` parameter pair indexed by the level ``lv``, a Python int.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

# XLA's CPU scan runs sequentially within blocks of this many elements
_SCAN_BLOCK = 16
# and its CPU reduction sequentially within chunks of this many
_SUM_CHUNK = 32


class StanhState(NamedTuple):
    """Derived quantizer state of one rate level."""

    w: torch.Tensor  # effective step heights (mirrored for symmetric)
    b: torch.Tensor  # effective step positions, sorted
    cum_w: torch.Tensor  # quantization levels, ascending
    average_points: torch.Tensor  # decision thresholds between levels
    distance_left: torch.Tensor  # half-width to the left neighbour, per level
    distance_right: torch.Tensor  # half-width to the right neighbour, per level


def init_w_b(num_sigmoids: int, extrema: int, symmetric: bool):
    """Reference initialization (activation.py:18-39, 171-194), numpy."""
    if symmetric:
        rng = np.arange(0.5, extrema, 1.0, dtype=np.float32)
        if num_sigmoids > 0:
            jump = len(rng) / num_sigmoids
            b = np.arange(jump / 2, extrema + jump / 2, len(rng) / num_sigmoids,
                          dtype=np.float32)[:num_sigmoids]
            w = np.full(num_sigmoids, jump, np.float32)
        else:
            b = rng.copy()
            w = np.ones(len(rng), np.float32)
    else:
        rng = np.arange(-extrema + 0.5, extrema, 1.0, dtype=np.float32)
        if num_sigmoids > 0:
            jump = len(rng) / num_sigmoids
            b = np.arange(-extrema + jump / 2, extrema + jump / 2,
                          len(rng) / num_sigmoids, dtype=np.float32)[:num_sigmoids]
            w = np.full(num_sigmoids, jump, np.float32)
        else:
            b = rng.copy()
            w = np.ones(len(rng), np.float32)
    return w, b


def _columns_cumsum(blocks: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along dim 1, accumulated one column at a time
    in the tensor's dtype (torch.cumsum accumulates float32 in double on
    the CPU)."""
    cols = [blocks[:, 0]]
    for j in range(1, blocks.shape[1]):
        cols.append(cols[-1] + blocks[:, j])
    return torch.stack(cols, dim=1)


def _xla_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, rounded as ``jnp.cumsum`` on
    the CPU: sequential within blocks of 16, the block totals scanned the
    same way, and each block offset by the exclusive prefix of the totals."""
    n = w.shape[0]
    if n <= _SCAN_BLOCK:
        return _columns_cumsum(w[None])[0]
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.cat([w, w.new_zeros(nb * _SCAN_BLOCK - n)]).reshape(nb, _SCAN_BLOCK)
    inner = _columns_cumsum(blocks)
    prefix = _xla_cumsum(inner[:, -1])
    offset = torch.cat([prefix.new_zeros(1), prefix[:-1]])
    return (inner + offset[:, None]).reshape(-1)[:n]


def _xla_sum(w: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D tensor, rounded as ``jnp.sum`` on the CPU for up to 32
    elements and for multiples of 32 (sequential within chunks of 32, then
    over the chunks' sums); other lengths above 32 may differ by an ulp."""
    n = w.shape[0]
    nc = -(-n // _SUM_CHUNK)
    chunks = torch.cat([w, w.new_zeros(nc * _SUM_CHUNK - n)]).reshape(nc, _SUM_CHUNK)
    partial = w.new_zeros(nc)
    for j in range(_SUM_CHUNK):
        partial = partial + chunks[:, j]
    return partial[0] if nc == 1 else _xla_sum(partial)


def derive_state(w: torch.Tensor, b: torch.Tensor, symmetric: bool) -> StanhState:
    """The pure version of update_state() (activation.py:72-98, 214-234)."""
    zero = w.new_zeros(1)
    if symmetric:
        w_eff = torch.cat([torch.flip(w, [0]), w])
        b_eff = torch.sort(torch.cat([-torch.flip(b, [0]), b])).values
        half = _xla_cumsum(w)
        cum_w = torch.cat([-torch.flip(half, [0]), zero, half])
    else:
        w_eff = w
        b_eff = torch.sort(b).values
        cum_w = torch.cat([zero, _xla_cumsum(w)]) - _xla_sum(w) / 2
    avg = (cum_w[1:] + cum_w[:-1]) / 2
    dist = (cum_w[1:] - cum_w[:-1]) / 2
    return StanhState(w=w_eff, b=b_eff, cum_w=cum_w, average_points=avg,
                      distance_left=torch.cat([zero, dist]),
                      distance_right=torch.cat([dist, zero]))


def soft_quantize(x: torch.Tensor, state: StanhState, beta) -> torch.Tensor:
    """The differentiable staircase at temperature beta (activation.py:135-150)."""
    f = 2.0 * torch.sigmoid(2.0 * beta * (x[..., None] - state.b)) - 1.0
    return torch.sum((state.w / 2.0) * f, dim=-1)


def hard_quantize(x: torch.Tensor, state: StanhState, symmetric: bool) -> torch.Tensor:
    """The beta -> inf staircase (the reference's beta == -1 branch)."""
    d = x[..., None] - state.b
    if symmetric:
        return torch.sum((state.w / 2.0) * torch.sign(d), dim=-1)
    return torch.sum(state.w * (d > 0), dim=-1) - torch.sum(state.w) / 2.0


def to_symbols(x: torch.Tensor, state: StanhState) -> torch.Tensor:
    """Level index of the hard staircase, #{b_i < x} (``jnp.searchsorted``'s
    left side): hard(x) == cum_w[to_symbols(x)]. int64."""
    return torch.searchsorted(state.b, x.contiguous(), right=False)


def from_symbols(k: torch.Tensor, state: StanhState) -> torch.Tensor:
    return state.cum_w[k.long()]


def interval_bounds(values: torch.Tensor, state: StanhState):
    """(v0, v1): half-distances to the neighbour levels of each value's bin
    (vectorized define_v0_and_v1, adaptive_gaussian_conditional.py:495-537)."""
    k = torch.searchsorted(state.average_points, values.detach().contiguous(), right=False)
    return state.distance_left[k], state.distance_right[k]


def per_level_cfg(value, n_rates: int):
    """An int-or-sequence quantizer knob as one int per rate level. The
    levels share one stacked [n_rates, L] parameter, so per-level values
    are allowed as long as every level gets the same L."""
    if isinstance(value, (tuple, list)):
        vals = tuple(int(v) for v in value)
        if len(vals) == 1:
            vals = vals * n_rates
        if len(vals) != n_rates:
            raise ValueError(f"per-level quantizer config {vals} has {len(vals)} entries "
                             f"for {n_rates} rate levels")
        return vals
    return (int(value),) * n_rates


class StanhQuantizer(nn.Module):
    """The stacked per-rate-level STanH parameters ``w`` and ``b``
    ([n_rates, L]); ``state(lv)`` derives level ``lv``'s quantizer. With
    ``trainable=False`` the state is detached (JAX's stop_gradient): the
    parameters stay in the checkpoint but get no gradient.
    ``num_sigmoids`` / ``extrema``: one int for all levels, or one per
    level (every level must give the same L)."""

    def __init__(self, n_rates: int = 1, num_sigmoids=0, extrema=5, symmetric: bool = False,
                 trainable: bool = True):
        super().__init__()
        self.n_rates, self.symmetric, self.trainable = n_rates, symmetric, trainable
        ns = per_level_cfg(num_sigmoids, n_rates)
        ex = per_level_cfg(extrema, n_rates)
        inits = [init_w_b(n, e, symmetric) for n, e in zip(ns, ex)]
        lengths = {len(w) for w, _ in inits}
        if len(lengths) != 1:
            raise ValueError(
                f"per-level stanh configs must all produce the same number of steps L (got "
                f"lengths {sorted(lengths)} from num_sigmoids={ns}, extrema={ex}); fix "
                "num_sigmoids>0 across levels and vary extrema to vary the step size at equal L")
        self.w = nn.Parameter(torch.from_numpy(np.stack([w for w, _ in inits])))
        self.b = nn.Parameter(torch.from_numpy(np.stack([b for _, b in inits])))
        self._cache: dict = {}

    @property
    def n_levels(self) -> int:
        L = self.w.shape[1]
        return 2 * L + 1 if self.symmetric else L + 1

    def state(self, lv: int) -> StanhState:
        """Level ``lv``'s derived state. Outside autograd it is cached until
        ``w`` or ``b`` change (the codec asks for it once per slice)."""
        w, b = self.w[lv], self.b[lv]
        if not self.trainable:
            w, b = w.detach(), b.detach()
        if torch.is_grad_enabled() and w.requires_grad:
            return derive_state(w, b, self.symmetric)
        key = (int(lv), self.w._version, self.b._version, self.w.data_ptr(), self.b.data_ptr())
        if key not in self._cache:
            self._cache = {key: derive_state(w.detach(), b.detach(), self.symmetric)}
        return self._cache[key]

    def soft(self, x, beta, lv: int):
        return soft_quantize(x, self.state(lv), beta)

    def hard(self, x, lv: int):
        return hard_quantize(x, self.state(lv), self.symmetric)


def np_state(w: np.ndarray, b: np.ndarray, symmetric: bool) -> StanhState:
    """The derived state as float32 numpy arrays (for the CDF tables)."""
    state = derive_state(torch.as_tensor(np.asarray(w, np.float32)),
                         torch.as_tensor(np.asarray(b, np.float32)), symmetric)
    return StanhState(*(t.numpy() for t in state))


def compute_gap(y, y_soft, y_hard) -> torch.Tensor:
    """|MSE(y, soft) - MSE(y, hard)|, detached: the beta-annealing drive
    signal (reference wacnn_stanh.py:261-274)."""
    f_tilde = torch.mean((y - y_soft) ** 2)
    f_hat = torch.mean((y - y_hard) ** 2)
    return torch.abs(f_tilde - f_hat).detach()
