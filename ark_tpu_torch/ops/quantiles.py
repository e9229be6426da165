"""Quantiles with numpy linear interpolation, in torch ops.

Port of ``ark_tpu/ops/quantiles.py``. The sort path (``quantile``,
``nanquantile`` and the per-column forms) takes its order statistics from
``torch.sort``; the interpolation reproduces ``jnp.quantile``/
``jnp.nanquantile`` step for step in f32 (``jax/_src/numpy/reductions.py::
_quantile``): the position ``q * (n - 1)``, its floor and ceil clamped to the
valid rows, and ``low * (1 - frac) + high * frac`` rounded as XLA's CPU
backend rounds it. The bisection forms (``*_bisect``) take the same exact
order statistics from ``masked_order_stats`` (sorted order-preserving keys of
the float bits, the elements JAX's 32 counting passes pick) and keep the JAX
bisection's own interpolation. Every result equals the jitted JAX function's
on CPU bit for bit. The JAX package
picks bisection on a TPU by itself; here a caller names the form it wants.
``torch.quantile`` is not used: it has its own formula and an input-size cap.
"""

from __future__ import annotations

import torch


def _interpolate(sorted_x: torch.Tensor, counts: torch.Tensor, q: float,
                 fuse_high: bool) -> torch.Tensor:
    """Linear interpolation along dim 0 of `sorted_x` (valid entries first),
    over the first `counts` rows of each column; `counts` is f32, shaped like
    one row of `sorted_x`. NaN where a column has no valid rows."""
    pos = torch.tensor(q, dtype=torch.float32, device=sorted_x.device) \
        * (counts - 1.0)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1.0 - high_weight
    last = counts - 1.0
    low = torch.clamp_min(torch.minimum(low, last), 0.0).to(torch.int64)
    high = torch.clamp_min(torch.minimum(high, last), 0.0).to(torch.int64)
    low_value = torch.gather(sorted_x, 0, low[None])[0]
    high_value = torch.gather(sorted_x, 0, high[None])[0]
    # XLA's CPU backend contracts `low * lw + high * hw` into one fused
    # multiply-add: fma(high, hw, low * lw) in nanquantile, fma(low, lw,
    # high * hw) in quantile (measured against the installed jax)
    if fuse_high:
        return _fma(high_value, high_weight, low_value * low_weight)
    return _fma(low_value, low_weight, high_value * high_weight)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, as a fused multiply-add. The f64 product of
    two f32 values is exact, so the f64 sum rounded to f32 is the fused
    result (up to double rounding, which the parity tests have not met at
    these magnitudes)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)
            ).to(torch.float32)


def nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.nanquantile(x, q, axis=0)``: per column, NaN entries ignored,
    NaN for a column with no other entries."""
    x = x.to(torch.float32)
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], float("nan"), device=x.device)
    counts = torch.sum(~torch.isnan(x), dim=0, dtype=torch.float32)
    # torch.sort orders NaN after every number, as lax.sort does
    return _interpolate(torch.sort(x, dim=0).values, counts, q, fuse_high=True)


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.quantile(x, q) with linear interpolation over all of x; NaN if x
    holds a NaN."""
    flat = x.reshape(-1).to(torch.float32)
    counts = torch.tensor(float(flat.shape[0]), device=flat.device)
    out = _interpolate(torch.sort(flat).values[:, None], counts[None], q,
                       fuse_high=False)[0]
    return torch.where(torch.any(torch.isnan(flat)), float("nan"), out)


def nonzero_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile of the positive entries of x (reference pattern
    ``img[img > 0]`` then np.quantile). NaN if no positive entries."""
    x = x.reshape(-1).to(torch.float32)
    return nanquantile(torch.where(x > 0, x, float("nan"))[:, None], q)[0]


def nonzero_quantile_per_column(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column q-quantile ignoring zeros (pandas
    ``.replace(0, np.nan).quantile(q)`` semantics). x: (N, C) -> (C,)."""
    x = x.to(torch.float32)
    return nanquantile(torch.where(x == 0, float("nan"), x), q)


def masked_quantile_per_column(x: torch.Tensor, valid: torch.Tensor,
                               q: float) -> torch.Tensor:
    """Per-column quantile over rows where `valid` is True, ignoring zeros."""
    x = x.to(torch.float32)
    bad = (~valid[:, None]) | (x == 0)
    return nanquantile(torch.where(bad, float("nan"), x), q)


# ---------------------------------------------------------------------------
# Exact order statistics on the order-preserving keys of the float bits.
# torch has almost no uint32 arithmetic, so a key is the uint32 value held in
# an int64. The JAX package bisects 32 times on these keys; sorting them
# gives the same element, bit for bit (-0.0 before +0.0, NaN past +inf).
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _float_keys(x: torch.Tensor) -> torch.Tensor:
    """IEEE754 f32 -> order-preserving uint32 key (negatives flipped), as
    int64 in [0, 2**32)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where((bits >> 31) == 1, (~bits) & _U32, bits ^ _SIGN)


def _keys_to_float(keys: torch.Tensor) -> torch.Tensor:
    fbits = torch.where((keys >> 31) == 1, keys ^ _SIGN, (~keys) & _U32)
    signed = torch.where(fbits >= _SIGN, fbits - (1 << 32), fbits)
    return signed.to(torch.int32).view(torch.float32)


def masked_order_stats(x: torch.Tensor, valid: torch.Tensor,
                       ranks: torch.Tensor) -> torch.Tensor:
    """Exact order statistics of the VALID entries per column. x: (N, C);
    valid: (N, C) bool; ranks: (C, M) int. Returns (C, M) f32, the
    rank[c, m]-th smallest valid value of column c. A rank past the valid
    count gives what the JAX package's 32 bisection steps end on there: key
    0xFFFFFFFF, the NaN of bits 0x7FFFFFFF."""
    key = torch.where(valid, _float_keys(x), _U32)
    sorted_keys = torch.sort(key, dim=0).values.T                  # (C, N)
    k = ranks.to(torch.int64)
    n_valid = torch.sum(valid, dim=0)[:, None]                      # (C, 1)
    picked = torch.gather(sorted_keys, 1,
                          torch.clamp(k, 0, max(x.shape[0] - 1, 0)))
    return _keys_to_float(torch.where(k < n_valid, picked, _U32))


def _bisect_quantile(x: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column linear-interpolated q-quantile of the valid entries of
    (N, C) `x`, in the JAX package's bisection arithmetic: the
    position q * max(n - 1, 0), the ranks floor(pos) and min(floor + 1,
    n - 1), then stats0 * (1 - frac) + stats1 * frac, which XLA's CPU
    backend fuses into fma(stats1, frac, stats0 * (1 - frac)). NaN where a
    column has no valid entry."""
    n_valid = torch.sum(valid, dim=0)
    last = torch.clamp_min(n_valid - 1, 0)
    pos = torch.tensor(q, dtype=torch.float32, device=x.device) * last.to(torch.float32)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.minimum(i0 + 1, last)
    frac = pos - i0.to(torch.float32)
    stats = masked_order_stats(x, valid, torch.stack([i0, i1], dim=1))
    out = _fma(stats[:, 1], frac, stats[:, 0] * (1.0 - frac))
    return torch.where(n_valid > 0, out, float("nan"))


def _masked_quantile_flat(flat: torch.Tensor, valid: torch.Tensor,
                          q: float) -> torch.Tensor:
    """Linear-interpolated q-quantile of the valid entries of a 1-D array, in
    the bisection arithmetic; NaN when nothing is valid."""
    return _bisect_quantile(flat.to(torch.float32)[:, None], valid[:, None], q)[0]


def nonzero_quantile_per_column_bisect(x: torch.Tensor, q: float) -> torch.Tensor:
    """`nonzero_quantile_per_column` in the JAX bisection's arithmetic.
    x: (N, C) -> (C,); zeros and NaNs ignored, NaN for a column with neither
    left."""
    x = x.to(torch.float32)
    return _bisect_quantile(x, (x != 0) & ~torch.isnan(x), q)


def masked_quantile_per_column_bisect(x: torch.Tensor, valid: torch.Tensor,
                                      q: float) -> torch.Tensor:
    """`masked_quantile_per_column` in the JAX bisection's arithmetic: rows
    where `valid` is True, zeros and NaNs ignored."""
    x = x.to(torch.float32)
    return _bisect_quantile(x, valid[:, None] & (x != 0) & ~torch.isnan(x), q)
