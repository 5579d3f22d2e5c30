"""Array statistics (reference Statistics.hpp), as torch reductions.

Counterpart of ``hisstools_library_tpu/ops/statistics.py``: the reference
evaluates statistics through composable modifier views (abs, squares, logs,
index weights); here each statistic is a reduction over the last axis, on
the tensor's own device and in its own dtype (float64 stays float64). Inputs
may be tensors or anything ``torch.as_tensor`` takes. Counts are exact: see
:func:`_count_dtype`. The reference's ``stat_count`` reads an uninitialised
loop index (Statistics.hpp:108); it is implemented correctly here, as in the
JAX package.
"""

from __future__ import annotations

import math

import torch


def _asf(x) -> torch.Tensor:
    return torch.as_tensor(x)


def stat_length(x) -> torch.Tensor:
    return torch.tensor(float(_asf(x).shape[-1]), dtype=torch.float64)


def stat_min(x):
    x = _asf(x)
    return x.amin(dim=-1) if x.shape[-1] else torch.tensor(math.inf)


def stat_max(x):
    x = _asf(x)
    return x.amax(dim=-1) if x.shape[-1] else torch.tensor(-math.inf)


def stat_min_position(x):
    """Index of the minimum as an exact integer (the reference returns a
    double, Statistics.hpp:79; cast at the call site if needed); -1 when
    empty, in the same integer dtype."""
    x = _asf(x)
    if x.shape[-1]:
        return torch.argmin(x, dim=-1)
    return torch.full(x.shape[:-1], -1, dtype=torch.int64)


def stat_max_position(x):
    """Index of the maximum (exact integer, -1 when empty; see
    :func:`stat_min_position`)."""
    x = _asf(x)
    if x.shape[-1]:
        return torch.argmax(x, dim=-1)
    return torch.full(x.shape[:-1], -1, dtype=torch.int64)


def _count_dtype(dtype: torch.dtype) -> torch.dtype:
    """The widest float for exact integer counts: float64 inputs count in
    float64 (exact to 2^53); everything else (float32, and bf16 / f16 whose
    integers round above 2^8) in float32 (exact to 2^24)."""
    return dtype if dtype == torch.float64 else torch.float32


def stat_count_above(x, threshold):
    x = _asf(x)
    return (x > threshold).sum(dim=-1).to(_count_dtype(x.dtype))


def stat_count_below(x, threshold):
    x = _asf(x)
    return (x < threshold).sum(dim=-1).to(_count_dtype(x.dtype))


def stat_ratio_above(x, threshold):
    return stat_count_above(x, threshold) / _asf(x).shape[-1]


def stat_ratio_below(x, threshold):
    return stat_count_below(x, threshold) / _asf(x).shape[-1]


def stat_sum(x):
    return _asf(x).sum(dim=-1)


def stat_sum_abs(x):
    return _asf(x).abs().sum(dim=-1)


def stat_sum_squares(x):
    x = _asf(x)
    return (x * x).sum(dim=-1)


def stat_sum_logs(x):
    return torch.log(_asf(x)).sum(dim=-1)


def _indices(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)


def _log_indices(x: torch.Tensor) -> torch.Tensor:
    """log2 of each index, with index 0 weighted 0 (reference log-index
    view)."""
    i = _indices(x)
    return torch.where(i > 0, torch.log2(torch.clamp(i, min=1)), torch.zeros_like(i))


def _weights(x: torch.Tensor, weights) -> torch.Tensor:
    return _indices(x) if weights is None else _asf(weights).to(x.device)


def stat_weighted_sum(x, weights=None):
    """With no weights, the weights are the indices (reference :186-191)."""
    x = _asf(x)
    return (_weights(x, weights) * x).sum(dim=-1)


def stat_weighted_sum_abs(x, weights=None):
    x = _asf(x)
    return (_weights(x, weights) * x.abs()).sum(dim=-1)


def stat_weighted_sum_squares(x, weights=None):
    x = _asf(x)
    return (_weights(x, weights) * x * x).sum(dim=-1)


def stat_weighted_sum_logs(x, weights=None):
    x = _asf(x)
    return (_weights(x, weights) * torch.log(x)).sum(dim=-1)


def stat_product(x):
    return _asf(x).prod(dim=-1)


def stat_mean(x):
    return stat_sum(x) / _asf(x).shape[-1]


def stat_mean_squares(x):
    return stat_sum_squares(x) / _asf(x).shape[-1]


def stat_geometric_mean(x):
    return torch.exp(stat_sum_logs(x) / _asf(x).shape[-1])


def stat_variance(x):
    x = _asf(x)
    d = x - stat_mean(x)[..., None]
    return (d * d).sum(dim=-1) / x.shape[-1]


def stat_standard_deviation(x):
    return torch.sqrt(stat_variance(x))


def stat_pdf_percentile(x, centile):
    """First index where the running sum crosses ``centile``% of the total,
    with the fractional correction (reference :251-268); the last index when
    none does."""
    x = _asf(x)
    frac_of_total = min(max(float(centile), 0.0), 100.0) / 100.0
    target = stat_sum(x) * frac_of_total
    cs = torch.cumsum(x, dim=-1)
    mask = cs >= target[..., None]
    idx = torch.argmax(mask.to(torch.int8), dim=-1)
    found = mask.any(dim=-1)
    hit = torch.gather(cs, -1, idx[..., None])[..., 0]
    val = torch.gather(x, -1, idx[..., None])[..., 0]
    frac = idx.to(x.dtype) - (hit - target) / val
    return torch.where(found, frac, torch.full_like(frac, float(x.shape[-1] - 1)))


def stat_centroid(x):
    return stat_weighted_sum(x) / stat_sum(x)


def _moment(x: torch.Tensor, d: torch.Tensor, power: int) -> torch.Tensor:
    """sum(d^power * x) over the last axis."""
    return (d ** power * x).sum(dim=-1)


def stat_spread(x):
    x = _asf(x)
    d = _indices(x) - stat_centroid(x)[..., None]
    return torch.sqrt(_moment(x, d, 2) / stat_sum(x))


def stat_skewness(x):
    x = _asf(x)
    d = _indices(x) - stat_centroid(x)[..., None]
    denom = stat_spread(x) ** 3 * stat_sum(x)
    return torch.where(denom != 0, _moment(x, d, 3) / denom, torch.zeros_like(denom))


def stat_kurtosis(x):
    x = _asf(x)
    d = _indices(x) - stat_centroid(x)[..., None]
    denom = stat_spread(x) ** 4 * stat_sum(x)
    return torch.where(denom != 0, _moment(x, d, 4) / denom,
                       torch.full_like(denom, math.inf))


def stat_log_centroid(x):
    x = _asf(x)
    return torch.exp2((_log_indices(x) * x).sum(dim=-1) / stat_sum(x))


def _log_offsets(x: torch.Tensor) -> torch.Tensor:
    """log2 index minus log2 of the log centroid."""
    return _log_indices(x) - torch.log2(stat_log_centroid(x))[..., None]


def stat_log_spread(x):
    x = _asf(x)
    return torch.sqrt(_moment(x, _log_offsets(x), 2) / stat_sum(x))


def stat_log_skewness(x):
    x = _asf(x)
    denom = stat_log_spread(x) ** 3 * stat_sum(x)
    return torch.where(denom != 0, _moment(x, _log_offsets(x), 3) / denom,
                       torch.zeros_like(denom))


def stat_log_kurtosis(x):
    x = _asf(x)
    denom = stat_log_spread(x) ** 4 * stat_sum(x)
    return torch.where(denom != 0, _moment(x, _log_offsets(x), 4) / denom,
                       torch.full_like(denom, math.inf))


def stat_flatness(x):
    return stat_geometric_mean(x) / stat_mean(x)


def stat_rms(x):
    return torch.sqrt(stat_mean_squares(x))


def stat_crest(x):
    return stat_max(x) / stat_rms(x)
