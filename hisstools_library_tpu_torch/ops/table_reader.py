"""Table reading with fractional positions, edge behaviours and
interpolation, on torch tensors.

Counterpart of ``hisstools_library_tpu/ops/table_reader.py`` (reference
TableReader.hpp). The whole read is one vectorised gather pipeline: the
position split (floor / fract), the edge index mapping as closed-form index
math, one gather per interpolation point, then the polynomial interpolator
from :mod:`.interpolation`.

Edge modes (TableReader.hpp:10 and its adaptors):

- ``ZeroPad``     out-of-range reads are 0
- ``Extend``      clamp to the edge samples
- ``Wrap``        periodic
- ``Fold``        reflect without repeating the edge samples
- ``Mirror``      reflect repeating the edge samples
- ``Extrapolate`` linear / cubic extrapolation beyond the ends (positions
  are constrained as in the reference adaptor, :130-149)

``bound=True`` clamps positions to [0, limit] before the split
(table_fetcher_bound, :153-167; limit is size - 1, Wrap's is size). Index
modulo is the floor modulo of the reference (``torch.remainder``, never
``torch.fmod``), so negative positions wrap, fold and mirror as there.
"""

from __future__ import annotations

import enum

import torch

from .interpolation import (FOUR_POINT, InterpType, cubic_lagrange_interp,
                            linear_interp)


class EdgeMode(enum.Enum):
    ZeroPad = 0
    Extend = 1
    Wrap = 2
    Fold = 3
    Mirror = 4
    Extrapolate = 5


def _edge_indices(idx: torch.Tensor, size: int, edges: EdgeMode):
    """Map raw integer indices to in-range table indices; returns
    (mapped_idx, zero_mask or None). Closed forms of the adaptors in
    TableReader.hpp:46-167."""
    if edges == EdgeMode.ZeroPad:
        valid = (idx >= 0) & (idx < size)
        return idx.clamp(0, size - 1), ~valid
    if edges == EdgeMode.Extend:
        return idx.clamp(0, size - 1), None
    if edges == EdgeMode.Wrap:
        return torch.remainder(idx, size), None
    if edges == EdgeMode.Fold:
        fold_size = (size - 1) * 2 if size > 1 else 1
        m = torch.remainder(idx.abs(), fold_size)
        return torch.where(m > size - 1, fold_size - m, m), None
    if edges == EdgeMode.Mirror:
        m = torch.remainder(torch.where(idx < 0, -(idx + 1), idx), size * 2)
        return torch.where(m > size - 1, (size * 2 - 1) - m, m), None
    raise ValueError(edges)


def _extrapolate_ends(table: torch.Tensor, interp: InterpType):
    """The extrapolated end values (table_fetcher_extrapolate::prepare,
    TableReader.hpp:130-149)."""
    size = table.shape[-1]
    if size >= 4 and interp not in (InterpType.None_, InterpType.Linear):
        lo = cubic_lagrange_interp(-2.0, table[..., 0], table[..., 1],
                                   table[..., 2], table[..., 3])
        hi = cubic_lagrange_interp(-2.0, table[..., -1], table[..., -2],
                                   table[..., -3], table[..., -4])
    elif size >= 2:
        lo = linear_interp(-1.0, table[..., 0], table[..., 1])
        hi = linear_interp(-1.0, table[..., -1], table[..., -2])
    else:
        lo = hi = table[..., 0] if size > 0 else table.new_zeros(table.shape[:-1])
    return lo, hi


def table_read(table: torch.Tensor, positions: torch.Tensor, mul=1.0,
               interp: InterpType = InterpType.Linear,
               edges: EdgeMode = EdgeMode.ZeroPad,
               bound: bool = False,
               scale: float = 1.0) -> torch.Tensor:
    """Read ``table`` at fractional ``positions`` (reference
    table_read_edges, TableReader.hpp:387-399). ``mul * scale`` multiplies
    the output (the fetcher's scale field, :22-42). The result has shape
    ``table.shape[:-1] + positions.shape``."""
    size = table.shape[-1]
    pos = positions
    n_points = 0 if interp == InterpType.None_ else (2 if interp == InterpType.Linear else 4)

    extrapolate = edges == EdgeMode.Extrapolate
    if bound:
        limit = size if edges == EdgeMode.Wrap else size - 1
        pos = pos.clamp(0, limit)
    if extrapolate:
        # Constrain as the adaptor's split does (:138-143).
        hi = size - (2 if n_points else 1)
        idx0 = torch.floor(pos.clamp(0, hi)).long()
        fract = (pos - idx0.to(pos.dtype)).to(table.dtype)
    else:
        idx0 = torch.floor(pos).long()
        fract = (pos - torch.floor(pos)).to(table.dtype)

    # The end values depend only on (table, interp): computed once, not per tap.
    lo_v, hi_v = _extrapolate_ends(table, interp) if extrapolate else (None, None)

    def fetch(offset: int) -> torch.Tensor:
        idx = idx0 + offset
        if extrapolate:
            v = table[..., idx.clamp(0, size - 1)]
            v = torch.where(idx < 0, lo_v, v)
            return torch.where(idx >= size, hi_v, v)
        mapped, zero_mask = _edge_indices(idx, size, edges)
        v = table[..., mapped]
        if zero_mask is not None:
            v = torch.where(zero_mask, torch.zeros_like(v), v)
        return v

    if interp == InterpType.None_:
        out = fetch(0)
    elif interp == InterpType.Linear:
        out = linear_interp(fract, fetch(0), fetch(1))
    else:
        out = FOUR_POINT[interp](fract, fetch(-1), fetch(0), fetch(1), fetch(2))

    total = mul * scale
    if isinstance(total, (int, float)) and total == 1.0:
        return out
    return out * torch.as_tensor(total, dtype=out.dtype, device=out.device)
