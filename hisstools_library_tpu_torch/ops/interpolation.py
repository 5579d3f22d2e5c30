"""Polynomial interpolation kernels (reference Interpolation.hpp), on torch
tensors.

Counterpart of ``hisstools_library_tpu/ops/interpolation.py``. Each
interpolator is an elementwise function of the fractional position ``x`` and
the neighbouring samples; the coefficient forms match the reference exactly
(Interpolation.hpp:11-88). They take tensors or Python numbers alike.
"""

from __future__ import annotations

import enum


class InterpType(enum.Enum):
    None_ = 0
    Linear = 1
    CubicHermite = 2
    CubicLagrange = 3
    CubicBSpline = 4


def linear_interp(x, y0, y1):
    """(Interpolation.hpp:11-15)"""
    return y0 + x * (y1 - y0)


def cubic_hermite_interp(x, y0, y1, y2, y3):
    """Catmull-Rom style Hermite (Interpolation.hpp:19-39)."""
    c0 = y1
    c1 = 0.5 * (y2 - y0)
    c2 = y0 - 2.5 * y1 + y2 + y2 - 0.5 * y3
    c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
    return ((c3 * x + c2) * x + c1) * x + c0


def cubic_lagrange_interp(x, y0, y1, y2, y3):
    """(Interpolation.hpp:43-63)"""
    third = 1.0 / 3.0
    sixth = 1.0 / 6.0
    c0 = y1
    c1 = y2 - third * y0 - 0.5 * y1 - sixth * y3
    c2 = 0.5 * (y0 + y2) - y1
    c3 = sixth * (y3 - y0) + 0.5 * (y1 - y2)
    return ((c3 * x + c2) * x + c1) * x + c0


def cubic_bspline_interp(x, y0, y1, y2, y3):
    """(Interpolation.hpp:67-88)"""
    two_thirds = 2.0 / 3.0
    sixth = 1.0 / 6.0
    y0py2 = y0 + y2
    c0 = sixth * y0py2 + two_thirds * y1
    c1 = 0.5 * (y2 - y0)
    c2 = 0.5 * y0py2 - y1
    c3 = 0.5 * (y1 - y2) + sixth * (y3 - y0)
    return ((c3 * x + c2) * x + c1) * x + c0


FOUR_POINT = {
    InterpType.CubicHermite: cubic_hermite_interp,
    InterpType.CubicLagrange: cubic_lagrange_interp,
    InterpType.CubicBSpline: cubic_bspline_interp,
}
