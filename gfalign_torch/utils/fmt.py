"""C++ iostream-compatible number formatting.

The reference prints floats through std::cout, whose formatting *mode* is
global state: gfalibs' Report::reportStats and OutputStream construction
switch std::cout into fixed 2-decimal mode and never switch it back, so the
same statistic prints as "37.5" in one invocation and "37.50" in another
(reference validateFiles/test.0.tst vs test.1.tst; root cause described in
SURVEY.md section 4 quirk 1).  CoutState models that process-wide mode so our
stdout is byte-identical.
"""

from __future__ import annotations

import math


def gfa_round(value: float) -> float:
    """Round to 2 decimals like gfalibs' gfa_round (half away from zero).

    NaN passes through (the reference prints 'nan' for 0/0 averages,
    see validateFiles/test.1.tst:6).
    """
    if isinstance(value, float) and math.isnan(value):
        return value
    if value >= 0:
        return math.floor(value * 100.0 + 0.5) / 100.0
    return -math.floor(-value * 100.0 + 0.5) / 100.0


def label(name: str) -> str:
    """gfalibs output(): '<label>: ' (note the trailing space — the
    '+++Alignment summary+++: ' header line really ends in ': ')."""
    return name + ": "


class CoutState:
    """Process-global model of std::cout's float formatting mode."""

    def __init__(self) -> None:
        self.fixed2 = False  # std::fixed << std::setprecision(2) active?

    def set_fixed2(self) -> None:
        self.fixed2 = True

    def reset(self) -> None:
        self.fixed2 = False

    def fmt(self, value: float) -> str:
        """Format a double the way `std::cout << value` would right now."""
        if isinstance(value, float) and math.isnan(value):
            return "nan"
        if self.fixed2:
            return f"{value:.2f}"
        # C++ default: general format, 6 significant digits, no trailing zeros.
        s = f"{value:.6g}"
        return s

    def fmt_rounded(self, value: float) -> str:
        """gfa_round then print (the reference's pattern for averages)."""
        return self.fmt(gfa_round(value))


# The single process-wide instance (mirrors the one std::cout).
cout = CoutState()
