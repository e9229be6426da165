"""Two-segment colormap normalizer for z-score heatmaps.

Maps [vmin, vcenter] linearly onto [0, 0.5] and [vcenter, vmax] onto
[0.5, 1.0] so the center of a diverging colormap sits at z = vcenter
(used by the metacluster remap GUI's heatmaps)."""

from __future__ import annotations

import numpy as np
from matplotlib.colors import Normalize


class ZScoreNormalize(Normalize):
    """Piecewise-linear Normalize with an explicit center value."""

    def __init__(self, vmin=-3, vcenter=0, vmax=3):
        self.vcenter = vcenter
        super().__init__(vmin, vmax)

    def _breakpoints(self):
        return (np.array([self.vmin, self.vcenter, self.vmax]),
                np.array([0.0, 0.5, 1.0]))

    def __call__(self, value, clip=None):
        data, _ = self.process_value(value)
        xs, ys = self._breakpoints()
        mapped = np.interp(data, xs, ys)
        return np.ma.masked_array(mapped, mask=np.ma.getmask(data))

    def inverse(self, value):
        xs, ys = self._breakpoints()
        return np.interp(value, ys, xs)

    def calibrate(self, values):
        """Symmetric auto-range: center at 0, extent = max |value|.

        NaN-safe: a zero-variance marker z-scores to a NaN column, and a
        plain max would poison vmin/vmax and blank BOTH heatmaps."""
        with np.errstate(all="ignore"):
            top = float(np.nanmax(values)) if np.any(
                ~np.isnan(values)) else 3.0
        if not np.isfinite(top) or top <= 0:
            top = 3.0
        self.vmin = -top
        self.vcenter = 0.0
        self.vmax = top
