"""Terminal-cylinder radius in degrees (paper §III.B).

Only the constant the process phase needs: a segment whose first point
lies within :data:`RADIUS_DEG` of an aerodrome takes its airspace class.
Bounding-box query generation is not part of the port yet.
"""

from __future__ import annotations

from repro_torch.geometry.aerodromes import NM_TO_M, TERMINAL_RADIUS_NM

# 8 nm in latitude degrees: 8 * 1852 m / 111,111 m/deg.
RADIUS_DEG = TERMINAL_RADIUS_NM * NM_TO_M / 111_111.0
