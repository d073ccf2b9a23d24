"""The port's numpy oracle: ``raster_cpu`` (geometry, visibility and full
frames), ``scalar_ref`` (per-pixel loops for tiny scenes) and their numpy
spec formulas and shade path (``specmath_np``, ``shade_np``).  Imports
neither jax nor the port's torch code."""

from .raster_cpu import geometry_oracle, visibility_oracle, render_oracle  # noqa: F401
