"""Compression core: projections, calibration, specs, registry, AWP and the
model-level driver."""
