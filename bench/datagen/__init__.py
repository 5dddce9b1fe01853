"""Frozen data generators, one module per ``data.kind`` of a configuration.

Each module has ``make(spec, rows, rng) -> reference.Column`` and imports
numpy and the reference alone, so the yardstick does not move when the
port's own generators change.
"""
