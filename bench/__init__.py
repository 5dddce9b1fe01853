"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the repository root names the cells; each is one
configuration (``configs/<name>.json``, its data made by the frozen
generator ``datagen/<kind>.py``) under one traffic mix
(``traffic/<name>.json``).  ``run.py`` runs one cell; every metric is read
by ``metrics/<name>.py`` (or ``metrics/<name up to its first dot>.py``).
Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``repro``; the
reference (``reference.py``) and the generators import numpy alone.
"""
