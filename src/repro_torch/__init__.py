"""PyTorch/CUDA port of the AWP reproduction (``src/repro`` is the JAX
reference it is tested against).

Module names mirror ``repro``: each file here has a twin of the same
path under ``src/repro``. The port imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``. Every entry point takes ``device``
(default ``"cuda"``) and raises rather than fall back to the CPU when no
card is present; the tests pass ``device="cpu"`` explicitly.
"""
