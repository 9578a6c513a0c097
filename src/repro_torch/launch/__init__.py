"""Command-line entry points: ``python -m repro_torch.launch.compress`` and
``python -m repro_torch.launch.serve``."""
