"""The benchmark of the PyTorch / CUDA port (``run.py`` is its command)."""
