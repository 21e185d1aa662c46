"""The benchmark of repro_torch, the PyTorch and CUDA port (see PERF.md)."""
