"""Benchmark of the PyTorch/CUDA port (lip2speech_tpu_torch): one cell a run,
driven by BENCHMARK.json and the data files beside this package."""
