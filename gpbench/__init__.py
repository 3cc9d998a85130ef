"""The benchmark of ``friedrich_tpu_torch`` on one NVIDIA H100: see
``python -m gpbench.run --help`` and ``BENCHMARK.json``."""
