"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): the
paper's Algorithm-1 fit timed on the H100, checked against a plain
reference. ``run.py`` is the entry point; ``BENCHMARK.json`` at the root of
the repository names the cells."""
