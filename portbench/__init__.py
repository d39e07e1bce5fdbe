"""The benchmark of ``andix_torch``: a cell a run, as ``BENCHMARK.json``
sets it out."""
