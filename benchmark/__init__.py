"""The benchmark of ``acmgnn_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m benchmark.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (``manifest.py``).  The yardstick lives here:
the graph draws (``graphs.py``), the inputs made from the seed
(``inputs.py``), the profiler reduction and kernel groups (``trace.py``),
the table of peaks (``peaks.py``), the operation and byte counts
(``countlib.py``, ``counts/``), the plain reference (``reference/``) and
the comparison that decides ``correct`` (``check.py``).  From the program
the benchmark takes only its public calls, counters and kernel names.
"""
