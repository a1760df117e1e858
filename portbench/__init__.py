"""The benchmark of the PyTorch and CUDA port, ``kmer_denovo_filter_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a configuration in ``configs/<name>.json``,
a traffic mix in ``traffic/<name>.json`` that names its drive
(``drives/<drive>.py``) and that drive's plain reference
(``reference/<drive>.py``), and a per-layer metric in
``metrics/<name>.py``.  A later cell, mix, drive or metric is a new file
and a new entry; no file here needs an edit for it.
"""
