"""Experiment scripts of the port: the counterparts of the JAX package's
``scripts/x_fused.py`` and ``scripts/x_join_variants.py``, run on the
card (or with ``--device cpu`` on the host)::

    python -m kmer_denovo_filter_tpu_torch.experiments.x_fused CMD
    python -m kmer_denovo_filter_tpu_torch.experiments.x_join_variants CMD

Each prints labelled lines as the JAX scripts do; every parity line
asserts.  Importing a script runs nothing.
"""
