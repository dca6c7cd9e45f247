"""The port's twins of the six scripts under ``examples/``.

Each runs on the CUDA card unless given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.sql_quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.tpch_analytics [--sf 0.01] [--row-engine] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.distributed_groupby [--world N] [--device cpu]

Each module has ``main(argv=None)`` and ``run(...)``, which does the work
at the reference script's sizes and seeds and returns what the script
prints (``"lines"``) beside the results it printed them from.
"""
