"""The script harness of the port (counterparts of the repository's
``scripts/results.py``, ``scripts/scaling.py`` and ``scripts/plots.py``),
each run as ``python -m spmv_scpa_tpu_torch.scripts.<name>``."""
