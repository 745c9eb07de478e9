"""The benchmark of lagomorph_tpu_torch's atlas builder (``run.py``)."""
