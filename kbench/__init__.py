"""The benchmark of ``krylov_tpu_torch`` on the card (see ``run.py``)."""
