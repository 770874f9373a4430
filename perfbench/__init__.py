"""The benchmark of ``pycsou_tpu_torch`` (see ``run.py``)."""
