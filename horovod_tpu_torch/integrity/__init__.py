"""Data-plane integrity: the port of ``horovod_tpu/integrity`` (the
non-finite gradient guard, ``nonfinite.py``, and the replica-divergence
audit, ``audit.py``)."""
