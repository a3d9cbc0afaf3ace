"""Data-plane integrity: the port of ``horovod_tpu/integrity`` (so far the
non-finite gradient guard)."""
