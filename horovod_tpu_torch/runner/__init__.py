"""Launcher helpers: the port of ``horovod_tpu/runner`` (so far the
rendezvous KV client, its request signing, and the NIC address lookup)."""
