"""Version of the horovod_tpu_torch port (the JAX package's release it
ports)."""

__version__ = "0.1.0"
