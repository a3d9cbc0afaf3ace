"""Collectives, compression and the flash-attention kernels."""
