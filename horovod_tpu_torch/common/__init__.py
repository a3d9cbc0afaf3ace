"""Types shared across the port."""
