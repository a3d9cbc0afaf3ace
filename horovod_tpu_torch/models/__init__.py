"""Models of the port and the weight converter."""
