"""Distributed optimizer and training-step builders."""
