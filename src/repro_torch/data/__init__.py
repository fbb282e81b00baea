"""Synthetic datasets of the paper's experimental section."""
