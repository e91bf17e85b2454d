"""Synthetic data and client-stacked batches for the port."""
