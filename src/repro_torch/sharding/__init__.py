"""Layouts of the client-sharded engine (``plans.py``)."""
