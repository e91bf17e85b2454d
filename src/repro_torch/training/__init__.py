"""Training utilities of the port: metric logging (``metrics.py``)."""
