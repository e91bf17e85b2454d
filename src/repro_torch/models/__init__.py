"""Models of the port: the paper's MLP (``mlp.py``) and its building
blocks (``layers.py``)."""
