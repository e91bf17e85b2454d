"""Models of the port: the paper's MLP (``mlp.py``), the LM zoo's serving
path (``transformer.py`` over ``attention.py`` and ``ssm.py``, init in
``registry.py``) and their building blocks (``layers.py``)."""
