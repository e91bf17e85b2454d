"""Training utilities of the port: optimizers and schedules
(``optim.py``), the centralized train step (``train_state.py``),
checkpoints in the JAX package's format (``checkpoint.py``) and metric
logging (``metrics.py``)."""
