"""Model families: what the harness needs to know of one kind of model,
found by the ``family`` a configuration file names
(``families/<family>.py``). A family module gives

  reference            its plain model (``fl_bench/reference``):
                       ``leaf_shapes(widths)`` and ``loss(w, widths,
                       tokens)``
  PORT_LEAVES          each reference leaf's name in the port's flattened
                       parameters
  port_mismatch(cfg, widths)
                       the widths on which the port's ``ModelConfig``
                       differs from the file
  matmul_weights(widths), forward_flops(widths, sequences, seq)
                       the work of one forward pass
  attention_layers(widths)
                       the layers that run the flash kernels
  FORWARD_KERNELS, BACKWARD_KERNELS
                       the kernels each such layer launches once a forward
                       and once a backward pass of one client
"""
import importlib


def load(name: str):
    return importlib.import_module(f"fl_bench.families.{name}")
