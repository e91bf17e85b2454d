"""Batched serving example on the PyTorch/CUDA port: prefill + KV-cache
greedy decode (``examples/serve_decode.py`` over the port's
``repro_torch.launch.serve``), with the same defaults: DeepSeek-V2 (MLA
attention, MoE MLPs) at its smoke size, 4 prompts of 32 tokens, 16 new
tokens each. ``--size one-h100`` serves the published widths on one 80 GB
H100 (DeepSeek-V2 cut to 4 layers, 13.14 G parameters; xlstm-125m and
paligemma-3b whole). ``--arch`` takes any decoder of the zoo; an
encoder-only one (hubert-xlarge) exits as the reference's does. On the
GPU by default.

  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
  PYTHONPATH=src python examples/torch_serve_decode.py --arch xlstm-125m \\
      --device cpu
  PYTHONPATH=src python examples/torch_serve_decode.py --size one-h100 \\
      --prompt-len 2048 --gen 32
  PYTHONPATH=src python examples/torch_serve_decode.py --arch paligemma-3b \\
      --size one-h100 --prompt-len 2048 --gen 32
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import SIZES, serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-236b")
    ap.add_argument("--size", choices=SIZES, default="smoke")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()
