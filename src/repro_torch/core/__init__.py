"""The integrated round and its parts (paper §3.1): mining, the ledger,
aggregation, lazy clients, DP, bounds and allocation. Import submodules
directly (``from repro_torch.core import rounds``)."""
