"""gemm_ms_per_round (ms): device milliseconds a round in cuBLAS's matrix
products (kernels named gemm, and cuBLAS's split-K reduction). Layer:
local training (``rounds.make_local_train`` -> ``registry.client_losses``
-> ``transformer.train_loss``) and the global-loss forward."""
GEMM = r"gemm|Gemm|GEMM|splitKreduce"


def read(r):
    if r.device is None or not r.rounds:
        return None
    seconds = r.device.seconds(GEMM)
    return 1e3 * seconds / r.rounds if seconds else None
