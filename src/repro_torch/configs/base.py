"""The paper's experiment configuration (the JAX package's
``configs/base.py::BladeConfig``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BladeConfig:
    """Paper §7 experimental knobs (time normalized by alpha as in the paper)."""
    n_clients: int = 20
    n_lazy: int = 0
    sigma2: float = 0.0          # lazy artificial-noise variance
    t_sum: float = 100.0         # total computing time budget
    alpha: float = 1.0           # training time per local iteration
    beta: float = 10.0           # mining time per block
    eta: float = 0.01            # learning rate
    K: int = 5                   # integrated rounds
    samples_per_client: int = 512
    dirichlet_alpha: float = 0.5 # non-IID-ness
    dp_sigma: float = 0.0        # DP Gaussian mechanism on broadcast models
    seed: int = 0

    @property
    def tau(self) -> int:
        from repro_torch.core.allocation import tau_from_budget
        return tau_from_budget(self.t_sum, self.K, self.alpha, self.beta)
