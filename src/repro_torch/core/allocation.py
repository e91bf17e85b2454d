"""Computing-resource allocation model (paper §3.2).

Every client has the same compute f; a learning task must finish within
t_sum. Each integrated round spends tau*alpha on local training and beta on
mining (eq. 1-3). The allocator turns (t_sum, K, alpha, beta) into a feasible
schedule and exposes the K-vs-tau tradeoff that §4 optimizes.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core import bounds


def tau_from_budget(t_sum: float, K: int, alpha: float, beta: float) -> int:
    """Eq. (3): tau = floor((t_sum/K - beta)/alpha)."""
    if K <= 0:
        raise ValueError("K must be positive")
    tau = int((t_sum / K - beta) / alpha)
    return max(tau, 0)


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    K: int
    tau: int
    alpha: float
    beta: float
    t_sum: float

    @property
    def train_time(self) -> float:
        return self.K * self.tau * self.alpha

    @property
    def mine_time(self) -> float:
        return self.K * self.beta

    @property
    def slack(self) -> float:
        """Leftover time (ignored by the paper's analysis; must be >= 0)."""
        return self.t_sum - self.train_time - self.mine_time

    @property
    def feasible(self) -> bool:
        return self.tau >= 1 and self.slack >= -1e-9


def plan(t_sum: float, K: int, alpha: float, beta: float) -> AllocationPlan:
    return AllocationPlan(K=K, tau=tau_from_budget(t_sum, K, alpha, beta),
                          alpha=alpha, beta=beta, t_sum=t_sum)


def feasible_rounds(t_sum: float, alpha: float, beta: float) -> List[int]:
    """All K with tau >= 1."""
    k_max = int(t_sum / (alpha + beta))
    return [k for k in range(1, k_max + 1)
            if tau_from_budget(t_sum, k, alpha, beta) >= 1]


def optimal_plan(p: bounds.BoundParams, **lazy) -> AllocationPlan:
    """Plan at the bound-minimizing K (Theorem 3 numeric form)."""
    k = bounds.k_star_numeric(p, **lazy)
    return plan(p.t_sum, k, p.alpha, p.beta)


def mining_iterations(beta: float, hash_rate: float = 1024.0) -> int:
    """Calibrate the simulated PoW: beta time-units -> hash attempts."""
    return max(int(beta * hash_rate), 1)
