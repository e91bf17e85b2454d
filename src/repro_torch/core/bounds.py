"""Paper §4/§5 analysis: the loss upper bound G(K), its lazy-client variant,
and the optimal number of integrated rounds K*.

Equations (numbers follow the paper):
  (3)  tau = floor((t_sum/K - beta) / alpha)
  (4)  G(K) = 1 / g(K),
       g(K) = gamma*eta*phi - [ (delta*xi*K/L)(lambda^(gamma/K) - 1)
                                - eta*xi*delta*gamma ] / eps^2
       lambda = eta*L + 1,  gamma = (t_sum - K*beta)/alpha  (= K*tau)
  (6)  K* = t_sum / sqrt(2*alpha*beta/(eta*L) + alpha*beta + beta^2)
  (8)  lazy bound: g_lazy(K) = g(K) - (K*xi/eps^2) * (M/N*theta + sqrt(M)/N*sigma^2)

The proofs set eps^2 = delta*xi/phi (Appendix C); we default to that choice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoundParams:
    """Learning-theoretic constants of Theorem 1."""
    eta: float            # learning rate (eta * L < 1 required)
    L: float              # smoothness
    xi: float             # Lipschitz constant of F_i
    delta: float          # gradient divergence (Definition 1)
    alpha: float          # training time per local iteration
    beta: float           # mining time per block
    t_sum: float          # total computing-time budget
    w0_dist: float = 1.0  # ||w^0 - w*||_2
    eps2: Optional[float] = None  # eps^2; None => delta*xi/phi (Appendix C)

    @property
    def phi(self) -> float:
        return (1.0 - self.eta * self.L / 2.0) / self.w0_dist

    @property
    def epsilon2(self) -> float:
        if self.eps2 is not None:
            return self.eps2
        return self.delta * self.xi / self.phi

    @property
    def lam(self) -> float:
        return self.eta * self.L + 1.0


def gamma(p: BoundParams, K: float) -> float:
    """Total local iterations K*tau (continuous relaxation of eq. 3)."""
    return (p.t_sum - K * p.beta) / p.alpha


def g_of_k(p: BoundParams, K: float, *, M: int = 0, N: int = 1,
           theta: float = 0.0, sigma2: float = 0.0) -> float:
    """Denominator g(K) of the bound; the bound is 1/g when g > 0.

    With M > 0 this is L(K) of Appendix G (lazy clients, eq. 38).
    """
    gam = gamma(p, K)
    if gam <= 0 or K <= 0:
        return float("-inf")
    lam_pow = p.lam ** (gam / K)
    h_term = (p.delta * p.xi * K / p.L) * (lam_pow - 1.0) - p.eta * p.xi * p.delta * gam
    g = gam * p.eta * p.phi - h_term / p.epsilon2
    if M > 0:
        g -= (K * p.xi / p.epsilon2) * (M / N * theta + math.sqrt(M) / N * sigma2)
    return g


def loss_bound(p: BoundParams, K: int, **lazy) -> float:
    """G(K) (eq. 4) or lazy G~(K) (eq. 8). +inf when the bound is vacuous."""
    g = g_of_k(p, K, **lazy)
    if g <= 0:
        return float("inf")
    return 1.0 / g


def k_star_closed_form(p: BoundParams) -> float:
    """Theorem 3, eq. (6) — valid when eta*L*gamma/K << 1."""
    return p.t_sum / math.sqrt(
        2.0 * p.alpha * p.beta / (p.eta * p.L) + p.alpha * p.beta + p.beta ** 2)


def k_star_numeric(p: BoundParams, *, k_max: Optional[int] = None,
                   M: int = 0, N: int = 1, theta: float = 0.0,
                   sigma2: float = 0.0) -> int:
    """Integer argmin of the bound over feasible K (tau >= 1)."""
    if k_max is None:
        k_max = int(p.t_sum / (p.alpha + p.beta))  # need tau >= 1
    k_max = max(k_max, 1)
    best_k, best_v = 1, float("inf")
    for k in range(1, k_max + 1):
        if gamma(p, k) / k < 1.0:   # tau < 1: infeasible
            continue
        v = loss_bound(p, k, M=M, N=N, theta=theta, sigma2=sigma2)
        if v < best_v:
            best_k, best_v = k, v
    return best_k


def _finite_runs(vs):
    """Maximal contiguous runs of finite values (each a list)."""
    runs, cur = [], []
    for v in vs:
        if math.isfinite(v):
            cur.append(v)
        elif cur:
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    return runs


def is_convex_in_k(p: BoundParams, *, k_max: Optional[int] = None, **lazy) -> bool:
    """Empirical convexity check of G(K) on the feasible grid (Theorem 2).

    Vacuous bounds (``G = +inf`` where ``g <= 0``) punch holes in the grid;
    a second difference is only meaningful between ADJACENT feasible Ks, so
    convexity is checked per contiguous finite window. (Filtering the
    non-finite values out first and diffing the concatenation — the old
    behavior — compares Ks across a vacuous gap and mis-reports convexity
    near the feasibility boundary.)"""
    if k_max is None:
        k_max = int(p.t_sum / (p.alpha + p.beta))
    ks = [k for k in range(1, max(k_max, 3) + 1) if gamma(p, k) / k >= 1.0]
    vs = [loss_bound(p, k, **lazy) for k in ks]
    for run in _finite_runs(vs):
        if len(run) < 3:
            continue
        d2 = np.diff(run, 2)
        if not np.all(d2 >= -1e-9 * np.maximum(1.0, np.abs(run[1:-1]))):
            return False
    return True


def estimate_constants(loss_curve, grad_norms=None) -> dict:
    """Crude empirical (L, xi, delta) estimates from observed training — used
    by benchmarks to instantiate the bound against experiments (§7).

    With ``grad_norms`` (per-round gradient-norm observations ``g_t``) the
    estimates use the gradients directly: ``xi`` — the Lipschitz constant of
    F, i.e. a gradient-norm bound — is ``max_t g_t``, and smoothness L comes
    from gradient increments along the GD path: one step moves the iterate
    by ``eta * g_t`` and the loss by ``|Delta l_t| ~= eta * g_t^2``, so
    ``|Delta g_t| <= L * eta * g_t`` gives ``L >= |Delta g_t| * g_t /
    |Delta l_t|`` with the unknown ``eta`` cancelling. Without
    ``grad_norms`` (or with a degenerate curve) it falls back to the
    loss-curve heuristic."""
    losses = np.asarray(loss_curve, dtype=np.float64)
    dl = np.abs(np.diff(losses))
    delta = float(np.std(losses)) if losses.size > 1 else 0.1
    g = (np.asarray(grad_norms, dtype=np.float64).ravel()
         if grad_norms is not None else np.zeros(0))
    if g.size >= 2:
        xi = float(np.max(np.abs(g)))
        dg = np.abs(np.diff(g))
        n = min(dg.size, dl.size)
        # only form the ratio on rounds where the loss actually moved —
        # a plateau round (dl ~ 0) with a nonzero gradient change would
        # otherwise explode the max
        scale = float(np.max(np.abs(losses))) if losses.size else 1.0
        moved = dl[:n] > 1e-9 * max(1.0, scale)
        ratios = dg[:n][moved] * np.abs(g[:n][moved]) / dl[:n][moved]
        ratios = ratios[np.isfinite(ratios) & (ratios > 0)]
        L = float(np.max(ratios)) if ratios.size else 2.0 * xi
    else:
        xi = float(np.max(dl)) if dl.size else 1.0
        L = 2.0 * xi
    return {"L": max(L, 1e-3), "xi": max(xi, 1e-3), "delta": max(delta, 1e-3)}
