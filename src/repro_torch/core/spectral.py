"""Spectral-gap diagnostics for mixing topologies and schedules.

After the Steps 2+5 mix the clients' disagreement (the divergence of
Definition 1) contracts by ``|lambda_2(W)|`` per round, so the gap
``1 - |lambda_2(W)|`` connects a topology to the paper's bound. For a
schedule the ergodic gap ``1 - |lambda_2(W_{T-1} ... W_0)|^(1/T)`` is the
per-round rate of the product matrix.

Host-side numpy, a copy of the JAX package's ``core/spectral.py``. Where
the reference replays a run's PRNG keys, these functions take the run's
own matrices (``matrices``: the ``topology.round_table`` it mixed with).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import topology as topology_lib


def _densify(w) -> np.ndarray:
    """A dense matrix, or a ``topology.SparseLowering`` densified under its
    small-C guard."""
    if isinstance(w, topology_lib.SparseLowering):
        return np.asarray(w.to_dense(), np.float64)
    return np.asarray(w, np.float64)


def lambda2_modulus(w) -> float:
    """|lambda_2|: the second-largest eigenvalue modulus of a mixing matrix.

    >>> round(lambda2_modulus(np.full((4, 4), 0.25)), 6)
    0.0
    """
    w = _densify(w)
    if w.shape[0] < 2:
        return 0.0
    mags = np.sort(np.abs(np.linalg.eigvals(w)))[::-1]
    return float(mags[1])


def spectral_gap(w) -> float:
    """``1 - |lambda_2(W)|``, clipped to [0, 1].

    >>> from repro_torch.core import topology
    >>> round(spectral_gap(topology.FullMesh().matrix(6)), 6)
    1.0
    """
    return float(np.clip(1.0 - lambda2_modulus(w), 0.0, 1.0))


def cluster_spectral_gap(n_clusters: int, inter_weight: float, *,
                         cluster_size: int = 1) -> float:
    """Closed-form ``spectral_gap`` of ``topology.ClusterTopology``: the
    cluster-ring circulant contributes ``(1 - a) + a cos(2 pi k / G)``,
    the in-cluster mean zeros.

    >>> round(cluster_spectral_gap(8, 0.3), 6)
    0.087868
    """
    g = int(n_clusters)
    a = float(inter_weight)
    mags = [abs((1.0 - a) + a * np.cos(2.0 * np.pi * k / g))
            for k in range(1, g)]
    if cluster_size > 1:
        mags.append(0.0)
    if not mags:
        return 1.0
    return float(np.clip(1.0 - max(mags), 0.0, 1.0))


def round_matrices(topo, n_clients: int, n_rounds: int, *,
                   matrices=None) -> List[np.ndarray]:
    """The mixing matrices of rounds ``0..n_rounds-1`` as host arrays.

    ``matrices`` is the run's ``[M, C, C]`` table (round ``t`` mixes with
    ``matrices[t % M]``, as ``rounds.run_blade_fl`` reads it); a stochastic
    topology needs it, a deterministic one builds its own phase table.
    ``topo`` may also be a raw ``topology.SparseLowering``."""
    k = int(n_rounds)
    if isinstance(topo, topology_lib.SparseLowering):
        if topo.n_clients != n_clients:
            raise ValueError(
                f"SparseLowering has n_clients={topo.n_clients}, the report "
                f"asks for {n_clients}")
        return [topo.to_dense().astype(np.float64)] * k
    if matrices is not None:
        table = np.asarray(matrices)
        if table.ndim != 3 or table.shape[1:] != (n_clients, n_clients) \
                or not len(table):
            raise ValueError(f"matrices of shape {table.shape}, expected "
                             f"[M, {n_clients}, {n_clients}]")
    elif topo.stochastic:
        raise ValueError(f"{type(topo).__name__} is stochastic: pass the "
                         "run's matrices")
    else:
        table = topology_lib.round_table(topo, n_clients, k)
    return [np.asarray(table[t % len(table)]) for t in range(k)]


def per_round_gaps(topo, n_clients: int, n_rounds: int, *,
                   matrices=None) -> np.ndarray:
    """``spectral_gap(W_t)`` for each round ``t``."""
    return np.array([spectral_gap(w) for w in round_matrices(
        topo, n_clients, n_rounds, matrices=matrices)])


def _ergodic_gap_of(ws) -> float:
    """Per-round gap of a concrete matrix sequence's product."""
    prod = np.eye(ws[0].shape[0], dtype=np.float64)
    for w in ws:
        prod = np.asarray(w, np.float64) @ prod
    lam2 = lambda2_modulus(prod)
    # the 1/T-th root amplifies eigensolver noise; treat fp-noise-scale
    # values as the exact rank-one product
    lam = 0.0 if lam2 < 1e-12 else lam2 ** (1.0 / len(ws))
    return float(np.clip(1.0 - lam, 0.0, 1.0))


def ergodic_gap(topo, n_clients: int, *, n_rounds: Optional[int] = None,
                matrices=None) -> float:
    """Per-round gap of the product matrix over ``n_rounds`` (default: one
    schedule period, 1 for static topologies).

    >>> from repro_torch.core import topology
    >>> one = spectral_gap(topology.PairShift(1).matrix(8))
    >>> ergodic_gap(topology.GossipRotation(), 8) > one
    True
    """
    if n_rounds is None:
        n_rounds = (topo.period(n_clients)
                    if isinstance(topo, topology_lib.Schedule) else 1)
    return _ergodic_gap_of(round_matrices(topo, n_clients, n_rounds,
                                          matrices=matrices))


def gap_report(topo, n_clients: int, n_rounds: int, *,
               matrices=None) -> dict:
    """Run-level spectral summary: per-round gaps and the ergodic gap.

    >>> from repro_torch.core import topology
    >>> r = gap_report(topology.FullMesh(), 6, 2)
    >>> round(r['predicted_consensus_rate'], 6)
    0.0
    """
    ws = round_matrices(topo, n_clients, n_rounds, matrices=matrices)
    gaps = np.array([spectral_gap(w) for w in ws])
    erg = _ergodic_gap_of(ws)
    return {
        "gap_per_round": [float(g) for g in gaps],
        "gap_min": float(gaps.min()),
        "gap_mean": float(gaps.mean()),
        "ergodic_gap": erg,
        "predicted_consensus_rate": float(1.0 - erg),
    }
