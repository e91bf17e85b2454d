"""Byzantine attack stages (beyond the paper: the §5 lazy client is the
mildest point on the adversarial spectrum).

An :class:`Attack` transforms the pre-broadcast params, the full ``[C,
...]`` client-stacked dict every client is about to publish. The adversary
controls the first ``n_attackers`` clients (the first-M convention of
``core/lazy.py``), sees every honest broadcast before choosing its own,
and replaces only its own rows; honest rows pass through untouched.

  :class:`SignFlip`          broadcast ``-scale * w_i``
  :class:`ScaledNoise`       broadcast ``scale * w_i + N(0, sigma2)``
  :class:`ALIE`              "A Little Is Enough": ``mu_honest - z *
                             sd_honest`` per coordinate
  :class:`ModelReplacement`  ``mu + boost * (w_i - mu)`` (boost defaults
                             to C)

``rounds.make_attack`` composes the selected attack right after
``perturb``. Only :class:`ScaledNoise` draws: from the run's CPU generator
(after the round's lazy and DP draws), or from an injected dict of
leaf-shaped standard normals; a run draws all its rounds' noise before
the first (``rounds.draw_noise``) and injects each round's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.lazy import standard_normal

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Attack:
    """Base: which clients the adversary controls. Subclasses implement
    ``apply(full, n_clients, generator=None, noise=None) -> full``."""
    n_attackers: int = 1

    @property
    def active(self) -> bool:
        return self.n_attackers > 0

    @property
    def draws_noise(self) -> bool:
        """Whether :meth:`apply` draws from the generator (a run draws it
        up front: ``rounds.draw_noise``)."""
        return False

    def _validate(self, n_clients: int) -> None:
        if not 0 <= self.n_attackers < n_clients:
            raise ValueError(
                f"n_attackers={self.n_attackers} must leave at least one "
                f"honest client (n_clients={n_clients})")

    def _replace(self, leaf: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
        """``bad`` (leaf-shaped, or one row broadcast) in the attackers'
        rows, ``leaf`` in the honest ones."""
        m = self.n_attackers
        bad = bad.to(leaf.dtype).expand(leaf.shape)
        return torch.cat([bad[:m], leaf[m:]], dim=0)

    def apply(self, full: Tree, n_clients: int,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tree] = None) -> Tree:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SignFlip(Attack):
    """Attacker ``i`` broadcasts ``-scale * w_i``."""
    scale: float = 1.0

    def apply(self, full, n_clients, generator=None, noise=None):
        self._validate(n_clients)
        s = -float(np.float32(self.scale))
        return {k: self._replace(v, v.to(torch.float32) * s)
                for k, v in full.items()}


@dataclasses.dataclass(frozen=True)
class ScaledNoise(Attack):
    """Attacker ``i`` broadcasts ``scale * w_i + N(0, sigma2)``. The noise
    is ``noise[k]`` when given (leaf-shaped standard normals), else drawn
    from ``generator`` leaf by leaf in sorted key order."""
    scale: float = 1.0
    sigma2: float = 1.0

    @property
    def draws_noise(self) -> bool:
        return self.sigma2 > 0.0

    def apply(self, full, n_clients, generator=None, noise=None):
        self._validate(n_clients)
        std = float(self.sigma2) ** 0.5
        s = float(np.float32(self.scale))
        out = {}
        for k in sorted(full):
            leaf = full[k]
            bad = leaf.to(torch.float32) * s
            if std > 0.0:
                z = (noise[k].to(leaf.device, torch.float32)
                     if noise is not None
                     else standard_normal(leaf.shape, generator, leaf.device))
                bad = bad + z * std
            out[k] = self._replace(leaf, bad)
        return out


@dataclasses.dataclass(frozen=True)
class ALIE(Attack):
    """"A Little Is Enough" (Baruch et al.): every attacker broadcasts the
    per-coordinate ``mu_honest - z * sd_honest`` (population std), inside
    the honest variance envelope yet biasing the linear mean."""
    z: float = 1.5

    def apply(self, full, n_clients, generator=None, noise=None):
        self._validate(n_clients)
        m = self.n_attackers
        out = {}
        for k, leaf in full.items():
            honest = leaf[m:].to(torch.float32)
            mu = honest.mean(dim=0)
            sd = honest.std(dim=0, correction=0)
            out[k] = self._replace(leaf, mu - float(np.float32(self.z)) * sd)
        return out


@dataclasses.dataclass(frozen=True)
class ModelReplacement(Attack):
    """Attacker ``i`` broadcasts ``mu_all + boost * (w_i - mu_all)``; the
    default ``boost = C`` makes the linear mean land near its own model."""
    boost: float = 0.0   # 0.0 -> n_clients at apply time

    def apply(self, full, n_clients, generator=None, noise=None):
        self._validate(n_clients)
        boost = float(np.float32(self.boost if self.boost else n_clients))
        out = {}
        for k, leaf in full.items():
            f32 = leaf.to(torch.float32)
            mu = f32.mean(dim=0)
            out[k] = self._replace(leaf, mu + boost * (f32 - mu))
        return out


def from_name(name: str, n_attackers: int = 1) -> Attack:
    """Parse a CLI attack spec: ``signflip[:scale]`` |
    ``noise[:sigma2[:scale]]`` | ``alie[:z]`` | ``replace[:boost]``.

    >>> from_name("signflip", 2)
    SignFlip(n_attackers=2, scale=1.0)
    >>> from_name("alie:1.2").z
    1.2
    """
    head, _, arg = name.strip().lower().partition(":")
    m = int(n_attackers)
    if head in ("signflip", "sign_flip", "sign"):
        return SignFlip(n_attackers=m, scale=float(arg) if arg else 1.0)
    if head in ("noise", "scalednoise", "scaled_noise", "gauss"):
        sigma2, _, scale = arg.partition(":")
        return ScaledNoise(n_attackers=m,
                           sigma2=float(sigma2) if sigma2 else 1.0,
                           scale=float(scale) if scale else 1.0)
    if head == "alie":
        return ALIE(n_attackers=m, z=float(arg) if arg else 1.5)
    if head in ("replace", "replacement", "model_replacement", "boost"):
        return ModelReplacement(n_attackers=m,
                                boost=float(arg) if arg else 0.0)
    raise ValueError(f"unknown attack {name!r} (expected signflip[:scale] | "
                     "noise[:sigma2[:scale]] | alie[:z] | replace[:boost])")
