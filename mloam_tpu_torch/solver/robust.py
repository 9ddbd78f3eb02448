"""Robust loss functions as IRLS weights.

HuberLoss used by tracker and window solves, and the Geman-McClure /
graduated-surrogate pair. Counterpart of ``mloam_tpu/solver/robust.py``.

Convention: losses act on the squared residual norm s = ||r||². A factor's
contribution ρ(s) is implemented by scaling residual and Jacobian rows with
sqrt(w(s)), w(s) = ρ'(s) — the standard IRLS correction.
"""

from __future__ import annotations

import torch


def trivial_weight(s: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(s)


def huber_weight(s: torch.Tensor, delta: float) -> torch.Tensor:
    """ρ(s) = s for s <= δ²; 2δ√s − δ² above. w = ρ'(s)."""
    d2 = delta * delta
    sq = torch.sqrt(torch.clamp(s, min=1e-20))
    return torch.where(s <= d2, 1.0, delta / sq)


def geman_mcclure_weight(s: torch.Tensor, c: float) -> torch.Tensor:
    """ρ(s) = c² s / (c² + s); w = ρ'(s) = (c² / (c² + s))²."""
    c2 = c * c
    t = c2 / (c2 + s)
    return t * t


def surrogate_gm_weight(s: torch.Tensor, c: float, mu) -> torch.Tensor:
    """Graduated non-convexity surrogate of Geman-McClure:
    ρ_μ(s) = μ c² s / (μ c² + s); μ→1 recovers GM, large μ approaches L2.
    w = ρ'(s) = (μ c² / (μ c² + s))²."""
    mc2 = mu * c * c
    t = mc2 / (mc2 + s)
    return t * t


def gnc_mu_schedule(mu_init: float, iters: int):
    """Graduated non-convexity schedule compressed to a fixed GN budget:
    geometric from ``mu_init`` down to exactly 1 (the GM limit) on the final
    iteration: μ_i = mu_init^(1 − i/(iters−1)).

    Returns ``sched(i) -> μ`` (a python float for a python iteration index).
    """

    def sched(i):
        if iters <= 1:
            return 1.0
        e = 1.0 - min(float(i), iters - 1) / (iters - 1)
        return max(1.0, float(mu_init) ** e)

    return sched


def loss_weight(s: torch.Tensor, kind: str, delta: float = 0.1,
                gm_c: float = 1.0, gnc_mu=1.0) -> torch.Tensor:
    if kind == "trivial":
        return trivial_weight(s)
    if kind == "huber":
        return huber_weight(s, delta)
    if kind == "gm":
        return geman_mcclure_weight(s, gm_c)
    if kind == "gnc_gm":
        return surrogate_gm_weight(s, gm_c, gnc_mu)
    raise ValueError(f"unknown loss kind: {kind}")
