"""MCMC diagnostics: split R-hat, bulk ESS, EBFMI and tree-statistics
summaries.

The port's counterpart of ``inplacedhmc_tpu/diagnostics.py``; R-hat and ESS
run in torch on the draws' device (FFT autocovariances), the summary on the
host; :func:`split_rhat_from_moments` takes the split-chain moments a run
collects (``collect_moments``) instead of its draws.  Not ported yet: the
sketch-based estimators, rank R-hat, tail ESS, utilization telemetry and
the trajectory explorers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.state import Termination, TreeStats

ACCEPTANCE_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


def ebfmi(energies: torch.Tensor) -> torch.Tensor:
    """Energy Bayesian fraction of missing information,
    ``mean(diff(E)^2) / var(E)`` per chain.  ``energies``: [N] or [N, C]."""
    d = torch.diff(energies, dim=0)
    return torch.mean(d * d, dim=0) / torch.var(energies, dim=0,
                                                 correction=0)


@dataclasses.dataclass
class TreeStatisticsSummary:
    n: int
    acceptance_mean: float
    acceptance_quantiles: Dict[float, float]
    termination_counts: Dict[str, int]
    depth_counts: Dict[int, int]

    def __str__(self):
        qs = " ".join(f"{v:.2f}" for v in self.acceptance_quantiles.values())
        term = ", ".join(f"{k} => {round(100 * v / self.n)}%"
                         for k, v in sorted(self.termination_counts.items()))
        depth = ", ".join(f"{k} => {round(100 * v / self.n)}%"
                          for k, v in sorted(self.depth_counts.items()))
        return (f"Hamiltonian Monte Carlo sample of length {self.n}\n"
                f"  acceptance rate mean: {self.acceptance_mean:.2f}, "
                f"5/25/50/75/95%: {qs}\n"
                f"  termination: {term}\n"
                f"  depth: {depth}")


def summarize_tree_statistics(stats: TreeStats) -> TreeStatisticsSummary:
    """Acceptance quantiles and termination and depth histograms."""
    acc = stats.acceptance_rate.detach().cpu().double().numpy().ravel()
    term = stats.termination.cpu().numpy().ravel()
    depth = stats.depth.cpu().numpy().ravel()
    depths, counts = np.unique(depth, return_counts=True)
    return TreeStatisticsSummary(
        n=acc.size,
        acceptance_mean=float(acc.mean()),
        acceptance_quantiles={q: float(np.quantile(acc, q))
                              for q in ACCEPTANCE_QUANTILES},
        termination_counts={
            "max_depth": int(np.sum(term == Termination.MAX_DEPTH)),
            "divergence": int(np.sum(term == Termination.DIVERGENCE)),
            "turning": int(np.sum(term == Termination.TURNING)),
        },
        depth_counts={int(d): int(c) for d, c in zip(depths, counts)},
    )


def _split_halves(draws: torch.Tensor) -> torch.Tensor:
    """``[N, C, D]`` -> ``[N//2, 2C, D]``: each chain split in two."""
    half = draws.shape[0] // 2
    return torch.cat([draws[:half], draws[half:2 * half]], dim=1)


def split_rhat(draws: torch.Tensor) -> torch.Tensor:
    """Split R-hat (Vehtari et al. 2021).  ``draws``: [N, C, D] -> [D]."""
    x = _split_halves(draws)
    half = x.shape[0]
    w = torch.mean(torch.var(x, dim=0, correction=1), dim=0)
    b = half * torch.var(torch.mean(x, dim=0), dim=0, correction=1)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / w)


def split_rhat_from_moments(mom) -> torch.Tensor:
    """Split R-hat from the split-chain moments of a sampling run
    (``adapt/warmup.py::SplitMoments``, ``MCMCResult.sample_moments``): the
    statistic of :func:`split_rhat` over every coordinate, each chain's two
    halves as two sequences, in O(C D) memory.  The sums are centred per
    chain on ``qref``, which enters the means (R-hat is invariant under one
    shift per coordinate, not one per chain).  Halves that differ by one
    draw (an odd total: the second half takes it) use the mean half length.
    NaN while the second half holds fewer than two draws.  ``[D]``."""
    cnt = torch.clamp(mom.cnt, min=2.0)[:, None, None]     # [2, 1, 1]
    mean = mom.qref[None] + mom.s1 / cnt                   # [2, C, D]
    var = torch.clamp((mom.s2 - mom.s1 * mom.s1 / cnt) / (cnt - 1.0),
                      min=0.0)
    nbar = torch.mean(torch.clamp(mom.cnt, min=2.0))
    d = mean.shape[-1]
    w = torch.mean(var.reshape(-1, d), dim=0)
    b = nbar * torch.var(mean.reshape(-1, d), dim=0, correction=1)
    var_plus = (nbar - 1.0) / nbar * w + b / nbar
    rhat = torch.sqrt(var_plus / w)
    return torch.where(mom.cnt[1] > 1.0, rhat,
                       torch.full_like(rhat, float("nan")))


def _autocov_fft(x: torch.Tensor) -> torch.Tensor:
    """Autocovariance along axis 0 via a zero-padded FFT, divided by N."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    f = torch.fft.rfft(xc, 2 * n, dim=0)
    return torch.fft.irfft(f * torch.conj(f), 2 * n, dim=0)[:n] / n


def _geyer_tau(rho: torch.Tensor) -> torch.Tensor:
    """Integrated autocorrelation time from combined autocorrelations
    ``rho`` [L, D]: Geyer pair sums truncated at the first non-positive pair
    and made non-increasing (the initial monotone sequence)."""
    l, d = rho.shape
    n_pairs = l // 2
    p = rho[: 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)
    pos = torch.cumprod((p > 0).to(torch.int64), dim=0).bool()
    p = torch.where(pos, p, torch.zeros_like(p))
    p = torch.cummin(p, dim=0).values
    p = torch.clamp(p, min=0.0)
    return torch.clamp(-1.0 + 2.0 * torch.sum(p, dim=0), min=1e-8)


def _rank_normalize(draws: torch.Tensor) -> torch.Tensor:
    """Ranks over all chains -> Blom offsets -> inverse normal CDF.  Ties
    rank in order of appearance (stable sorts, as ``jnp.argsort``)."""
    n, c, d = draws.shape
    flat = draws.reshape(n * c, d)
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).to(draws.dtype) + 1.0
    frac = (ranks - 0.375) / (n * c + 0.25)
    return torch.special.ndtri(frac).reshape(n, c, d)


def ess_bulk(draws: torch.Tensor, cap: bool = True,
             rank_normalize: bool = False) -> torch.Tensor:
    """Effective sample size over split chains (Geyer initial monotone
    sequence).  ``draws``: [N, C, D] -> [D].  ``cap`` clips at the draw
    count; ``rank_normalize`` gives Stan's rank-normalized bulk ESS."""
    if rank_normalize:
        draws = _rank_normalize(draws)
    x = _split_halves(draws)
    half, m = x.shape[0], x.shape[1]
    acov = _autocov_fft(x)                       # [half, 2C, D]
    chain_var = acov[0] * half / (half - 1)
    w = torch.mean(chain_var, dim=0)
    b = half * torch.var(torch.mean(x, dim=0), dim=0, correction=1)
    var_plus = (half - 1) / half * w + b / half
    rho = 1.0 - (w[None] - torch.mean(acov, dim=1)) / var_plus[None]
    total = float(m * half)
    ess = total / _geyer_tau(rho)
    return torch.clamp(ess, max=total) if cap else ess
