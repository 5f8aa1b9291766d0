"""Bayesian logistic regression: BASELINE config 3 (10k observations x 50
features).  The port's counterpart of ``inplacedhmc_tpu/models/logistic.py``;
its potential runs through the fused kernel of ``ops/logistic.py``.
"""

from __future__ import annotations

import math

import torch

from .base import Model


def synthetic_data(seed: int, n_obs: int = 10_000, n_features: int = 50,
                   dtype=torch.float32, device="cuda"):
    """A well-specified synthetic dataset with known coefficients, made on
    ``device`` from ``seed``: the JAX package's recipe (standard normal
    design with a mild mixing, coefficients ``N(0, 0.5^2)``, Bernoulli
    labels), not its random numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=dtype, device=device)
    x = torch.randn((n_obs, n_features), **kw)
    # mild correlation so that the dense metric matters
    mix = 0.3 * torch.randn((n_features, n_features), **kw)
    x = x + x @ mix / math.sqrt(n_features)
    beta_true = torch.randn((n_features,), **kw) * 0.5
    p = torch.sigmoid(x @ beta_true)
    y = (torch.rand((n_obs,), **kw) < p).to(dtype)
    return x, y, beta_true


def logistic_regression(x, y, prior_scale: float = 10.0,
                        device="cuda") -> Model:
    """Posterior over coefficients ``b`` with ``N(0, prior_scale^2)`` priors:
    ``logp(b) = sum_i [y_i eta_i - log(1 + e^eta_i)] - |b|^2 / (2 s^2)`` with
    ``eta = X b``.  ``x`` and ``y`` (tensors or numpy arrays) are placed on
    ``device``; a numpy array becomes float32."""
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device, dtype=x.dtype)
    d = x.shape[1]
    inv_var = 1.0 / (prior_scale * prior_scale)

    def logp(b):
        eta = b @ x.to(b.dtype).transpose(0, 1)
        ll = torch.sum(y.to(b.dtype) * eta - torch.logaddexp(
            torch.zeros_like(eta), eta), dim=-1)
        return ll - 0.5 * inv_var * torch.sum(b * b, dim=-1)

    return Model(name=f"logistic_{x.shape[0]}x{d}", dim=d, logp=logp,
                 structure={"kind": "logistic", "x": x, "y": y,
                            "inv_var": inv_var})
