"""Model zoo of the port: the BASELINE configurations' models (the standard
normal of config 1, Neal's funnel of config 2, the logistic regression of
config 3, eight schools of config 4, stochastic volatility of config 5),
the multivariate normal with a dense covariance, and the bijectors for
constrained parameters."""

from .base import Model
from .eight_schools import eight_schools
from .funnel import funnel, funnel_nc
from .gaussian import diag_normal, mvn, std_normal
from .logistic import logistic_regression, synthetic_data
from .stoch_vol import stoch_vol, synthetic_returns
from .transforms import (Bijector, identity, interval, lower_bounded,
                         positive, simplex, transformed_model)

__all__ = ["Model", "diag_normal", "eight_schools", "funnel", "funnel_nc",
           "logistic_regression", "mvn", "std_normal", "stoch_vol",
           "synthetic_data", "synthetic_returns",
           "Bijector", "identity", "interval", "lower_bounded", "positive",
           "simplex", "transformed_model"]
