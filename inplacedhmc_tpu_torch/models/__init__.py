"""Model zoo of the port: the logistic-regression model of BASELINE config 3
and the Gaussian targets of config 1."""

from .base import Model
from .gaussian import diag_normal, std_normal
from .logistic import logistic_regression, synthetic_data

__all__ = ["Model", "diag_normal", "logistic_regression", "std_normal",
           "synthetic_data"]
