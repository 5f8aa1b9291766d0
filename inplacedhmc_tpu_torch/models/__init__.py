"""Model zoo of the port: so far the logistic-regression model of BASELINE
config 3."""

from .base import Model
from .logistic import logistic_regression, synthetic_data

__all__ = ["Model", "logistic_regression", "synthetic_data"]
