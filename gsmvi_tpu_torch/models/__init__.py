"""Target zoo of the port: the Gaussian family, the analytic non-Gaussian
targets (funnel, banana, Student-t), the Gaussian mixture and the Bayesian
logistic-regression posterior, each with its score as a kernel pair
(``Target.fused_score``); ``numpyro_compat.from_distribution`` wraps any
object with a ``log_prob``."""

from .banana import banana
from .base import Target, make_target
from .funnel import funnel
from .gaussian import (dense_gaussian, gaussian_target_from_arrays,
                       ill_conditioned_gaussian)
from .mixture import gaussian_mixture, gaussian_mixture_from_arrays
from .regression import logistic_regression, logistic_regression_from_arrays
from .student_t import student_t, student_t_from_arrays

__all__ = ["Target", "banana", "dense_gaussian", "funnel",
           "gaussian_mixture", "gaussian_mixture_from_arrays",
           "gaussian_target_from_arrays", "ill_conditioned_gaussian",
           "logistic_regression", "logistic_regression_from_arrays",
           "make_target", "student_t", "student_t_from_arrays"]
