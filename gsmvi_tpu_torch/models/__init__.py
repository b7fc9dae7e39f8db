"""Target zoo of the port: the Gaussian family and the analytic
non-Gaussian targets (funnel, banana, Student-t), each with its score as a
kernel pair (``Target.fused_score``)."""

from .banana import banana
from .base import Target, make_target
from .funnel import funnel
from .gaussian import (dense_gaussian, gaussian_target_from_arrays,
                       ill_conditioned_gaussian)
from .student_t import student_t, student_t_from_arrays

__all__ = ["Target", "banana", "dense_gaussian", "funnel",
           "gaussian_target_from_arrays", "ill_conditioned_gaussian",
           "make_target", "student_t", "student_t_from_arrays"]
