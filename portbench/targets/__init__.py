"""Targets: each module makes its arrays from the run's seed and hands them
to the program (``arrays``, ``program``); the plain score of the same arrays
is ``reference/<target>.py``."""
