"""Compatibility layer: the zero-dependency numpy GSM of the reference
GSM-VI's ``gsm_numpy.py`` surface (int-seed ``fit``, numpy in and out), the
port's copy of ``gsmvi_tpu/compat``."""

from .gsm_numpy import GSM, gsm_update
