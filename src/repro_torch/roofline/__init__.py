"""Analytic rooflines of the port's paths on the H100 (``analysis``)."""
