"""Priors, fixed-grid ODE integrators and the sampling CLI of the port."""
