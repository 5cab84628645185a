"""Numerical ops: ODE solvers, the trajectory loop and the hand-written kernels."""
