"""Ops of the port: plain tensor functions and the hand-written kernels."""
