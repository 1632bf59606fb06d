"""Compute ops: small-matrix numerics shared by the detector and solver."""
