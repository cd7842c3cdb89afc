"""Evaluation helpers of the port (no training yet)."""
