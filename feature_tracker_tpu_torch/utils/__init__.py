"""Utilities of the port: weight files."""
