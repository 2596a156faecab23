"""Utilities of the port: the H100 roofline calculator."""
