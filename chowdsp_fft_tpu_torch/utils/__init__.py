"""Utilities of the port: native planner bindings, profiling helpers, the
H100 roofline calculator."""

from . import native, profiling, roofline  # noqa: F401
