"""Utilities of the port: native planner bindings, profiling helpers, the
H100 roofline calculator, the spans at the layer boundaries."""

from . import native, profiling, roofline, tracing  # noqa: F401
