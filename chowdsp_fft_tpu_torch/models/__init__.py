"""End-to-end DSP pipelines built from the port's layers."""

from .sdr import SDRChain, SDRChainConfig  # noqa: F401
