"""End-to-end DSP pipelines built from the port's layers."""

from .convolver import ConvolverConfig, MultichannelConvolver  # noqa: F401
from .sdr import SDRChain, SDRChainConfig  # noqa: F401
