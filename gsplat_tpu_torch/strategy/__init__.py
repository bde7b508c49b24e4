from .base import Strategy
from .mcmc import MCMCStrategy

__all__ = ["MCMCStrategy", "Strategy"]
