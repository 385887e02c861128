"""Acquisition strategies: the Strategy engine and the samplers the port
carries so far (Random, BalancedRandom, Margin, Confidence); the others
are still to be ported (ROADMAP.md)."""

from ..registry import STRATEGIES
from .base import Strategy, register_strategy  # noqa: F401

# Importing a sampler module registers its classes.
from . import random_sampler as _random_sampler  # noqa: F401
from . import uncertainty as _uncertainty  # noqa: F401


def get_strategy(name: str):
    return STRATEGIES.get(name)
