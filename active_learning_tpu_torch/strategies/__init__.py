"""Acquisition strategies: the Strategy engine and the JAX package's 13
samplers (Random, BalancedRandom, Margin, Confidence, MASE, BASE,
Coreset, BADGE, PartitionedCoreset, PartitionedBADGE, Balancing,
MarginClustering, VAAL)."""

from ..registry import STRATEGIES
from .base import Strategy, register_strategy  # noqa: F401

# Importing a sampler module registers its classes.
from . import balancing as _balancing  # noqa: F401
from . import clustering as _clustering  # noqa: F401
from . import coreset as _coreset  # noqa: F401
from . import mase as _mase  # noqa: F401
from . import random_sampler as _random_sampler  # noqa: F401
from . import uncertainty as _uncertainty  # noqa: F401
from . import vaal as _vaal  # noqa: F401


def get_strategy(name: str):
    return STRATEGIES.get(name)
