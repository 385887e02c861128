"""Fault injection and recovery (the JAX package's ``faults/``).

The deterministic injection registry (``site``/``configure``,
registry.py), the one RetryPolicy with its transient / OOM / fatal
classification (retry.py), the atomic round journal (journal.py), driver
preemption (preempt.py) and the degradation ladder (ladder.py, imported
by the driver directly, as in the JAX package).
"""

from .journal import JOURNAL_FILE, RoundJournal, read_journal  # noqa: F401
from .preempt import PreemptionRequested  # noqa: F401
from .registry import (ACTIONS, SITES, SITES_AWAITING_A_HOME,  # noqa: F401
                       InjectedFault, InjectedOOM, ThreadDeath, active_spec,
                       configure, fault_counters, parse_spec, site)
from .retry import (FATAL, OOM, TRANSIENT, RetryPolicy,  # noqa: F401
                    classify_exception, retry_counters)
