"""The deterministic fault-injection registry (the JAX package's
``faults/registry.py``).

Named fault points (``site("ckpt_write")``) sit in the port's code paths.
Disarmed they cost one module-global ``is None`` check; armed through
``--fault_spec`` or ``$AL_FAULT_SPEC`` they raise, tear a multi-file
write, kill the calling thread, or delay, deterministically.

Spec grammar (comma-separated), the JAX package's::

    site:action[@arg]

    ckpt_write:raise@3        raise InjectedFault on the 3rd hit (1-based,
                              fires exactly once)
    ckpt_write:torn@1         raise at the site's TORN point (between the
                              two renames of an atomic multi-file write)
                              on the 1st torn-point hit
    grad_probe:die@0.5        kill the calling thread (ThreadDeath, a
                              BaseException that sails past
                              ``except Exception`` guards) with seeded
                              probability 0.5 per hit
    dispatch:delay@0.05       sleep 50 ms at every hit
    dispatch:oom@2            raise InjectedOOM (classified as an
                              allocator failure) on the 2nd hit

Integer args are Nth-hit triggers (fire once); float args in (0, 1) are
per-hit probabilities drawn from a per-(seed, site, action)
``random.Random``, so the same spec and seed fire at the same hits as in
the JAX package; for ``delay`` the arg is seconds.  No arg = every hit.

``SITES`` is the JAX package's closed tuple, so every JAX spec parses
here.  The sites whose home the port does not have yet are listed in
``SITES_AWAITING_A_HOME`` with the ROADMAP.md item that brings them; an
armed spec naming one of them never fires.

Every site call has two points: ``enter`` (the default: raise, oom, die
and delay fire here, before the guarded work) and ``torn`` (only the
``torn`` action fires there, between the renames of an atomic pair).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, Optional, Tuple

# The JAX package's closed site registry.  The port wires:
#   ckpt_write  train/checkpoint.save_variables / save_fit_state /
#               publish_best and experiment/resume.save_experiment (torn
#               points between each atomic pair's renames)
#   dispatch    train/trainer.Trainer.train_step: every train step the
#               port dispatches
#   grad_probe  experiment/driver.run_grad_allreduce_probe: an injected
#               failure is a broken probe, and the run degrades to the
#               f32 sync
SITES = ("h2d_upload", "ckpt_write", "spec_scorer", "feed_worker",
         "shard_upload", "dispatch", "grad_probe", "wal_write",
         "stream_drain", "page_read", "fleet_journal")

# Sites whose subsystem the port does not carry yet -> the ROADMAP.md
# queue-1 item that brings it.
SITES_AWAITING_A_HOME = {
    "h2d_upload": "item 5 (the device-resident pool)",
    "shard_upload": "item 7 (the row-sharded pool)",
    "feed_worker": "item 2 (data/cache.py's device feeder)",
    "spec_scorer": "item 5 (the pipelined round)",
    "wal_write": "item 6 (streaming ingest)",
    "stream_drain": "item 6 (streaming ingest)",
    "page_read": "item 5 (the disk tier)",
    "fleet_journal": "item 6 (the fleet controller)",
}

ACTIONS = ("raise", "oom", "die", "delay", "torn")


class InjectedFault(RuntimeError):
    """A deliberately injected, transiently classified failure."""

    def __init__(self, site_name: str, detail: str = ""):
        super().__init__(f"injected fault at site {site_name!r}"
                         + (f" ({detail})" if detail else ""))
        self.site = site_name


class InjectedOOM(InjectedFault):
    """Injected allocator exhaustion; classified as OOM, like
    ``torch.OutOfMemoryError`` (``retry.classify_exception``)."""

    def __init__(self, site_name: str):
        super().__init__(site_name, "RESOURCE_EXHAUSTED (injected)")


class ThreadDeath(BaseException):
    """Injected thread death: a BaseException, so it passes every
    ``except Exception`` guard on the thread's stack and kills it."""

    def __init__(self, site_name: str):
        super().__init__(f"injected thread death at site {site_name!r}")
        self.site = site_name


class _SiteState:
    """One armed site: its action, trigger arg, seeded rng, and hit
    counters (per point)."""

    def __init__(self, name: str, action: str, arg, seed: int):
        self.name = name
        self.action = action
        self.arg = arg
        self.hits: Dict[str, int] = {"enter": 0, "torn": 0}
        self.fires = 0
        self._rng = random.Random(f"{seed}:{name}:{action}")

    def hit(self, point: str) -> Optional[float]:
        """Count the hit and fire the action.  ``delay`` returns the
        seconds instead of sleeping: the caller sleeps outside the
        registry lock."""
        fire_point = "torn" if self.action == "torn" else "enter"
        if point != fire_point:
            return None
        self.hits[point] += 1
        arg = self.arg
        if self.action == "delay":
            self.fires += 1
            return float(arg) if arg is not None else 0.01
        if arg is None:
            fire = True
        elif isinstance(arg, int):
            fire = self.hits[point] == arg
        else:
            fire = self._rng.random() < float(arg)
        if not fire:
            return None
        self.fires += 1
        if self.action == "oom":
            raise InjectedOOM(self.name)
        if self.action == "die":
            raise ThreadDeath(self.name)
        raise InjectedFault(self.name, self.action)


# Disarmed = None: site() is one global read and an identity compare.
_ARMED: Optional[Dict[str, _SiteState]] = None
_LOCK = threading.Lock()


def parse_spec(spec: str) -> Dict[str, Tuple[str, Any]]:
    """``"ckpt_write:torn@1,dispatch:delay@0.05"`` ->
    ``{"ckpt_write": ("torn", 1), "dispatch": ("delay", 0.05)}``.
    Unknown sites or actions and malformed args raise ValueError: a
    mistyped spec that armed nothing would make a chaos run vacuous."""
    out: Dict[str, Tuple[str, Any]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            name, rest = part.split(":", 1)
        except ValueError:
            raise ValueError(f"fault spec entry {part!r}: expected "
                             "site:action[@arg]") from None
        if name not in SITES:
            raise ValueError(f"fault spec names unknown site {name!r} "
                             f"(registered: {', '.join(SITES)})")
        action, _, arg_s = rest.partition("@")
        if action not in ACTIONS:
            raise ValueError(f"fault spec action {action!r} for {name!r} "
                             f"is not one of {', '.join(ACTIONS)}")
        arg: Any = None
        if arg_s:
            try:
                arg = int(arg_s)
                if action != "delay" and arg < 1:
                    raise ValueError
            except ValueError:
                try:
                    arg = float(arg_s)
                except ValueError:
                    raise ValueError(
                        f"fault spec arg {arg_s!r} for {part!r} is "
                        "neither an int hit-count nor a float") from None
                if action != "delay" and not (0.0 < arg < 1.0):
                    raise ValueError(
                        f"fault spec probability {arg} for {part!r} must "
                        "be in (0, 1)")
        if name in out:
            raise ValueError(f"fault spec arms site {name!r} twice")
        out[name] = (action, arg)
    return out


def configure(spec: Optional[str], seed: int = 0) -> None:
    """Arm the registry from a spec string (None or "" disarms)."""
    global _ARMED
    if not spec:
        _ARMED = None
        return
    parsed = parse_spec(spec)
    _ARMED = {name: _SiteState(name, action, arg, seed)
              for name, (action, arg) in parsed.items()}


def active_spec() -> Optional[Dict[str, Tuple[str, Any]]]:
    armed = _ARMED
    if armed is None:
        return None
    return {name: (st.action, st.arg) for name, st in armed.items()}


def site(name: str, point: str = "enter") -> None:
    """A named fault point: a no-op while disarmed; armed, the site's
    action fires by its trigger rule (see the module docstring)."""
    armed = _ARMED
    if armed is None:
        return
    st = armed.get(name)
    if st is None:
        return
    with _LOCK:
        delay = st.hit(point)
    if delay is not None:
        time.sleep(delay)


def fault_counters() -> Dict[str, Dict[str, int]]:
    """Hits and fires of each armed site ({} when disarmed), so a chaos
    test can tell a recovered run from one that never faulted."""
    armed = _ARMED
    if armed is None:
        return {}
    with _LOCK:
        return {name: {"hits": sum(st.hits.values()), "fires": st.fires}
                for name, st in armed.items()}
