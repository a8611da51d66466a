"""Fault-tolerance primitives for the serving path (the JAX package's
``repro.serve.faults``, kept as the port's own copy: NumPy, ``zlib`` and
the standard library only, so a seed gives the same decisions in both).

Two halves:

* :class:`FaultPlan` — a **seeded, deterministic fault-injection harness**
  (test/benchmark-only). The engine calls :meth:`FaultPlan.fire` at each
  injection site (``"drain"`` — an expensive-tower document drain,
  ``"embed_queries"`` — an expensive-tower query embed, ``"cheap_embed"``
  — the cheap tower's admission-group embed); the plan decides, from a
  per-site seeded stream, whether that call fails, hangs, or proceeds.
  Decisions are deterministic in the per-site *call index*, so a chaos run
  is reproducible regardless of thread interleaving between sites.

* :class:`CircuitBreaker` — the tower lane's failure-isolation state
  machine (production code, not test-only): ``closed`` until
  ``threshold`` *consecutive* failures, then ``open`` (tower calls are
  refused without being attempted) until ``cooldown_s`` elapses, then
  **half-open** — one probe call is allowed through; its success closes
  the breaker, its failure re-arms the cooldown. The serving engine
  consults it before every tower call and feeds every outcome back, so a
  dead tower costs one probe per cooldown instead of a timeout per
  request; while open, the engine's ``on_tower_failure`` policy decides
  between failing fast and proxy-only degraded serving (see
  ``repro_torch.serve``).

Fault modes (:class:`FaultSpec.mode`):

* ``"transient"`` — a fired fault fails ``burst`` consecutive calls at
  the site, then the next call is *forced to succeed*: with
  ``burst <= tower_retries`` the engine's bounded retry always recovers,
  which is what makes the chaos suite's bit-exactness assertion
  deterministic instead of probabilistic.
* ``"persistent"`` — once fired, every later call at the site fails until
  :meth:`FaultPlan.heal` — the breaker/degradation path.
* ``"hang"`` — a fired call sleeps ``hang_s`` and then *succeeds*: the
  mid-flight-deadline scenario (a slow drain that eventually lands).

``hang_s`` on a transient/persistent spec delays the raise instead
(a slow failure). All state is guarded by one lock; the sleep itself runs
outside it so a hung site never blocks another site's decisions.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib

import numpy as np


class InjectedFault(RuntimeError):
    """A failure raised by :meth:`FaultPlan.fire` (test-only).

    ``transient`` marks the fault retryable — the engine's tower retry
    loop treats any exception without a falsy ``transient`` attribute as
    retryable, so persistent injected faults short-circuit straight to the
    policy path."""

    def __init__(self, site: str, call_index: int, transient: bool):
        kind = "transient" if transient else "persistent"
        super().__init__(
            f"injected {kind} fault at {site!r} (call {call_index})")
        self.site = site
        self.call_index = call_index
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Failure behavior for one injection site.

    ``rate`` — probability a *fresh* call fires a fault (one seeded draw
    per fresh call; calls consumed by an ongoing burst, the forced-success
    recovery call, or a tripped persistent fault draw nothing, so the
    decision sequence is stable under retries). ``mode`` — ``"transient"``
    / ``"persistent"`` / ``"hang"`` (see the module doc). ``burst`` —
    consecutive failures per transient firing. ``hang_s`` — sleep before
    the outcome. ``after`` — number of initial calls before the site is
    armed (lets a test warm caches fault-free). ``exc`` — optional
    zero-arg exception factory overriding :class:`InjectedFault` (e.g.
    ``KeyboardInterrupt`` to test the drive loop's re-raise contract).
    """

    rate: float = 0.0
    mode: str = "transient"
    burst: int = 1
    hang_s: float = 0.0
    after: int = 0
    exc: type[BaseException] | None = None

    def __post_init__(self):
        if self.mode not in ("transient", "persistent", "hang"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} not in [0, 1]")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")


class FaultPlan:
    """A seeded schedule of injected failures, one spec per site.

    ``FaultPlan(seed, drain=FaultSpec(rate=0.1), ...)``. Sites with no
    spec never fault. Thread-safe; decisions per site depend only on that
    site's call index and the seed.
    """

    SITES = ("drain", "embed_queries", "cheap_embed")

    def __init__(self, seed: int = 0, **specs: FaultSpec):
        unknown = set(specs) - set(self.SITES)
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {sorted(unknown)}; "
                f"valid sites: {self.SITES}")
        self.seed = int(seed)
        self._specs = dict(specs)
        self._mu = threading.Lock()
        self._calls = dict.fromkeys(specs, 0)
        self._fired = dict.fromkeys(specs, 0)
        self._burst_left = dict.fromkeys(specs, 0)
        self._recovering = dict.fromkeys(specs, False)
        self._tripped = dict.fromkeys(specs, False)
        self._disabled = dict.fromkeys(specs, False)
        # one independent deterministic uniform stream per site
        self._rng = {
            site: np.random.default_rng(
                [self.seed, zlib.crc32(site.encode())])
            for site in specs}

    def fire(self, site: str) -> None:
        """Account one call at ``site``; raise/sleep per the site's spec."""
        spec = self._specs.get(site)
        if spec is None:
            return
        with self._mu:
            i = self._calls[site]
            self._calls[site] = i + 1
            if i < spec.after or self._disabled[site]:
                return
            if self._tripped[site]:
                fail = True
            elif self._burst_left[site] > 0:
                self._burst_left[site] -= 1
                if self._burst_left[site] == 0:
                    self._recovering[site] = True
                fail = True
            elif self._recovering[site]:
                # the call right after a transient burst is forced to
                # succeed — bounded retry deterministically recovers
                self._recovering[site] = False
                return
            else:
                fail = float(self._rng[site].random()) < spec.rate
                if fail:
                    self._fired[site] += 1
                    if spec.mode == "persistent":
                        self._tripped[site] = True
                    elif spec.mode == "transient":
                        if spec.burst > 1:
                            self._burst_left[site] = spec.burst - 1
                        else:
                            self._recovering[site] = True
        if not fail:
            return
        if spec.hang_s > 0.0:
            time.sleep(spec.hang_s)
        if spec.mode == "hang":
            return  # slow but successful
        if spec.exc is not None:
            raise spec.exc()
        raise InjectedFault(site, i, transient=spec.mode == "transient")

    def heal(self, site: str | None = None) -> None:
        """The tower 'came back': clear tripped/burst state **and disarm**
        the site — no further faults fire there (``site=None``: every
        site). The breaker's half-open probe then closes it."""
        with self._mu:
            for s in ([site] if site is not None else list(self._specs)):
                self._tripped[s] = False
                self._burst_left[s] = 0
                self._recovering[s] = False
                self._disabled[s] = True

    def fired(self, site: str) -> int:
        """Faults fired at ``site`` so far (fresh firings, not burst
        members or persistent repeats)."""
        with self._mu:
            return self._fired.get(site, 0)

    def calls(self, site: str) -> int:
        with self._mu:
            return self._calls.get(site, 0)


class CircuitBreaker:
    """Consecutive-failure breaker for the expensive-tower lane.

    Mutated only by the engine's drive thread; other threads (``health()``
    readers) see a consistent snapshot because every field is a single
    attribute write. ``blocked()`` is the non-mutating admission check:
    True only while open *and* inside the cooldown window — once the
    cooldown elapses the next tower call is the half-open probe.
    ``on_success`` closes the breaker; ``on_failure`` counts toward
    ``threshold`` and, once open, re-arms the cooldown (a failed probe).
    """

    def __init__(self, threshold: int = 5, cooldown_s: float = 2.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._open = False
        self.failures = 0  # consecutive
        self.opens = 0  # closed -> open transitions (cumulative)
        self._opened_at = -float("inf")

    @property
    def state(self) -> str:
        """``"closed"`` | ``"open"`` | ``"half_open"`` (open, cooldown
        elapsed — the next tower call is the probe)."""
        if not self._open:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def blocked(self) -> bool:
        return self._open and (
            self._clock() - self._opened_at < self.cooldown_s)

    def on_success(self) -> None:
        self.failures = 0
        self._open = False

    def on_failure(self) -> None:
        self.failures += 1
        if self._open:
            self._opened_at = self._clock()  # failed probe: re-arm
        elif self.failures >= self.threshold:
            self._open = True
            self.opens += 1
            self._opened_at = self._clock()
