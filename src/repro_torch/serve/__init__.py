"""Bi-metric serving: a persistent slot pool behind a request API.

The engine (``repro_torch.serve.engine.BiMetricEngine``) serves the
paper's two-tower deployment. The request unit is a frozen
``SearchRequest`` (tokens, quota, k, n_seeds, expand_width, deadline_ms,
priority); ``submit()``, ``query()`` and ``query_batch()`` take it and
answer with ``SearchResult`` (ids, D-dists, ``ServeStats``). The legacy
``(tokens, quota=...)`` call forms still work and warn once.

The async drive is **continuous batching** over one resident slot pool:

* **admission**: ``submit()`` pushes requests onto a priority/deadline heap
  (higher ``priority`` first, FIFO within; ``deadline_ms`` expiry while
  queued fails the future with ``DeadlineExceeded``). The drive thread
  refills freed slots from the heap on every plan/commit step.
* **slot pool**: one resident ``(slots,)``-row search state
  (``repro_torch.core.beam.BatchedSearchState``) whose rows admission
  recycles in place (``beam.reset_slots``); its static shapes grow in
  power-of-two buckets, each growth an exact no-op (``beam.grow_state``).
* **mid-flight completion**: a slot that goes inactive resolves its future
  on that step and is reusable at once; no head-of-line blocking.
* **tower overlap**: while the expensive tower drains a step's fresh
  documents, the drive thread runs the next admission group's cheap embed
  and stage 1.

A slot row's answer is **bit-exact** to the synchronous ``query_batch``
drive's: budgets are per-row operands, the pools are streaming exact top-P
structures, a wave is scored lane by lane (``l2_topk.gather_score`` on the
D document cache, whose lane value depends only on its (query, row) pair),
and a tower's embedding of a row does not depend on its batch-mates.

``index="vamana"`` (default) is the DiskANN instantiation; ``"covertree"``
descends a cover tree built on d under D (Algorithm 3) through the same
slot pool, with ``covertree_eps`` / ``covertree_T`` as its knobs; its rows
ignore ``n_seeds`` / ``expand_width`` and ``rerank_query_batch`` is
vamana-only. ``shards > 1`` raises until ``beam.ShardedStepper`` is
ported. The engine runs on the card unless ``device="cpu"``.

Observability: ``ServeStats`` splits latency into ``queue_ms`` (submit to
admission) and ``compute_ms`` (admission to resolution), ``latency_ms``
their sum, with admission-time ``slot_occupancy`` / ``queue_depth``;
``BiMetricEngine.counters()`` returns the cumulative ``EngineCounters``.
``close()`` cancels still-queued requests (``CancelledError``); admitted
slots still resolve.

Failure semantics
-----------------
**Failures are scoped to requests, never to the engine**, with four nested
isolation domains (async path):

* **one request**: malformed input (bad token shape) fails only that
  request's future at admission.
* **one admission group**: a cheap-tower or stage-1 error while staging a
  group fails that group's futures with ``AdmissionFailed`` (the original
  exception on ``__cause__``); resident slots never notice.
* **the tower lane**: an expensive-tower failure (query embed or document
  drain) is retried up to ``tower_retries`` times with exponential backoff
  from ``retry_backoff_ms`` (transient errors only: an exception carrying
  ``transient=False``, or a ``TowerTimeout`` past ``drain_timeout_ms``, is
  never retried inline). A retried drain is idempotent, since the document
  cache is written only after a successful forward pass, so recovered runs
  are **bit-exact** to fault-free ones. When the lane gives up,
  ``on_tower_failure`` decides: ``"fail"`` (default) fails each affected
  future with ``TowerFailure`` chaining the original; ``"degrade"``
  resolves each with its stage-1 proxy ranking, ``ServeStats.degraded=
  True``. ``breaker_threshold`` consecutive failures open a circuit breaker
  for ``breaker_cooldown_ms`` (then half-open probes): while open, tower
  calls are refused without an attempt; under ``"degrade"`` the engine
  serves proxy-only without occupying slots, under ``"fail"`` requests
  shed fast with ``TowerFailure``.
* **the engine**: only an error outside those domains (poisoned resident
  device state, a CUDA error among them) reaches ``fail_all``: every
  resident and staged future fails with ``EngineFailure`` (original on
  ``__cause__``), the resident state is dropped, and the next admission
  starts a fresh one. ``KeyboardInterrupt`` / ``SystemExit`` fail the
  residents and are then re-raised, never turned into a served error.

``deadline_ms`` is enforced at three points: queued expiry and
admission-pop expiry fail the future with ``DeadlineExceeded`` (the request
never ran, so there is nothing to degrade to), and **mid-flight** expiry,
checked every drive iteration and every 20 ms inside a tower wait while
deadlines are resident, follows ``on_tower_failure``: ``"degrade"``
resolves the slot with its proxy ranking (counted in ``deadline_misses``
and ``degraded``), ``"fail"`` raises ``DeadlineExceeded``. Expired rows
close their frontier in place (``beam.early_resolve``); co-resident rows
are untouched bit for bit.

**Degraded answers.** A degraded result is the stage-1 proxy ranking
under the cheap metric d. The paper's premise is that d is a
C-approximation of D (``D/C <= d <= C·D``), so every returned id is within
``C²`` of optimal under D. Cover-tree rows have no proxy stage: they
degrade to their D-scored pool prefix mid-flight and shed fast while the
breaker is open. Nothing in the engine catches a kernel's failure and
carries on with a plain version or on the CPU.

Fault injection for tests and measurements is
``repro_torch.serve.faults.FaultPlan`` (seeded, deterministic, given as
``BiMetricEngine(faults=...)``); ``BiMetricEngine.health()`` snapshots the
breaker and the counters.
"""
from repro_torch.serve.engine import (AdmissionFailed,  # noqa: F401
                                      BiMetricEngine, DeadlineExceeded,
                                      EmbedTower, EngineCounters,
                                      EngineFailure, SearchRequest,
                                      SearchResult, ServeFuture, ServeStats,
                                      TowerFailure, TowerTimeout)
from repro_torch.serve.faults import (CircuitBreaker,  # noqa: F401
                                      FaultPlan, FaultSpec, InjectedFault)
