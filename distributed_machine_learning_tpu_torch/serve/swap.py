"""Zero-downtime bundle hot swap: warm off the serving path, then switch,
then drain; and rollback to a retained bundle.

Port of ``distributed_machine_learning_tpu/serve/swap.py``.  A promotion
must not drop a request and must not build a bucket on the serving path:

1. **Warm off-path.**  For each serving slot a fresh :class:`Replica` is
   built from the new bundle on the slot's own device and its whole
   bucket grid is run before it sees a request.  The old replica keeps
   serving the slot the entire time.
2. **Switch.**  The warmed replica replaces the old one under the
   dispatch lock; requests dispatched after this instant run the new
   model.
3. **Drain.**  The old replica leaves dispatch first, then its batcher
   drains: every request it had already accepted is answered by the old
   model.

Slots swap one at a time, so N-1 replicas serve throughout.  After the
last slot the set's bundle pointer moves (monitor restarts now build the
new model) and ``new_programs_since_warmup`` is re-baselined, so it keeps
meaning "buckets built by traffic" across the swap.

**Rollback**: the swap retains the outgoing bundle (pointer and manifest)
in ``replica_set.bundle_history``, at most :data:`HISTORY_DEPTH` entries
(each pins a params tree in host memory).  :func:`rollback` re-swaps the
newest retained bundle.

The JAX module's ``obs`` spans and events and its ``chaos`` mid-swap
crash hook wait for ROADMAP.md A10 and A8 respectively.
"""

from __future__ import annotations

import time
from typing import Any, Dict

# Prior-bundle retention bound: each entry pins a full params tree in
# host memory, so this is a real budget.
HISTORY_DEPTH = 4


def hot_swap(replica_set, new_bundle, sample=None,
             warm: bool = True) -> Dict[str, Any]:
    """Swap ``new_bundle`` into a live ReplicaSet with zero dropped
    requests; returns the swap event (also appended to
    ``replica_set.swap_history``).

    ``sample`` drives the warmup grid; it defaults to the sample the set
    was warmed with.  ``warm=False`` skips the warmup (first requests then
    build their buckets on the serving path)."""
    from distributed_machine_learning_tpu_torch.serve.replica import Replica

    rs = replica_set
    if sample is None:
        sample = rs._warmup_sample
    prior = rs.bundle
    t0 = time.monotonic()
    swapped = 0
    with rs._scale_lock:
        with rs._lock:
            n = len(rs.replicas)
        for i in range(n):
            with rs._lock:
                if i >= len(rs.replicas):
                    break
                old = rs.replicas[i]
            fresh = Replica(old.idx, new_bundle, old.device, **rs._kwargs)
            if warm and sample is not None:
                fresh.engine.warmup(sample)
            with rs._lock:
                # The slot may have been monitor-restarted while we
                # warmed; whatever occupies it now is what we retire.
                if i >= len(rs.replicas):
                    fresh.kill()
                    break
                old = rs.replicas[i]
                rs.replicas[i] = fresh
            # Out of dispatch -> drain: accepted requests still answer on
            # the old model, nothing is dropped mid-flight.
            old.batcher.stop(drain=True, timeout=10.0)
            swapped += 1
        rs.bundle = new_bundle
        stats = rs.program_stats()
        if rs._warmup_programs is not None:
            rs._warmup_programs = stats["programs"]
        rs.swaps += 1
        event = {
            "bundle": getattr(new_bundle, "path", None),
            "replicas_swapped": swapped,
            "duration_s": round(time.monotonic() - t0, 3),
            "programs_after": stats["programs"],
            "at_unix": round(time.time(), 3),
        }
        rs.swap_history.append(event)
        del rs.swap_history[:-16]
        if prior is not None and prior is not new_bundle:
            rs.bundle_history.append({
                "bundle": prior,
                "path": getattr(prior, "path", None),
                "manifest": dict(getattr(prior, "manifest", {}) or {}),
                "retired_at_unix": round(time.time(), 3),
            })
            del rs.bundle_history[:-HISTORY_DEPTH]
    return event


def warm_swap_bundle(replica_set, bundle_dir: str,
                     sample=None) -> Dict[str, Any]:
    """Load a bundle directory and hot-swap it in (``/admin/swap``)."""
    from distributed_machine_learning_tpu_torch.serve.export import (
        load_bundle,
    )

    return hot_swap(replica_set, load_bundle(bundle_dir), sample=sample)


def rollback(replica_set, sample=None,
             reason: str = "manual") -> Dict[str, Any]:
    """Re-promote the newest retained prior bundle (the one the last swap
    retired): ``/admin/rollback``.  Raises :class:`LookupError` when
    nothing is retained (a fresh set, or the bound evicted it)."""
    rs = replica_set
    with rs._scale_lock:
        entry = rs.bundle_history.pop() if rs.bundle_history else None
    if entry is None:
        raise LookupError(
            "no prior bundle retained — nothing to roll back to"
        )
    event = hot_swap(rs, entry["bundle"], sample=sample)
    event = dict(
        event, rollback=True, reason=reason,
        rolled_back_to=entry.get("path"),
    )
    with rs._scale_lock:
        rs.rollbacks += 1
        # The plain swap's event already landed in swap_history; the
        # annotated one replaces it so /metrics tells a rollback apart.
        if rs.swap_history:
            rs.swap_history[-1] = event
    return event
