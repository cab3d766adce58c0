"""Route-hop simulation for the BASELINE headline metric.

``BASELINE.md``'s target is "placements/sec + p99 route hops @1M objects /
1k nodes". Hops are a *client routing* property, so they are evaluated by
simulating the two client strategies over the same request stream:

* **reference policy** (``rio-rs``): on a placement-cache miss the client
  sends to a *random active server* (``client/mod.rs:255-262``); a wrong
  pick costs a ``Redirect`` round trip (``tower_services.rs:158-209``) —
  2 hops. A request that lands on a dead owner costs redirect +
  ``DeallocateServiceObject`` + retry — 3 hops (``service.rs:261-298``).
* **rio-tpu policy**: the placement directory is a host-mirrored table fed
  by the device solve (``TorchObjectPlacement.lookup`` is an O(1) dict hit,
  no SQL round trip), so clients resolve the owner *before* dialing:
  1 hop, 2 when the snapshot is stale (bounded by churn between refreshes).

The simulation is deterministic (seeded), pure numpy, and intentionally
charges rio-tpu a staleness penalty so the comparison is not a freebie.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HopStats:
    mean: float
    p50: float
    p99: float

    def as_dict(self) -> dict:
        return {"mean": round(self.mean, 3), "p50": self.p50, "p99": self.p99}


def _percentile(hops: np.ndarray, q: float) -> float:
    return float(np.percentile(hops, q, method="lower"))


def simulate_route_hops(
    *,
    n_objects: int = 1_000_000,
    n_nodes: int = 1_000,
    n_requests: int = 200_000,
    cache_size: int = 1_000,
    zipf_a: float = 1.1,
    dead_owner_rate: float = 0.002,
    stale_directory_rate: float = 0.003,
    seed: int = 0,
) -> dict[str, HopStats]:
    """Simulate both routing policies over one zipf request stream.

    ``cache_size`` models the reference client's 1,000-entry placement LRU
    (``client/mod.rs:137``): with vastly more objects than cache slots the
    hit rate is what the popularity skew gives — everything else is a
    random pick. ``dead_owner_rate`` is the fraction of requests whose
    cached/true owner died since last contact; ``stale_directory_rate`` is
    the chance rio-tpu's host mirror hasn't absorbed a move yet. Defaults
    model gossip-scale churn (nodes die over 10-60 s windows,
    ``peer_to_peer.rs:28-37``) against a request stream that is orders of
    magnitude faster — a fraction of a percent of requests race a death.
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish popularity over object ids (clip the tail into range).
    objects = rng.zipf(zipf_a, size=n_requests) % n_objects

    # Reference: LRU hit => 1 hop (cached owner; may be dead). Miss =>
    # random server: right with p=1/n_nodes, else redirect (2 hops).
    # Simulate the LRU by tracking recency over the stream (exact LRU).
    from collections import OrderedDict

    lru: OrderedDict[int, None] = OrderedDict()
    ref_hops = np.empty(n_requests, np.int32)
    dead = rng.random(n_requests) < dead_owner_rate
    lucky = rng.random(n_requests) < (1.0 / n_nodes)
    for i, obj in enumerate(objects):
        hit = obj in lru
        if hit:
            lru.move_to_end(obj)
        else:
            lru[int(obj)] = None
            if len(lru) > cache_size:
                lru.popitem(last=False)
        if dead[i]:
            # redirect (or cached stale owner) -> deallocate -> retry
            ref_hops[i] = 3
        elif hit or lucky[i]:
            ref_hops[i] = 1
        else:
            ref_hops[i] = 2

    # rio-tpu: directory-resolved dial. Stale entry => one redirect.
    ours_hops = np.where(
        rng.random(n_requests) < (stale_directory_rate + dead_owner_rate), 2, 1
    ).astype(np.int32)

    return {
        "reference": HopStats(
            mean=float(ref_hops.mean()),
            p50=_percentile(ref_hops, 50),
            p99=_percentile(ref_hops, 99),
        ),
        "rio_tpu": HopStats(
            mean=float(ours_hops.mean()),
            p50=_percentile(ours_hops, 50),
            p99=_percentile(ours_hops, 99),
        ),
    }
