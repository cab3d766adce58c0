"""TorchObjectPlacement: the directory provider of the port, solved on the card.

Counterpart of ``rio_tpu/object_placement/jax_placement.py``. It implements
the ``ObjectPlacement`` trait plus the duck-typed surface the runtime reads
(``stats``, ``affinity_tracker``, ``assign_standbys``, ``sync_members``,
``sync_load``, ``cordon``, ``add_churn_listener``, ``set_edge_graph``,
``rebalance(move_sink=, delta=)``), so an unchanged ``rio_tpu`` ``Server``
and ``PlacementDaemon`` run on it. It keeps:

- a **host-mirrored directory** (dict) answering ``lookup`` in O(1) with no
  I/O;
- a **device solve**: batched placement of new objects through a greedy
  waterfill biased by cached node potentials, and full re-solves in four
  forms — the class-collapsed O(M^2) Sinkhorn
  (:mod:`rio_tpu_torch.ops.structured`), the dense Sinkhorn or scaling
  solve over per-object prices, the churn-aware greedy waterfill, and the
  two-level hierarchical solve over object and node features
  (:mod:`rio_tpu_torch.parallel.hierarchical`), which ``mode="hierarchical"``
  runs and which flat rebalances above ``_FLAT_REBALANCE_MAX_ROWS`` padded
  rows are routed to (``"<mode>+hier_at_scale"``);
- an :class:`AffinityTracker` that turns served requests into the
  hierarchical solve's object features;
- **incremental (delta) rebalances** that re-solve only the displaced
  objects against residual quotas, warm-started from the last plan;
- the **affinity refine**: with ``affinity_weight > 0`` every full solve is
  followed by linearized OT passes over the communication graph that
  ``set_edge_graph`` installs (``"<mode>+affinity"``);
- **epoch versioning**: every mutation bumps an epoch, and a solve whose
  snapshot epoch moved underneath it is discarded.

Solves run in a worker thread over snapshots taken on the event loop. Every
device result comes back through an explicit ``.cpu()``: that pull is the
synchronisation point, so ``solve_ms`` includes the device's time.

It runs on the CUDA device unless it is built with ``device="cpu"``.
With a ``mesh`` (:func:`rio_tpu_torch.parallel.make_mesh`) the full solves
shard over it: the dense flat solve over a sharded cost (no class
collapse), and the hierarchical solve over the object axis, composed with
chunking above ``_HIER_CHUNK_ROWS`` rows a shard (``"+mesh_chunk"``); the
provider's device is then the mesh's first device.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import threading
import time
import zlib
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..device import resolve_device
from ..errors import NoSchedulableCapacity
from ..ops import (
    build_cost_matrix,
    class_quotas,
    exact_quota_repair,
    expand_class_quotas,
    greedy_balanced_assign,
    integer_fair_quotas,
    plan_rounded_assign,
    residual_capacity_assign,
    scaling_sinkhorn,
    sinkhorn,
)
from ..ops import prng
from ..ops.assignment import rank_within_group
from ..ops.sinkhorn import route_sentinel_spill
from ..parallel import shard_cost, sharded_scaling_sinkhorn, sharded_sinkhorn
from ..parallel.hierarchical import (
    chunked_hierarchical_assign_timed,
    hierarchical_assign,
    mesh_chunked_hierarchical_assign_timed,
    sharded_hierarchical_assign,
)
from ..registry import ObjectId
from ..tracing import span
from . import ObjectPlacement, ObjectPlacementItem, sanitize_standby_row

log = logging.getLogger(__name__)

_FEAT_DIM = 16  # hashed-identity feature width for the hierarchical mode

# Flat (sinkhorn/scaling) rebalances above this many padded rows route
# through the hierarchical solve ("<mode>+hier_at_scale"). The bound is the
# JAX provider's, so both providers route the same rebalances; 1,048,576
# (the BASELINE.json goal) stays on the flat paths.
_FLAT_REBALANCE_MAX_ROWS = 1_048_576

# Hierarchical solves chunk the object axis above this row count (a power
# of two, so it divides every larger bucket); each chunk solves against
# its share of every node's capacity.
_HIER_CHUNK_ROWS = 524_288

# Key-chunk size of the streamed object-feature block: the feature hook is
# called on slices of this many keys, and rows land in the preallocated
# final block.
_OBJ_FEAT_STREAM_ROWS = 262_144

# Keys per batch of threefry draws: bounds the int64 temporaries of
# _hash_features to ~128 MiB each.
_HASH_CHUNK_KEYS = 1 << 20

_SOLVER_MODES = ("sinkhorn", "scaling", "greedy", "hierarchical")

# Row cap of the affinity refine's subset solve (the JAX provider's): the
# heaviest-degree edge-touching objects win the slots, so a pathological
# graph never turns the refine into a directory-sized dense problem.
_AFFINITY_MAX_ROWS = 4096


def _next_bucket(n: int, minimum: int = 256) -> int:
    """Pad batch sizes to power-of-two buckets (the JAX provider's shapes)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _key_seeds(keys: list[str]) -> np.ndarray:
    """Each key's PRNG seed, ``crc32(utf-8 key) & 0x7FFFFFFF`` (host int64)."""
    return np.fromiter(
        (zlib.crc32(k.encode()) & 0x7FFFFFFF for k in keys), np.int64, count=len(keys)
    )


def _hash_features(
    keys: list[str], dim: int = _FEAT_DIM, *, device: str | torch.device = "cpu"
) -> torch.Tensor:
    """Stable pseudo-random feature per key: (n, dim) float32 on ``device``.

    The JAX provider's ``_hash_features``: crc32 of the key seeds a PRNG
    key and the feature is ``jax.random.normal(key, (dim,))``. The draws run
    on ``device`` (:mod:`rio_tpu_torch.ops.prng`: the same threefry bits,
    normals within ~5e-7 of XLA's); the crc32s are host work. Deterministic
    across processes, so affinity survives restarts without storage.
    """
    seeds = torch.from_numpy(_key_seeds(keys)).to(device)
    out = torch.empty((len(keys), dim), dtype=torch.float32, device=device)
    for start in range(0, len(keys), _HASH_CHUNK_KEYS):
        stop = start + _HASH_CHUNK_KEYS
        out[start:stop] = prng.normal(seeds[start:stop], dim)
    return out


# (dim, device) -> features of pad rows 0..len-1 (see _pad_feature_block).
_PAD_BLOCKS: dict[tuple[int, torch.device], torch.Tensor] = {}


def _pad_feature_block(pad: int, dim: int, device: torch.device) -> torch.Tensor:
    """Deterministic features of the hierarchical solve's first ``pad`` pad rows, on ``device``.

    Pad row i's feature depends on i alone, so one block per (dim, device)
    holds the most rows asked for so far, grows by the missing rows, and
    a request is a slice of it: rebuilding up to ``bucket - n`` synthetic
    keys per rebalance would be pure waste, and one block per pad count
    would pin a few of them in device memory. Callers only read it."""
    key = (dim, torch.device(device))
    block = _PAD_BLOCKS.get(key)
    have = 0 if block is None else block.shape[0]
    if have < pad:
        more = _hash_features([f"\x00pad:{i}" for i in range(have, pad)], dim, device=device)
        block = more if block is None else torch.cat([block, more])
        _PAD_BLOCKS[key] = block
    return block[:pad]


# Serialises CUDA graph captures (AffinityTracker._bind).
_CAPTURE_LOCK = threading.Lock()


class _OneKeyDraw:
    """``prng.normal`` of one seed on a CUDA device, replayed from a CUDA graph.

    ``AffinityTracker.observe`` draws one cold key at a time: ~200
    dependent elementwise steps on 16 words. As eager launches on the card
    that took 2.6–2.9 ms a key; replayed from one graph, 0.32–0.33 ms (an
    H100 80GB HBM3 at 700 W; ``chip_smoke.py`` ``hier_directory`` prints
    both).
    Thread-safe: the graph's input and output buffers are shared, so
    replays are serialised.
    """

    def __init__(self, dim: int, device: torch.device) -> None:
        self._lock = threading.Lock()
        self._seed = torch.zeros((1,), dtype=torch.int64, device=device)
        # One eager run on a side stream before the capture, as CUDA graphs
        # require of the operators they record.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            prng.normal(self._seed, dim)
        torch.cuda.current_stream(device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, capture_error_mode="thread_local"):
            self._out = prng.normal(self._seed, dim)

    def __call__(self, key: str) -> np.ndarray:
        """(dim,) float32 host feature of ``key`` (``_hash_features([key])[0]``)."""
        with self._lock:
            self._seed.fill_(int(_key_seeds([key])[0]))
            self._graph.replay()
            return self._out[0].cpu().numpy()


def _feature_tensor(x, device: torch.device) -> torch.Tensor:
    """A feature hook's result (numpy or a tensor) as float32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


class AffinityTracker:
    """Turns observed traffic into placement features for hierarchical mode.

    The counterpart of the JAX provider's tracker, with the same surface
    and host-numpy state. The two-level solver scores ``obj_feat[i] @
    node_feat[:, j]``; here each node gets a stable embedding, and each
    object's feature is a request-weighted EMA of the embeddings of the
    nodes that served it (cache warmth / state locality), so the OT
    objective pulls an object toward where its state is hot while the
    capacity marginals still enforce balance.

    A provider built with ``affinity_tracker=tracker`` carries it, so an
    unchanged ``rio_tpu`` ``Server`` wires ``observe`` into its dispatch
    path, the load monitor drives ``fold_rates``, read scaling reads
    ``object_rates`` and migration reports ``note_state_bytes``.

    The hashed-identity draws (node embeddings, cold objects' bases) run
    on ``device`` and come back as host numpy. A tracker built without one
    takes the device of the provider it is handed to, and otherwise the
    CUDA device at its first draw (``resolve_device``).
    """

    def __init__(
        self,
        dim: int = _FEAT_DIM,
        stickiness: float = 0.25,
        max_objects: int = 262_144,
        device: str | torch.device | None = None,
    ) -> None:
        self.dim = dim
        self.device: torch.device | None = None
        self._one_key_draw: _OneKeyDraw | None = None
        if device is not None:
            self._bind(resolve_device(device))
        # Hard bound on per-object state (warmth vectors, rate EMAs,
        # state-bytes records): fold_rates() evicts the COLDEST entries
        # (lowest folded req/sec; unknown rate counts as 0) down to the
        # cap, so the hottest objects always survive. ``evictions`` counts
        # dropped entries.
        self.max_objects = int(max_objects)
        self.evictions = 0
        # EMA coefficient toward the serving node's embedding per unit
        # weight; 0.0 disables learning. The default keeps MULTI-node
        # warmth: with interleaved traffic the feature converges to the
        # traffic-share mix of the serving nodes' embeddings.
        self.stickiness = stickiness
        self._obj: dict[str, np.ndarray] = {}
        self._node_cache: dict[str, np.ndarray] = {}
        # Measured per-object cost features: request counts since the last
        # fold_rates() tick, the folded req/sec EMA, and the last observed
        # migration-snapshot size. Every map is replaced, never mutated in
        # place: the solver thread reads them concurrently.
        self._req_window: dict[str, float] = {}
        self._rates: dict[str, float] = {}
        self._state_bytes: dict[str, float] = {}
        self._rate_fold_t = time.monotonic()

    def _bind(self, device: torch.device) -> None:
        """Draw on ``device`` from now on (the first binding wins).

        On a CUDA device the one-key draw's graph is captured here, once:
        a capture fails if another thread synchronises the device meanwhile,
        so it happens when the tracker is built or handed to its provider,
        before any solve runs beside it, and one capture at a time."""
        with _CAPTURE_LOCK:
            if self.device is not None:
                return
            if device.type == "cuda":
                self._one_key_draw = _OneKeyDraw(self.dim, device)
            self.device = device

    def _draw(self, keys: list[str]) -> np.ndarray:
        """(n, dim) float32 host copy of ``_hash_features(keys)``, drawn on the tracker's device."""
        if self.device is None:
            self._bind(resolve_device(None))
        if len(keys) == 1 and self._one_key_draw is not None:
            return self._one_key_draw(keys[0])[None, :]
        return _hash_features(keys, self.dim, device=self.device).cpu().numpy()

    def _node_vec(self, address: str) -> np.ndarray:
        vec = self._node_cache.get(address)
        if vec is None:
            vec = self._unit_node_vecs([address], self._draw([address]))[0]
        return vec

    def _unit_node_vecs(self, addresses: list[str], draws: np.ndarray) -> list[np.ndarray]:
        """Normalise and cache node embeddings, one row at a time as ``_node_vec`` does."""
        out = []
        for address, vec in zip(addresses, draws):
            vec = vec / max(float(np.linalg.norm(vec)), 1e-9)
            self._node_cache[address] = vec
            out.append(vec)
        return out

    def observe(self, key: str, node_address: str, weight: float = 1.0) -> None:
        """Record that ``key`` was served by ``node_address``.

        ``weight`` scales the pull. Alpha is capped below 1 so a single
        heavy observation can never fully erase accumulated warmth."""
        self._req_window[key] = self._req_window.get(key, 0.0) + max(0.0, weight)
        alpha = min(0.95, self.stickiness * weight)
        if alpha <= 0.0:
            return
        target = self._node_vec(node_address)
        cur = self._obj.get(key)
        if cur is None and len(self._obj) >= 2 * self.max_objects:
            # Backstop when nothing drives fold_rates(): fold (evicting down
            # to max_objects) before admitting a new key, so the tracker
            # never exceeds 2x its cap.
            self.fold_rates(min_dt=0.0)
            cur = self._obj.get(key)
        if cur is None:
            # Cold object: blend from the weak hashed-identity base that
            # obj_features() would have used.
            cur = self._draw([key])[0] * 0.1
        # Atomic swap (never mutate in place).
        new = (1.0 - alpha) * cur + alpha * target
        norm = float(np.linalg.norm(new))
        if norm > 1e-9:
            new = new / norm
        self._obj[key] = new

    def obj_features(self, keys: list[str]) -> np.ndarray:
        """(n, dim) features: learned EMA, hashed identity x 0.1 for cold objects."""
        out = self._draw(keys) * 0.1
        for i, k in enumerate(keys):
            vec = self._obj.get(k)
            if vec is not None:
                out[i] = vec
        return out

    def node_features(self, addresses: list[str]) -> np.ndarray:
        """(m, dim) embeddings matching what ``observe`` pulled toward."""
        if not addresses:
            return np.zeros((0, self.dim), np.float32)
        cache = self._node_cache
        missing = list(dict.fromkeys(a for a in addresses if a not in cache))
        if missing:  # one batch of draws for the nodes not seen yet
            self._unit_node_vecs(missing, self._draw(missing))
        return np.stack([self._node_vec(a) for a in addresses]).astype(np.float32)

    # ------------------------------------------- measured cost features
    def fold_rates(self, beta: float = 0.3, min_dt: float = 0.05) -> None:
        """Fold the since-last-tick request window into per-object req/sec
        EMAs, then enforce ``max_objects`` on every per-object map. Builds
        fresh dicts and swaps them in."""
        now = time.monotonic()
        dt = now - self._rate_fold_t
        if dt < min_dt:
            return
        self._rate_fold_t = now
        window, self._req_window = self._req_window, {}
        rates: dict[str, float] = {}
        for k, old in self._rates.items():
            new = (1.0 - beta) * old + beta * (window.pop(k, 0.0) / dt)
            if new > 1e-6:  # drop cooled-off objects: the map stays bounded
                rates[k] = new
        for k, cnt in window.items():
            rates[k] = beta * (cnt / dt)
        self._rates = rates
        # Evict coldest-by-rate first so the warmth that matters survives.
        for name in ("_obj", "_state_bytes"):
            cur = getattr(self, name)
            over = len(cur) - self.max_objects
            if over <= 0:
                continue
            doomed = sorted(cur, key=lambda k: rates.get(k, 0.0))[:over]
            kept = dict(cur)
            for k in doomed:
                del kept[k]
            setattr(self, name, kept)
            self.evictions += over
        if len(rates) > self.max_objects:
            over = len(rates) - self.max_objects
            doomed = sorted(rates, key=rates.get)[:over]
            kept_r = dict(rates)
            for k in doomed:
                del kept_r[k]
            self._rates = kept_r
            self.evictions += over

    def total_rate(self) -> float:
        return float(sum(self._rates.values()))

    def object_rates(self) -> dict[str, float]:
        """Snapshot (a copy) of the folded per-object req/sec EMAs, keyed
        ``"{type_name}.{id}"``; the read-scale hotness detector reads it."""
        return dict(self._rates)

    def note_state_bytes(self, key: str, nbytes: int) -> None:
        """Record the object's last migration-snapshot size (its state weight)."""
        self._state_bytes[key] = float(max(0, nbytes))

    def move_weights(
        self,
        keys: list[str],
        *,
        rate_scale: float = 10.0,
        bytes_scale: float = 1 << 20,
        max_weight: float = 16.0,
    ) -> np.ndarray:
        """(n,) per-object move prices for the solver's stay-put discount:
        ``1.0`` for a cold object, growing with measured request rate and
        snapshot size, capped at ``max_weight``. A provider built with the
        tracker uses it as its ``object_costs`` hook."""
        rates, sizes = self._rates, self._state_bytes  # snapshot refs
        out = np.ones((len(keys),), np.float32)
        for i, k in enumerate(keys):
            w = 1.0 + rates.get(k, 0.0) / rate_scale + sizes.get(k, 0.0) / bytes_scale
            out[i] = min(max_weight, w)
        return out


def _least_loaded_spread(load, alive, cap, n_real: int, count: int) -> np.ndarray:
    """Deterministic seats when the solver can't provide them: REAL
    nodes only, schedulable (alive AND capacity > 0) nodes before the
    rest, least-loaded first — and round-robin over ONLY the
    schedulable prefix when one exists (seating overflow on a dead,
    cordoned, or capacity-zero node while schedulable capacity exists
    would break cordon's no-new-seats contract and the operator's
    capacity=0 don't-place-here signal). When NO node is schedulable
    (the all-dead blip) every real node cycles — any real seat beats a
    pad index. Host numpy arrays in, (count,) int32 out."""
    if n_real <= 0:
        raise NoSchedulableCapacity(
            "placement solve with no registered nodes: register_node/"
            "sync_members must run before any placement is requested"
        )
    a = np.asarray(alive)[:n_real]
    c = np.asarray(cap)[:n_real]
    sched = (a > 0) & (c > 0)
    order = np.lexsort((np.asarray(load)[:n_real], ~sched))
    n_sched = int(sched.sum())
    cycle = order[:n_sched] if n_sched > 0 else order
    return cycle[np.arange(count) % len(cycle)].astype(np.int32)


def _route_unseatable(
    assignment: np.ndarray, n_real: int, load: np.ndarray, alive, cap
) -> np.ndarray:
    """Defensive clamp: solver output must index the REAL node axis.

    Solvers run over the padded power-of-two node axis; pad slots carry
    zero capacity and are normally unreachable. If a degenerate numerical
    case ever clips a row onto a pad slot, the row goes through the shared
    spread instead of entering the directory (a pad index would break
    every later ``_node_order[idx]`` resolution).
    """
    bad = assignment >= n_real
    if not bad.any():
        return assignment
    out = assignment.copy()
    out[bad] = _least_loaded_spread(
        load, alive, cap, n_real, int(bad.sum())
    ).astype(assignment.dtype)
    return out


def _class_refresh_device(base, counts, cap_alive, g_seed, *, mode, move_cost, eps, n_iters):
    """Warm M x M class potential refresh: ``(g, err)`` on the device.

    A plain function: the JAX provider jits it per (mode, shapes, config),
    and eager PyTorch has nothing to trace."""
    m = base.shape[0]
    ccost = base[None, :].expand(m, m) - move_cost * torch.eye(
        m, dtype=torch.float32, device=base.device
    )
    solver = scaling_sinkhorn if mode == "scaling" else sinkhorn
    _f, g, err = solver(ccost, counts, cap_alive, eps=eps, n_iters=n_iters, g_init=g_seed)
    return g, err


# -- affinity refine helpers ----------------------------------------------------


def _host_ids(hosts: list[str]) -> np.ndarray:
    """Each entry's index among the distinct hosts in order of first
    appearance (int64): the JAX provider's
    ``list(dict.fromkeys(hosts)).index(h)`` in one O(m) pass."""
    first: dict[str, int] = {}
    return np.asarray([first.setdefault(h, len(first)) for h in hosts], np.int64)


def _attraction(
    rows: np.ndarray, dst_seats: np.ndarray, w: np.ndarray, hfac: torch.Tensor, n_rows: int
) -> torch.Tensor:
    """(n_rows, m) float32 attraction on ``hfac``'s device: row ``rows[e]``
    gains ``w[e] * hfac[dst_seats[e]]`` for every edge ``e``.

    The JAX provider's ``np.add.at(attract, rows, w[:, None] *
    hfac[dst_seats])`` without a float scatter on the device (CUDA's
    atomics sum in a different order on every run): each edge's weight is
    summed on the host, in edge order, into its (row, destination seat)
    cell, at most one cell an edge; the cells are written into an
    (n_rows, m) weight matrix, and one matrix product by ``hfac`` spreads
    each seat's weight over the seats it credits. Two runs give the same
    bits; against the reference the sums differ in order only, by float32
    rounding.
    """
    m = hfac.shape[0]
    cells, slot = np.unique(rows.astype(np.int64) * m + dst_seats, return_inverse=True)
    sums = np.zeros(cells.shape, np.float32)
    np.add.at(sums, slot, w)
    dev = hfac.device
    weights = torch.zeros(n_rows * m, dtype=torch.float32, device=dev)
    weights[torch.from_numpy(cells).to(dev)] = torch.from_numpy(sums).to(dev)
    return weights.view(n_rows, m) @ hfac


def _truncate_movers(
    new: torch.Tensor, old: torch.Tensor, gain: torch.Tensor, col_cap: torch.Tensor
) -> torch.Tensor:
    """Integer capacity enforcement of one refine pass.

    Objects moving INTO column ``c`` keep their move while they rank below
    ``floor(col_cap[c] - stayers[c])`` (stayers: objects whose seat is
    ``c`` before and after), ranked by gain, highest first, ties by index;
    the rest return to ``old``. The JAX provider loops over the columns
    with ``argsort(-gain, kind="stable")``; here one stable sort by gain
    and one by column (:func:`rank_within_group`) rank every mover at once,
    with the same result. ``col_cap`` is float64, as the reference's.
    """
    moving = new != old
    stayers = torch.bincount(old[~moving], minlength=col_cap.shape[0])
    allowed = torch.floor(col_cap - stayers).clamp_min(0.0)
    idx = torch.nonzero(moving).squeeze(1)
    if idx.numel() == 0:
        return new
    # + 0.0 turns -0.0 into 0.0: a radix sort would order the two apart.
    by_gain = idx[torch.argsort(-gain[idx] + 0.0, stable=True)]
    order, cols, rank = rank_within_group(new[by_gain])
    revert = by_gain[order][rank >= allowed[cols]]
    out = new.clone()
    out[revert] = old[revert]
    return out


# -- solver convergence telemetry helpers -------------------------------------


def _seed_warm_ratio(seed) -> float:
    """Warm fraction of a potential seed (a tensor or a host array):
    finite entries / total.

    The solvers cold-fill non-finite seed entries to zero, so the finite
    fraction IS the warm-start hit ratio. No seed at all reads as 0.0.
    """
    if seed is None:
        return 0.0
    seed = torch.as_tensor(seed)
    if seed.numel() == 0:
        return 0.0
    return float(torch.isfinite(seed).float().mean().cpu())


def _conv_fields(conv: dict) -> dict:
    """A solve's convergence record as SolveStats kwargs.

    ``compile_ms`` and ``exec_ms`` keep their -1 ("unobserved"): eager
    PyTorch compiles nothing per solve (the port's CUDA kernels are built
    once, outside any solve). ``chunks``, ``chunk_ms`` and ``devices`` come
    from the hierarchical solve.
    """
    return {
        "solver_iters": int(conv.get("solver_iters", 0)),
        "residual": float(conv.get("residual", -1.0)),
        "warm_ratio": float(conv.get("warm_ratio", -1.0)),
        "chunks": int(conv.get("chunks", 0)),
        "chunk_ms": [float(x) for x in conv.get("chunk_ms", ())],
        "devices": int(conv.get("devices", 0)),
    }


def _elapsed_ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _apply_class_quotas(quotas: np.ndarray, cur_idx: np.ndarray) -> np.ndarray:
    """Expand (M x M) class quotas into a per-object assignment, O(N + M^2).

    Objects within a class (= current seat) are interchangeable, so laying
    each class's own column FIRST keeps ``quotas[k, k]`` objects exactly
    where they are — the host reference of
    :func:`rio_tpu_torch.ops.structured.expand_class_quotas`.
    """
    m = quotas.shape[0]
    out = np.empty(cur_idx.shape[0], np.int32)
    order = np.argsort(cur_idx, kind="stable")
    counts = np.bincount(cur_idx, minlength=m)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    all_cols = np.arange(m)
    for k in range(m):
        c = int(counts[k])
        if c == 0:
            continue
        cols = np.concatenate([[k], np.delete(all_cols, k)])
        targets = np.repeat(cols, quotas[k][cols])
        if targets.shape[0] < c:  # belt-and-braces vs float drift upstream
            targets = np.concatenate(
                [targets, np.full(c - targets.shape[0], k, np.int32)]
            )
        out[order[start[k] : start[k] + c]] = targets[:c]
    return out


# Anti-affinity penalty for the multi-seat (replica) solve: far beyond the
# exp underflow knee relative to the default eps; the log-domain sinkhorn
# used below is stable at any range.
_ANTI_AFFINITY_COST = 1e4


def _unique_rows(taken: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(taken, axis=0, return_inverse=True)`` for a 2-D bool array.

    Each row is packed to bits (column 0 in the most significant bit) and
    compared as one opaque byte string: byte order then equals the
    lexicographic row order ``np.unique`` sorts by, so classes and inverse
    are the same, without its per-column structured sort (seconds at
    65,536 x 1,024)."""
    packed = np.ascontiguousarray(np.packbits(taken, axis=1))
    rows = packed.view(np.dtype((np.void, packed.shape[1]))).reshape(-1)
    _, first, inverse = np.unique(rows, return_index=True, return_inverse=True)
    return taken[first], inverse.reshape(-1)


def multi_seat_plan(
    primary_idx: np.ndarray,
    k: int,
    load: np.ndarray,
    cap: np.ndarray,
    alive: np.ndarray,
    *,
    eps: float = 0.05,
    n_iters: int = 30,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """K standby seats per object under hard anti-affinity.

    Every object with the same *forbidden set* (primary + seats chosen in
    earlier rounds) has an identical cost row, so each of the K rounds is a
    class-collapsed ``(C x M)`` solve, not an ``(N x M)`` one. Each round
    runs the log-domain :func:`rio_tpu_torch.ops.sinkhorn.sinkhorn` on
    ``device`` (CUDA unless ``"cpu"`` is named) over the class cost with
    ``_ANTI_AFFINITY_COST`` on forbidden columns, then rounds each class's
    soft plan row to integer seat quotas by largest remainder. Forbidden
    columns are zeroed before rounding, so a primary and its standbys can
    NEVER co-locate; classes with no schedulable allowed column get their
    seat back as -1 (degraded replication, never a violation).

    Returns an ``(n, k)`` int32 array of node indices, -1 for unfillable
    seats. Pure function of its host snapshot inputs.
    """
    dev = resolve_device(device)
    primary_idx = np.asarray(primary_idx, np.int64)
    n = int(primary_idx.shape[0])
    m = int(cap.shape[0])
    seats = np.full((n, k), -1, np.int32)
    if n == 0 or k <= 0:
        return seats
    load = np.asarray(load, np.float32).copy()
    cap_alive = np.asarray(cap, np.float32) * (np.asarray(alive, np.float32) > 0)
    taken = np.zeros((n, m), bool)
    has_primary = (primary_idx >= 0) & (primary_idx < m)
    taken[np.arange(n)[has_primary], primary_idx[has_primary]] = True
    for r in range(k):
        classes, inverse = _unique_rows(taken)
        counts = np.bincount(inverse, minlength=classes.shape[0]).astype(np.float32)
        allowed = (~classes) & (cap_alive > 0)[None, :]
        solvable = allowed.any(axis=1)
        if not solvable.any():
            break
        # Load-aware base cost (fill ratio) + the anti-affinity wall.
        fill = load / np.maximum(cap_alive, 1e-6)
        cost = np.where(allowed, fill[None, :], _ANTI_AFFINITY_COST).astype(np.float32)
        res = sinkhorn(
            torch.from_numpy(cost).to(dev),
            torch.from_numpy((counts * solvable).astype(np.float32)).to(dev),
            torch.from_numpy(cap_alive).to(dev),
            eps=eps,
            n_iters=n_iters,
        )
        f = res.f.cpu().numpy().astype(np.float64)[:, None]
        g = res.g.cpu().numpy().astype(np.float64)[None, :]
        with np.errstate(invalid="ignore"):
            expo = np.where(np.isfinite(f) & np.isfinite(g), f + g - cost, -np.inf)
        weights = np.exp(np.clip(expo / eps, -80.0, 80.0)) * allowed
        for c in np.nonzero(solvable)[0]:
            rows_c = np.nonzero(inverse == c)[0]
            w = weights[c]
            if w.sum() <= 0:
                w = allowed[c].astype(np.float64)
            share = w / w.sum() * rows_c.shape[0]
            quota = np.floor(share).astype(np.int64)
            short = rows_c.shape[0] - int(quota.sum())
            if short > 0:
                rem_order = np.argsort(-(share - quota), kind="stable")
                quota[rem_order[:short]] += 1
            targets = np.repeat(np.arange(m), quota)[: rows_c.shape[0]]
            seats[rows_c, r] = targets
            taken[rows_c, targets] = True
            np.add.at(load, targets, 1.0)
    return seats


@dataclass
class _NodeSlot:
    address: str
    capacity: float = 1.0
    alive: bool = True
    cordoned: bool = False  # drained: serving, but priced out of the solver
    load: float = 0.0
    index: int = 0
    # Measured-load capacity multiplier from sync_load (ClusterLoadView):
    # 1.0 idle, down to 0.1 for an overloaded node, quantized so per-second
    # load reports don't thrash the solve epoch.
    reported_derate: float = 1.0


@dataclass
class PlanState:
    """The previous committed solve, persisted as a first-class object.

    A churn event re-solves ONLY the displaced + new objects against the
    plan's residual capacity, warm-starting the Sinkhorn potentials from
    here (see ``_delta_solve``). The full solve remains the fallback when
    the displaced fraction exceeds ``delta_threshold``, after
    ``max_delta_solves`` consecutive deltas, or when the transport-cost
    audit trips (``stale``). Immutable after construction and atomically
    swapped on ``self._plan`` under the provider lock.
    """

    # (node_axis,) node potentials of the committing solve (a tensor on the
    # provider's device; None for solves that produce none, e.g. greedy).
    g: torch.Tensor | None
    # (G,) coarse-stage group potentials of a hierarchical solve (host
    # numpy; None for flat solves): the next coarse stage's warm seed.
    coarse_g: np.ndarray | None
    # (node_axis,) PLANNED per-node seat counts at commit (diagnostic).
    seat_counts: np.ndarray
    epoch: int  # directory epoch the plan was committed at
    liveness_fp: frozenset  # schedulable node indices at commit
    delta_solves: int = 0  # consecutive deltas since the last full solve
    stale: bool = False  # quality audit tripped: next solve goes full


@dataclass
class SolveStats:
    """Diagnostics from the last re-solve (field for field the JAX provider's)."""

    n_objects: int = 0
    n_nodes: int = 0
    solve_ms: float = 0.0
    apply_ms: float = 0.0  # mover-only directory update (host, under lock)
    moved: int = 0
    # Objects the solve actually re-solved: the displaced set for a
    # "*+delta" solve, the whole directory for a full one.
    displaced: int = 0
    epoch: int = 0
    mode: str = "none"
    discarded: bool = False
    # -1 means "not applicable / unobserved" (greedy has no residual; the
    # port observes no compile time) — never 0, which reads as perfect.
    solver_iters: int = 0  # configured iterations (fixed-length loops)
    residual: float = -1.0  # final L1 column-marginal violation
    warm_ratio: float = -1.0  # finite fraction of the warm-start seed
    compile_ms: float = -1.0  # compile share of solve_ms
    exec_ms: float = -1.0  # solve_ms minus compile_ms
    chunks: int = 0  # hierarchical chunk count (0 = not a hierarchical solve)
    chunk_ms: list = field(default_factory=list)  # per-chunk wall ms (chunked solves)
    devices: int = 0  # shards of a hierarchical solve: 1 without a mesh (0 = not one)
    # Bounded record of prior completed solves (most recent last, each with
    # an empty history of its own).
    history: list = field(default_factory=list)

    HISTORY_LIMIT = 32

    def history_gauges(self) -> dict[str, float]:
        """Rolling solve-history summary, scrape-ready (the JAX gauge names)."""
        window = [*self.history, self] if self.mode != "none" else list(self.history)
        out = {"rio.placement_solve.history.len": float(len(window))}
        if not window:
            return out
        solves = [float(s.solve_ms) for s in window]
        out["rio.placement_solve.history.solve_ms_last"] = solves[-1]
        out["rio.placement_solve.history.solve_ms_mean"] = sum(solves) / len(solves)
        out["rio.placement_solve.history.solve_ms_max"] = max(solves)
        out["rio.placement_solve.history.moved_total"] = float(
            sum(int(s.moved) for s in window)
        )
        out["rio.placement_solve.history.delta_fraction"] = sum(
            1.0 for s in window if "delta" in str(s.mode)
        ) / len(window)
        out["rio.placement_solve.history.discarded_total"] = float(
            sum(1 for s in window if s.discarded)
        )
        residuals = [float(s.residual) for s in window if s.residual >= 0.0]
        if residuals:
            out["rio.placement_solve.history.residual_last"] = residuals[-1]
            out["rio.placement_solve.history.residual_max"] = max(residuals)
        compiles = [float(s.compile_ms) for s in window if s.compile_ms >= 0.0]
        if compiles:
            out["rio.placement_solve.history.compile_ms_total"] = sum(compiles)
        chunked = [s for s in window if int(s.chunks) > 0]
        if chunked:
            out["rio.placement_solve.history.chunks_last"] = float(chunked[-1].chunks)
            out["rio.placement_solve.history.chunks_max"] = float(
                max(int(s.chunks) for s in chunked)
            )
        meshed = [s for s in window if int(getattr(s, "devices", 0)) > 0]
        if meshed:
            out["rio.placement_solve.history.devices_last"] = float(meshed[-1].devices)
        first_chunks = [float(s.chunk_ms[0]) for s in window if s.chunk_ms]
        if first_chunks:
            out["rio.placement_solve.history.first_chunk_ms_last"] = first_chunks[-1]
            out["rio.placement_solve.history.first_chunk_ms_max"] = max(first_chunks)
        return out


class TorchObjectPlacement(ObjectPlacement):
    """Batched, device-solved object directory (drop-in ObjectPlacement)."""

    def __init__(
        self,
        *,
        eps: float = 0.05,
        n_iters: int = 30,
        mode: str = "auto",
        mesh=None,
        node_axis_size: int = 64,
        move_cost: float = 0.5,
        obj_features=None,
        node_features=None,
        affinity_tracker=None,
        object_costs=None,
        delta_threshold: float = 0.25,
        max_delta_solves: int = 8,
        delta_audit_ratio: float = 1.05,
        affinity_weight: float = 0.0,
        affinity_passes: int = 3,
        affinity_host_factor: float = 0.5,
        affinity_slack: float = 1.25,
        device: str | torch.device | None = None,
    ) -> None:
        if mode != "auto" and mode not in _SOLVER_MODES:
            raise ValueError(f"unknown placement mode {mode!r}")
        # Feature hooks and a tracker are read only by the hierarchical
        # solve: a flat mode would ignore them, so refuse at construction.
        # "auto" resolves to "hierarchical" when they are present.
        has_affinity = bool(obj_features or node_features or affinity_tracker)
        if has_affinity and mode not in ("hierarchical", "auto"):
            raise ValueError(
                "obj_features/node_features/affinity_tracker are only consumed "
                f'by mode="hierarchical" (got mode={mode!r})'
            )
        if mesh is not None:
            # The provider's own tensors live on the mesh's first device.
            if device is None:
                device = mesh.home
            elif torch.device(device).type != mesh.home.type:
                raise ValueError(f"device {device} is not of the mesh's type ({mesh.home.type})")
        self._mesh = mesh
        self.device = resolve_device(device)
        self._eps = eps
        self._n_iters = n_iters
        # Incremental (delta) rebalance knobs: a churn re-solve goes
        # through the delta path while the displaced fraction stays at or
        # below delta_threshold (0 disables deltas entirely), falls back
        # to a full solve after max_delta_solves consecutive deltas, and
        # whenever the transport-cost audit finds the delta plan worse than
        # delta_audit_ratio x the ideal quota cost.
        self._delta_threshold = delta_threshold
        self._max_delta_solves = max_delta_solves
        self._delta_audit_ratio = delta_audit_ratio
        self._mode = mode
        # Stay-put discount applied to each object's CURRENT seat during a
        # full re-solve: with move_cost/eps >> 1 only capacity pressure
        # (dead nodes, skew) moves anything.
        self._move_cost = move_cost
        self._has_affinity = has_affinity
        # Carrying the tracker lets the Server auto-wire
        # AffinityTracker.observe into its dispatch path.
        self.affinity_tracker = affinity_tracker
        if affinity_tracker is not None:
            if isinstance(affinity_tracker, AffinityTracker):
                # A tracker built without a device draws on the provider's.
                affinity_tracker._bind(self.device)
            obj_features = obj_features or affinity_tracker.obj_features
            node_features = node_features or affinity_tracker.node_features
        # Hierarchical-mode feature hooks: callables (keys/addresses ->
        # (n, d) numpy or tensor). The default is hashed identity, drawn on
        # the provider's device.
        hashed = functools.partial(_hash_features, device=self.device)
        self._obj_features = obj_features or hashed
        self._node_features = node_features or hashed
        # Per-object move prices (keys -> (n,) weights, 1.0 = baseline),
        # the tracker's measured move_weights by default: non-uniform
        # weights route flat solves through the dense (or at scale,
        # hierarchical) pipeline.
        if object_costs is None and affinity_tracker is not None:
            object_costs = affinity_tracker.move_weights
        self._object_costs = object_costs
        # Communication-graph refinement: after every FULL solve,
        # `affinity_passes` alternating linearized OT passes over the
        # edge-touching subset (_affinity_refine). Weight 0.0 disables it;
        # the delta paths never refine. host_factor is the attraction
        # credit for a different worker of the same host (the address up
        # to ":port"); slack lets a refined node overfill its fair share by
        # that factor (strictly balanced capacities block the simplest
        # co-location), with the acceptance check guarding the balance.
        self._affinity_weight = float(affinity_weight)
        self._affinity_passes = max(1, int(affinity_passes))
        self._affinity_host_factor = min(1.0, max(0.0, affinity_host_factor))
        self._affinity_slack = max(1.0, float(affinity_slack))
        # (src, dst) -> normalized byte-rate weight, undirected keys with
        # src < dst: set_edge_graph swaps in a fresh dict, the solver thread
        # snapshots the reference.
        self._edge_graph: dict[tuple[str, str], float] = {}
        # Per-refine pass history ([{pass, cut, total, accepted}, ...]),
        # swapped in whole: the monotonicity evidence tests and telemetry read.
        self._affinity_history: list[dict] = []
        # Host-mirrored directory: "{type}.{id}" -> node index.
        self._placements: dict[str, int] = {}
        # Replica rows: "{type}.{id}" -> (standby addresses, epoch).
        self._standby_rows: dict[str, tuple[list[str], int]] = {}
        # Per-node key index (node index -> keys): keeps clean_server and
        # load recounts O(objects-on-node).
        self._by_node: dict[int, set[str]] = {}
        self._nodes: dict[str, _NodeSlot] = {}
        self._node_order: list[str] = []  # index -> address (never shrinks)
        self._node_axis = node_axis_size  # static node axis (padded)
        self._epoch = 0
        self._g: torch.Tensor | None = None  # cached node potentials (padded axis)
        # Schedulable node indices the cached potentials were solved over
        # (see _invalidate_potentials).
        self._g_fp: frozenset | None = None
        self._plan: PlanState | None = None
        self._churn_listeners: list = []
        self._lock = asyncio.Lock()
        self.stats = SolveStats()

    def _solver_mode(self) -> str:
        """Resolve ``mode="auto"``: ``"hierarchical"`` when a locality signal
        (a tracker or feature hooks) is present, since it is the only mode
        that reads one; otherwise ``"sinkhorn"`` on a CUDA device and
        ``"greedy"`` on the CPU.

        The JAX provider makes the same accelerator/host split on
        ``jax.default_backend()``. On the card a full rebalance at
        1,048,576 x 1,024 is the class-collapsed Sinkhorn (an M x M solve
        plus O(N log N) expansion and repair on the device); on a host CPU
        the O(N log M) greedy waterfill is the cheaper default. The times
        behind the rule are ``chip_smoke.py``'s ``directory_full`` and
        ``directory_greedy`` phases (``PERF.md``).
        """
        if self._mode == "auto":
            if self._has_affinity:
                self._mode = "hierarchical"
            else:
                self._mode = "sinkhorn" if self.device.type == "cuda" else "greedy"
        return self._mode

    def _archived_history(self) -> list:
        """Current stats (if any solve/attempt happened) appended to its
        own history, flattened and bounded. Lock held by callers."""
        prior = self.stats
        if not prior.epoch:  # the never-solved default carries no event
            return []
        return (prior.history + [replace(prior, history=[])])[
            -SolveStats.HISTORY_LIMIT:
        ]

    # -------------------------------------------- potentials / churn events
    def _sched_fp(self) -> frozenset:
        """Indices of nodes that can take NEW seats right now (alive, not
        cordoned, capacity > 0)."""
        return frozenset(
            s.index
            for s in self._nodes.values()
            if s.alive and not s.cordoned and s.capacity > 0
        )

    def _invalidate_potentials(self) -> None:
        """Keep ``_g`` while every node it was solved over stays
        schedulable (churn on unrelated nodes leaves their entries at -inf,
        so the warm ``assign_batch`` path never seats there until the next
        solve); drop it when a solved-over node leaves the schedulable set."""
        if self._g is None:
            return
        if self._g_fp is None or not (self._g_fp <= self._sched_fp()):
            self._g = None
            self._g_fp = None

    def add_churn_listener(self, cb) -> None:
        """Register a zero-arg callable fired after every liveness-affecting
        change (``sync_members`` flips, ``cordon``/``uncordon``,
        ``clean_server``), on the event loop; listeners must only flag or
        schedule, never block."""
        self._churn_listeners.append(cb)

    def _notify_churn(self) -> None:
        for cb in list(self._churn_listeners):
            try:
                cb()
            except Exception:  # noqa: BLE001 - listeners never break liveness
                log.exception("churn listener failed")

    # ------------------------------------------------- directory internals
    def _set_placement(self, key: str, idx: int) -> bool:
        """Point ``key`` at node ``idx`` keeping the per-node index in sync.

        Returns True when the placement actually changed (lock held).
        """
        old = self._placements.get(key)
        if old == idx:
            return False
        if old is not None:
            self._by_node.get(old, set()).discard(key)
        self._placements[key] = idx
        self._by_node.setdefault(idx, set()).add(key)
        return True

    def _drop_placement(self, key: str) -> int | None:
        idx = self._placements.pop(key, None)
        if idx is not None:
            self._by_node.get(idx, set()).discard(key)
        return idx

    def _set_standby_row(self, key: str, addresses: list[str], epoch: int) -> None:
        self._standby_rows[key] = (list(addresses), epoch)

    def _drop_standby_row(self, key: str) -> None:
        self._standby_rows.pop(key, None)

    # ---------------------------------------------------------------- nodes
    def _node_index(self, address: str) -> int:
        slot = self._nodes.get(address)
        if slot is None:
            idx = len(self._node_order)
            if idx >= self._node_axis:
                # Grow the static node axis (rare). Cached potentials AND
                # the incremental plan carry old-axis shapes — both go.
                self._node_axis *= 2
                self._g = None
                self._g_fp = None
                self._plan = None
            slot = _NodeSlot(address=address, index=idx)
            self._nodes[address] = slot
            self._node_order.append(address)
            self._epoch += 1
        return slot.index

    def register_node(self, address: str, *, capacity: float = 1.0) -> None:
        self._node_index(address)
        self._nodes[address].capacity = capacity
        self._nodes[address].alive = True

    def sync_members(self, members) -> None:
        """Feed gossip liveness into the cost model.

        ``members`` is an iterable of objects with ``address`` (a property
        or a method) and ``active``, or of address strings. Unknown members
        are registered; known members get their liveness updated. Dead
        nodes keep their index but are priced out of the cost.
        """
        seen = set()
        changed = False
        for m in members:
            addr = getattr(m, "address", None)
            if callable(addr):
                addr = addr()
            if addr is None:
                addr = str(m)
            active = bool(getattr(m, "active", True))
            seen.add(addr)
            if addr not in self._nodes:
                self._node_index(addr)
                changed = True
            slot = self._nodes[addr]
            if slot.alive != active:
                slot.alive = active
                changed = True
        for addr, slot in self._nodes.items():
            if addr not in seen and slot.alive:
                slot.alive = False
                changed = True
        if changed:
            self._epoch += 1
            self._invalidate_potentials()
            self._notify_churn()

    # Derates quantize to 1/8 steps so per-tick load reports don't bump the
    # epoch (and discard in-flight solves) on every call.
    _DERATE_STEP = 8.0

    def sync_load(self, view) -> None:
        """Feed measured cluster load (a ``ClusterLoadView``: ``derate(addr)``)
        into the cost model: each node's capacity column becomes
        ``capacity * derate``. ``view=None`` resets every node."""
        changed = False
        for addr, slot in self._nodes.items():
            d = 1.0 if view is None else float(view.derate(addr))
            if not (d == d):  # NaN guard
                d = 1.0
            d = min(1.0, max(0.1, d))
            q = round(d * self._DERATE_STEP) / self._DERATE_STEP
            if q != slot.reported_derate:
                slot.reported_derate = q
                changed = True
        if changed:
            self._epoch += 1
            # Derates floor at 0.1: no node leaves the schedulable set here.
            self._invalidate_potentials()

    # --------------------------------------------------------------- drain
    def cordon(self, address: str) -> None:
        """Drain a node gracefully: it keeps serving its current objects,
        but the solver prices it like a dead node (no NEW seats), and the
        next ``rebalance()`` re-seats its population."""
        slot = self._nodes.get(address)
        if slot is None:
            raise KeyError(f"unknown node {address!r}")
        if slot.cordoned:
            return
        others = any(
            s.alive and not s.cordoned and s.capacity > 0
            for a, s in self._nodes.items()
            if a != address
        )
        if not others:
            raise RuntimeError(
                f"refusing to cordon {address!r}: no other schedulable "
                f"node would remain"
            )
        slot.cordoned = True
        self._epoch += 1
        self._invalidate_potentials()
        self._notify_churn()

    def uncordon(self, address: str) -> None:
        slot = self._nodes.get(address)
        if slot is None:
            raise KeyError(f"unknown node {address!r}")
        if slot.cordoned:
            slot.cordoned = False
            self._epoch += 1
            self._invalidate_potentials()
            self._notify_churn()

    @property
    def cordoned(self) -> set[str]:
        return {a for a, s in self._nodes.items() if s.cordoned}

    # ------------------------------------------------------- node vectors
    def _node_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(load, cap, alive)`` over the padded node axis, host float32.

        Capacity is ``capacity * derate``; cordoned nodes price exactly
        like dead ones (no NEW seats) while their rows stand."""
        n = self._node_axis
        load = np.zeros((n,), np.float32)
        cap = np.zeros((n,), np.float32)
        alive = np.zeros((n,), np.float32)
        for addr in self._node_order:
            s = self._nodes[addr]
            load[s.index] = s.load
            cap[s.index] = s.capacity * s.reported_derate
            alive[s.index] = 1.0 if (s.alive and not s.cordoned) else 0.0
        return load, cap, alive

    def _to_device(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.asarray(a)).to(self.device) for a in arrays)

    def _no_schedulable_capacity_host(self) -> bool:
        """Zero schedulable capacity, from HOST node state only."""
        return not any(
            s.alive and not s.cordoned and s.capacity > 0
            for s in self._nodes.values()
        )

    def _recount_loads(self) -> None:
        for s in self._nodes.values():
            s.load = float(len(self._by_node.get(s.index, ())))

    # ------------------------------------------------------ trait: lookups
    async def update(self, item: ObjectPlacementItem) -> None:
        key = str(item.object_id)
        async with self._lock:
            if item.server_address is None:
                self._drop_placement(key)
            else:
                self._set_placement(key, self._node_index(item.server_address))
            self._epoch += 1

    async def lookup(self, object_id: ObjectId) -> str | None:
        idx = self._placements.get(str(object_id))
        if idx is None:
            return None
        return self._node_order[idx]

    async def clean_server(self, address: str) -> None:
        async with self._lock:
            slot = self._nodes.get(address)
            if slot is None:
                return
            slot.alive = False
            slot.load = 0.0  # its placements are gone; keep fair-share math honest
            # O(objects-on-node) via the per-node index.
            for k in list(self._by_node.get(slot.index, ())):
                self._drop_placement(k)
            self._by_node.pop(slot.index, None)
            self._epoch += 1
            self._invalidate_potentials()
            self._notify_churn()

    async def remove(self, object_id: ObjectId) -> None:
        async with self._lock:
            key = str(object_id)
            if key in self._standby_rows:
                self._drop_standby_row(key)
            if self._drop_placement(key) is not None:
                self._epoch += 1

    def count(self) -> int:
        return len(self._placements)

    # ------------------------------------------------------- replica rows
    async def set_standbys(self, object_id: ObjectId, addresses: list[str]) -> int:
        key = str(object_id)
        async with self._lock:
            _, epoch = self._standby_rows.get(key, ([], 0))
            if addresses or epoch:
                self._set_standby_row(key, list(addresses), epoch)
            elif key in self._standby_rows:
                self._drop_standby_row(key)
            return epoch

    async def standbys(self, object_id: ObjectId) -> tuple[list[str], int]:
        held, epoch = self._standby_rows.get(str(object_id), ([], 0))
        return sanitize_standby_row(held, epoch)

    async def promote_standby(
        self, object_id: ObjectId, address: str, expected_epoch: int
    ) -> int | None:
        key = str(object_id)
        async with self._lock:
            held, epoch = self._standby_rows.get(key, ([], 0))
            if epoch != expected_epoch or address not in held:
                return None
            self._set_standby_row(key, [a for a in held if a != address], epoch + 1)
            self._set_placement(key, self._node_index(address))
            self._epoch += 1
            return epoch + 1

    async def assign_standbys(
        self, object_ids: list[ObjectId], k: int = 1
    ) -> list[list[str]]:
        """K anti-affinity standby seats per object (compute only — the
        caller persists the choice through :meth:`set_standbys`).

        Node vectors and primary seats are snapshotted under the lock on the
        loop; :func:`multi_seat_plan` runs in a thread on the snapshot.
        """
        if not object_ids or k <= 0:
            return [[] for _ in object_ids]
        async with self._lock:
            keys = [str(o) for o in object_ids]
            primary = np.asarray([self._placements.get(key, -1) for key in keys], np.int64)
            load, cap, alive = self._node_arrays()
            node_order = list(self._node_order)
            no_capacity = self._no_schedulable_capacity_host()
        if no_capacity:
            return [[] for _ in object_ids]
        seats = await asyncio.to_thread(
            multi_seat_plan, primary, k, load, cap, alive,
            eps=self._eps, n_iters=self._n_iters, device=self.device,
        )
        n_real = len(node_order)
        return [[node_order[j] for j in row if 0 <= j < n_real] for row in seats]

    # ------------------------------------------------------- batched solve
    async def lookup_batch(self, object_ids: list[ObjectId]) -> list[str | None]:
        out: list[str | None] = []
        for oid in object_ids:
            idx = self._placements.get(str(oid))
            out.append(None if idx is None else self._node_order[idx])
        return out

    async def assign_batch(self, object_ids: list[ObjectId]) -> list[str]:
        """Place a batch of (possibly new) objects, one device solve a chunk.

        Already-placed objects keep their seat; unplaced ones are waterfilled
        onto the nodes, biased by the cached node potentials of the last OT
        solve when there are any. The lock is taken PER CHUNK of
        ``_MAX_PLACE_CHUNK`` keys, so other mutators interleave between
        chunks; each chunk re-checks membership under its lock hold, and a
        last pass under one lock hold re-places keys that a concurrent
        ``remove``/``clean_server`` dropped between chunks.

        The call is the span ``placement_assign``; its ``lock_wait_ms`` is
        the time spent waiting for the lock (behind a rebalance's snapshot
        or apply, say).

        Raises :class:`rio_tpu_torch.errors.NoSchedulableCapacity` (a
        ``ValueError``) when no node has registered yet.
        """
        keys = [str(o) for o in object_ids]
        with span("placement_assign", n=len(keys)) as sp:
            waited = 0.0
            for start in range(0, len(keys), self._MAX_PLACE_CHUNK):
                chunk = keys[start : start + self._MAX_PLACE_CHUNK]
                t0 = time.perf_counter()
                async with self._lock:
                    waited += time.perf_counter() - t0
                    unplaced = [k for k in chunk if k not in self._placements]
                    if unplaced:
                        await self._place_chunk_locked(unplaced)
            t0 = time.perf_counter()
            async with self._lock:
                waited += time.perf_counter() - t0
                if sp is not None:
                    sp.attrs["lock_wait_ms"] = waited * 1e3
                missing = [k for k in keys if k not in self._placements]
                if missing:
                    await self._place_keys_async(missing)
                return [self._node_order[self._placements[k]] for k in keys]

    # Bounds the (bucket x node_axis) working set of one placement solve.
    # Chunk edges change the waterfill's result (it carries the updated
    # node load into the next chunk), so the value is the JAX provider's.
    _MAX_PLACE_CHUNK = 262_144

    async def _place_keys_async(self, keys: list[str]) -> None:
        """Chunked placement under a CALLER-held lock (straggler path)."""
        for start in range(0, len(keys), self._MAX_PLACE_CHUNK):
            await self._place_chunk_locked(keys[start : start + self._MAX_PLACE_CHUNK])

    async def _place_chunk_locked(self, chunk: list[str]) -> None:
        """One chunk's placement with the device solve OFF the event loop:
        node state and potentials are snapshotted on the loop, the solve
        runs in a thread against only those snapshots, and the host apply
        runs back on the loop. The caller holds ``self._lock``."""
        load, cap, alive = self._node_arrays()
        g = self._g
        n_real = len(self._node_order)
        no_capacity = self._no_schedulable_capacity_host()
        assignment = await asyncio.to_thread(
            self._solve_chunk, chunk, load, cap, alive, g, n_real, no_capacity
        )
        self._apply_chunk(chunk, assignment)

    def _solve_chunk(
        self, keys, load, cap, alive, g, n_real, no_capacity=False
    ) -> np.ndarray:
        """Device solve for one placement chunk over loop-side snapshots
        (host arrays in, host int32 seats out); reads NO live provider
        state, mutates nothing."""
        n = len(keys)
        if no_capacity:
            # Every node dead (or cordoned) at once: the waterfill
            # degenerates, so seat deterministically via the shared spread;
            # the next liveness change re-solves.
            return _least_loaded_spread(load, alive, cap, n_real, n)
        load_t, cap_t, alive_t = self._to_device(load, cap, alive)
        cost = build_cost_matrix(load_t, cap_t, alive_t)  # (1, n_nodes)
        if g is not None:
            # Warm path: bias the score by the cached node potentials from
            # the last OT solve, then waterfill.
            g = torch.where(torch.isfinite(g), g, -1e9)
            cost = cost - g[None, :]
        bucket = _next_bucket(n)
        rows = cost.expand(bucket, cost.shape[1])
        mass = torch.zeros(bucket, dtype=torch.float32, device=self.device)
        mass[:n] = 1.0
        seats = greedy_balanced_assign(rows, mass, cap_t * alive_t, load_t)
        return _route_unseatable(seats[:n].cpu().numpy(), n_real, load, alive, cap)

    def _apply_chunk(self, keys: list[str], assignment: np.ndarray) -> None:
        for k, idx in zip(keys, assignment.tolist()):
            self._set_placement(k, int(idx))
            self._nodes[self._node_order[idx]].load += 1.0
        self._epoch += 1

    # ------------------------------------------------- hierarchical solve
    def _build_obj_feat(
        self, keys: list[str], n_pad: int, node_order: list[str],
        cur_idx, move_cost: float, move_w,
    ) -> torch.Tensor:
        """Streamed (n_pad, d) float32 object-feature block on the device.

        The final block is allocated once and filled in key-chunks of
        ``_OBJ_FEAT_STREAM_ROWS``: per chunk the feature hook is called,
        its result sanitized (non-finite entries become 0.0: one NaN row
        would poison the coarse cost's std and with it every object's
        cost), the stay-put pull added, and the rows written in place. Pad
        rows (``n_pad - n``) come from the cached
        :func:`_pad_feature_block`; the caller slices them off.

        With ``move_cost > 0`` and current seats (a routed flat solve),
        each seated object's feature is pulled ``move_cost`` toward its
        seat's embedding (scaled by its price in ``move_w``): node
        embeddings are unit vectors whose cross-affinities are ~1/sqrt(d)
        noise, so the pull raises the current seat's affinity by about
        ``move_cost``, the feature-space analog of the flat path's
        stay-put discount.
        """
        n = len(keys)
        dev = self.device
        node_emb = None
        seat = None
        if move_cost > 0.0 and cur_idx is not None and node_order:
            node_emb = _feature_tensor(self._node_features(node_order), dev)
            seat = torch.from_numpy(np.asarray(cur_idx, np.int64)).to(dev)
        out: torch.Tensor | None = None
        step = max(1, _OBJ_FEAT_STREAM_ROWS)
        for start in range(0, n, step):
            chunk_keys = keys[start : start + step]
            stop = start + len(chunk_keys)
            feats = _feature_tensor(self._obj_features(chunk_keys), dev)
            if not bool(torch.isfinite(feats).all()):
                feats = torch.nan_to_num(feats, nan=0.0, posinf=0.0, neginf=0.0)
            if out is None:
                out = torch.empty((n_pad, feats.shape[1]), dtype=torch.float32, device=dev)
            if node_emb is not None:
                s = seat[start:stop]
                seated = (s >= 0) & (s < len(node_order))
                pull = torch.zeros_like(feats)
                pull[seated] = node_emb[s[seated]]
                if move_w is not None:
                    # A hot/heavy object's pull scales with its price, as
                    # the dense path's stay-put discount does.
                    pull *= _feature_tensor(move_w[start:stop], dev)[:, None]
                feats = feats + move_cost * pull
            out[start:stop] = feats
        if out is None:  # empty directory: width from the hook's contract
            probe = self._obj_features([])
            if not isinstance(probe, torch.Tensor):
                probe = np.asarray(probe, np.float32)
            d = probe.shape[1] if probe.ndim == 2 else _FEAT_DIM
            out = torch.empty((n_pad, d), dtype=torch.float32, device=dev)
        if n_pad > n:
            out[n:] = _pad_feature_block(n_pad - n, out.shape[1], dev)
        return out

    def _hierarchical_solve(
        self, keys: list[str], node_order: list[str], cap, alive,
        cur_idx=None, move_cost: float = 0.0, move_w=None, coarse_g_init=None,
    ):
        """Two-level OT re-solve over object and node features.

        O(n x (groups + group_size + d)) on the device instead of the flat
        modes' (bucket x node_axis) cost (see
        :mod:`rio_tpu_torch.parallel.hierarchical`). Reads only the
        lock-snapshotted ``node_order``/``cap``/``alive``.

        ``cur_idx``/``move_cost``/``move_w`` carry a routed flat solve's
        stay-put semantics into feature space (:meth:`_build_obj_feat`);
        native ``mode="hierarchical"`` solves pass none (the tracker's
        learned features are the stickiness there). ``coarse_g_init``
        warm-starts the coarse stage when its length is this solve's group
        count. Returns ``(assignment, g, coarse_g, conv)``: host int32 seats
        of the ``len(keys)`` objects, no flat node potentials (None), the
        coarse stage's (n_groups,) host potentials, and the convergence
        record SolveStats surfaces.
        """
        dev = self.device
        # A COMPACT node axis (real nodes padded to a group multiple), not
        # the static one: trailing all-dead groups would concentrate the
        # coarse quotas into the few live groups and overflow their buckets.
        m_real = max(1, len(node_order))
        group_size = 8
        m = -(-m_real // group_size) * group_size
        n_groups = m // group_size
        cap_np = np.zeros((m,), np.float32)
        alive_np = np.zeros((m,), np.float32)
        cap_np[:m_real] = np.asarray(cap, np.float32)[:m_real]
        alive_np[:m_real] = np.asarray(alive, np.float32)[:m_real]
        # The object axis pads to a power-of-two bucket (the JAX provider's
        # bounded set of shapes), then up to a multiple of the mesh's
        # shards; pad rows spread under the capacity marginals like real
        # rows and are sliced off at the end.
        n = len(keys)
        n_shards = 1 if self._mesh is None else int(self._mesh.devices.size)
        n_pad = -(-_next_bucket(n) // n_shards) * n_shards
        per_dev = n_pad // n_shards
        # Shards divide the rows first; chunks halve each shard's rows while
        # they exceed _HIER_CHUNK_ROWS.
        n_chunks = 1
        while per_dev // n_chunks > _HIER_CHUNK_ROWS and (per_dev // n_chunks) % 2 == 0:
            n_chunks *= 2
        # Each (shard, chunk) cell solves rows_cell rows; the fine bucket
        # comes from them and the fullest group's capacity share, quantized
        # to a power of two.
        rows_cell = per_dev // n_chunks
        live_cap = (cap_np * alive_np).reshape(n_groups, group_size).sum(axis=1)
        share = live_cap.max() / max(live_cap.sum(), 1e-9)
        bucket_sz = _next_bucket(max(8, int(1.3 * rows_cell * float(share))), minimum=8)

        obj_feat = self._build_obj_feat(keys, n_pad, node_order, cur_idx, move_cost, move_w)
        d_feat = obj_feat.shape[1]
        node_feat = torch.zeros((d_feat, m), dtype=torch.float32, device=dev)
        if node_order:
            nf = _feature_tensor(self._node_features(node_order), dev)
            assert nf.shape[1] == d_feat, (
                f"node feature dim {nf.shape[1]} != object feature dim {d_feat}"
            )
            if not bool(torch.isfinite(nf).all()):
                nf = torch.nan_to_num(nf, nan=0.0, posinf=0.0, neginf=0.0)
            node_feat[:, : len(node_order)] = nf.T
        kw = dict(
            n_groups=n_groups,
            bucket=min(bucket_sz, rows_cell),
            eps=self._eps,
            coarse_iters=self._n_iters,
            fine_iters=self._n_iters,
        )
        # Warm coarse seed only while the group axis still matches; cold
        # start IS the zero seed.
        if coarse_g_init is None or np.asarray(coarse_g_init).shape != (n_groups,):
            warm_ratio = 0.0
            coarse_g_init = np.zeros((n_groups,), np.float32)
        else:
            warm_ratio = _seed_warm_ratio(coarse_g_init)
        conv: dict = {
            "solver_iters": 2 * self._n_iters,  # coarse + fine stages
            "warm_ratio": warm_ratio,
            "chunks": n_chunks,
            "devices": n_shards,
        }
        cap_t, alive_t, seed_t = self._to_device(
            cap_np, alive_np, np.asarray(coarse_g_init, np.float32)
        )
        if self._mesh is not None:
            # The object axis over the mesh, each shard in n_chunks cells
            # when it is large; the warm seed threads in and the mean over
            # shards comes back.
            if n_chunks > 1:
                conv["mode_suffix"] = "+mesh_chunk"
                res, conv["chunk_ms"] = mesh_chunked_hierarchical_assign_timed(
                    self._mesh, obj_feat, node_feat, cap_t, alive_t, n_chunks=n_chunks,
                    coarse_g_init=seed_t, **kw,
                )
            else:
                res = sharded_hierarchical_assign(
                    self._mesh, obj_feat, node_feat, cap_t, alive_t, coarse_g_init=seed_t, **kw
                )
        elif n_chunks > 1:
            res, conv["chunk_ms"] = chunked_hierarchical_assign_timed(
                obj_feat, node_feat, cap_t, alive_t, n_chunks=n_chunks,
                coarse_g_init=seed_t, **kw,
            )
        else:
            res = hierarchical_assign(
                obj_feat, node_feat, cap_t, alive_t, coarse_g_init=seed_t, **kw
            )
        assignment = res.assignment[:n].cpu().numpy()
        conv["residual"] = float(res.coarse_err.cpu())
        return assignment, None, res.coarse_g.cpu().numpy(), conv

    # ---------------------------------------------------- incremental solve
    def _delta_gates_ok(self, plan: PlanState | None, force: bool) -> bool:
        """A plan must exist; ``force`` overrides the rest (threshold
        disabled, plan marked stale, ``max_delta_solves`` consecutive
        deltas)."""
        if plan is None:
            return False
        if force:
            return True
        if self._delta_threshold <= 0.0 or plan.stale:
            return False
        return plan.delta_solves < self._max_delta_solves

    def _class_refresh(self, cap, alive, counts_np, cap_alive, mode, plan):
        """Warm potential refresh at the class shape (M x M), seeded with the
        plan's potentials. Host arrays in; returns ``(g, score, err)``: the
        new column potentials (device), the per-node host fill score, and
        the refresh's scalar residual. A missing seed is passed as zeros:
        cold start IS the zero seed in both solver forms."""
        cap_t, alive_t = self._to_device(cap, alive)
        base = build_cost_matrix(torch.zeros_like(cap_t), cap_t, alive_t)[0]
        g_seed = torch.zeros_like(base) if plan.g is None else plan.g
        counts_t, cap_alive_t = self._to_device(
            np.asarray(counts_np, np.float32), cap_alive.astype(np.float32)
        )
        g_r, err = _class_refresh_device(
            base, counts_t, cap_alive_t, g_seed,
            mode=mode,
            move_cost=self._move_cost,
            eps=min(self._eps, self._move_cost / 25.0 if self._move_cost > 0 else self._eps),
            n_iters=max(4, min(8, self._n_iters)),
        )
        g_np = g_r.cpu().numpy().astype(np.float64)
        score = base.cpu().numpy().astype(np.float64) - np.where(
            np.isfinite(g_np), g_np, -1e30
        )
        return g_r, score, float(err.cpu())

    def _delta_fast_snapshot(self, plan, n, cap, alive, force):
        """O(displaced) delta snapshot, taken under the provider lock.

        For nodes LEAVING the schedulable set with every survivor at or
        under its integer fair quota, the displaced set is exactly the
        departed nodes' seats, which ``_by_node`` already holds: the event
        costs O(displaced + M^2) instead of the O(N) key/seat snapshot.
        Returns None whenever per-seat decisions could matter (a survivor
        over quota needs rank-based eviction).
        """
        if not self._delta_gates_ok(plan, force):
            return None
        cap_alive = np.asarray(cap, np.float64) * (np.asarray(alive, np.float64) > 0)
        m = cap_alive.shape[0]
        sched = cap_alive > 0.0
        counts = np.zeros(m, np.int64)
        for j, seats in self._by_node.items():
            if j < m:
                counts[j] = len(seats)
        quota = integer_fair_quotas(cap_alive, n)
        if np.any(sched & (counts > quota)):
            return None  # over-quota eviction: needs per-seat ranks
        disp_nodes = np.nonzero(~sched & (counts > 0))[0]
        d = int(counts[disp_nodes].sum())
        if not force and d > self._delta_threshold * n:
            return None
        disp: list[tuple[str, int]] = []
        for j in disp_nodes.tolist():
            disp.extend((k, j) for k in self._by_node.get(j, ()))
        retained = np.where(sched, counts, 0)
        return {
            "disp": disp,
            "counts": counts,
            "cap_alive": cap_alive,
            "quota": quota,
            "retained": retained,
            "residual": quota - retained,
            "d": d,
        }

    def _audit(self, counts_after: np.ndarray, quota: np.ndarray, cap_alive: np.ndarray) -> bool:
        """Transport-cost audit (quadratic congestion proxy): True (stale)
        when the achieved seating costs more than ``delta_audit_ratio`` x
        the integer-quota ideal. Unschedulable nodes get a tiny capacity
        floor, so any stray seat there trips it."""
        safe_cap = np.maximum(cap_alive, 1e-9)
        num = float(np.sum(counts_after.astype(np.float64) ** 2 / safe_cap))
        den = float(np.sum(quota.astype(np.float64) ** 2 / safe_cap))
        return bool(den > 0.0 and num > self._delta_audit_ratio * den)

    def _hierarchical_fill(self, disp_keys, node_order, residual, load, plan: PlanState):
        """Both delta paths' hierarchical fill: the displaced keys through the
        two-level solve against the residual quotas, warm from the plan's
        coarse potentials. Returns ``(fill, coarse_g, conv)``, ``fill`` host
        int32 seats on the real node axis."""
        res_cap = residual.astype(np.float32)
        res_alive = (residual > 0).astype(np.float32)
        fill, _, coarse_g, conv = self._hierarchical_solve(
            disp_keys, node_order, res_cap, res_alive, coarse_g_init=plan.coarse_g
        )
        fill = _route_unseatable(
            np.asarray(fill, np.int32), len(node_order), load, res_alive, res_cap
        )
        return fill, coarse_g, conv

    async def _delta_fast_rebalance(
        self, fast, *, n, mode, move_sink, load, cap, alive, node_order, plan, snapshot_epoch,
    ) -> int:
        """Solve + commit an O(displaced) fast delta (see
        :meth:`_delta_fast_snapshot`): device work off the event loop, epoch
        re-checked under the lock before apply, discarded attempts
        recorded."""
        solved_as = f"{mode}+delta"
        disp = fast["disp"]
        d = fast["d"]
        residual = fast["residual"]
        cap_alive = fast["cap_alive"]
        quota = fast["quota"]
        retained = fast["retained"]
        m = cap_alive.shape[0]
        sched = cap_alive > 0.0

        def _solve():
            t0 = time.perf_counter()
            with span("placement_solve", mode=solved_as, n=n):
                g_new = None
                coarse_new = None
                conv: dict = {}
                if d == 0:
                    # Nothing displaced (pure load jitter): the plan stands.
                    fill = np.zeros((0,), np.int32)
                elif mode == "hierarchical":
                    fill, coarse_new, conv = self._hierarchical_fill(
                        [k for k, _ in disp], node_order, residual, load, plan
                    )
                else:
                    if mode in ("sinkhorn", "scaling"):
                        g_new, score, ref_err = self._class_refresh(
                            cap, alive, fast["counts"], cap_alive, mode, plan,
                        )
                        conv = {
                            "solver_iters": max(4, min(8, self._n_iters)),
                            "residual": ref_err,
                            "warm_ratio": _seed_warm_ratio(plan.g),
                        }
                    else:
                        score = np.where(sched, retained / np.maximum(quota, 1), 1e18)
                    fill = residual_capacity_assign(score, residual)
                counts_after = (retained + np.bincount(fill, minlength=m)).astype(np.float64)
                stale = self._audit(counts_after, quota, cap_alive)
                return fill, g_new, coarse_new, _elapsed_ms(t0), stale, counts_after, conv

        fill, g, coarse_g, solve_ms, stale, counts_after, conv = await asyncio.to_thread(_solve)

        async with self._lock:
            if self._epoch != snapshot_epoch:
                self.stats = SolveStats(
                    n_objects=n,
                    n_nodes=len(self._node_order),
                    solve_ms=solve_ms,
                    displaced=d,
                    epoch=self._epoch,
                    mode=solved_as,
                    discarded=True,
                    history=self._archived_history(),
                    **_conv_fields(conv),
                )
                return 0
            hist = self._archived_history()
            t_apply = time.perf_counter()
            with span("placement_apply", mode=solved_as, n=n):
                moved = 0
                planned: list[tuple[str, str, str]] = []
                for (key, old_idx), new_idx in zip(disp, fill.tolist()):
                    if move_sink is not None:
                        planned.append((key, node_order[old_idx], node_order[int(new_idx)]))
                    elif self._set_placement(key, int(new_idx)):
                        moved += 1
                if move_sink is not None:
                    moved = len(planned)
                if g is not None:
                    self._g = g
                    self._g_fp = self._sched_fp()
                self._recount_loads()
            self._epoch += 1
            self._plan = PlanState(
                g=g if g is not None else plan.g,
                coarse_g=coarse_g if coarse_g is not None else plan.coarse_g,
                seat_counts=np.asarray(counts_after, np.int64),
                epoch=self._epoch,
                liveness_fp=self._sched_fp(),
                delta_solves=plan.delta_solves + 1,
                stale=stale,
            )
            self.stats = SolveStats(
                n_objects=n,
                n_nodes=len(self._node_order),
                solve_ms=solve_ms,
                apply_ms=(time.perf_counter() - t_apply) * 1e3,
                moved=moved,
                displaced=d,
                epoch=self._epoch,
                mode=solved_as,
                discarded=False,
                history=hist,
                **_conv_fields(conv),
            )
        if planned:
            planned.sort(key=lambda mv: (mv[1], mv[2]))
            # Outside the lock on purpose: handoffs call back into
            # update()/lookup(), which take it.
            await move_sink(planned)
        return moved

    def _delta_solve(
        self, keys, cur_idx, load, cap, alive, node_order, plan: PlanState, mode: str,
        obj_w, force: bool,
    ):
        """Delta rebalance: re-solve ONLY the displaced objects against
        residual capacity, warm-starting from the previous plan.

        The displaced set is every seat on a node that left the schedulable
        set plus the over-quota overflow on surviving nodes (per-seat rank
        beyond the node's integer fair quota; with per-object prices the
        heavy objects rank first and are kept). Undisplaced objects keep
        their seats by construction, and the fill targets each node's
        residual quota, so the result lands on exactly the integer per-node
        counts of ``integer_fair_quotas``. Host numpy around one M x M warm
        refresh, or, in hierarchical mode, the displaced keys through the
        two-level solve against the residual quotas. Returns ``(assignment,
        g, coarse_g, displaced, stale, conv)``, or None when a gate says this
        event needs the full solve.
        """
        n = int(cur_idx.shape[0])
        if n == 0 or not self._delta_gates_ok(plan, force):
            return None
        cap_alive = np.asarray(cap, np.float64) * (np.asarray(alive, np.float64) > 0)
        m = cap_alive.shape[0]
        sched = cap_alive > 0.0
        quota = integer_fair_quotas(cap_alive, n)  # (m,), sums to n exactly
        cur = np.asarray(cur_idx, np.int64)
        # Rank each object within its current seat's population (one stable
        # sort); heavy/hot objects first when prices are given.
        if obj_w is not None:
            order = np.lexsort((-np.asarray(obj_w, np.float64), cur))
        else:
            order = np.argsort(cur, kind="stable")
        sorted_seats = cur[order]
        starts = np.searchsorted(sorted_seats, np.arange(m))
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - starts[sorted_seats]
        keep = sched[cur] & (rank < quota[cur])
        disp_pos = np.nonzero(~keep)[0]
        d = int(disp_pos.shape[0])
        if d == 0:
            # Nothing displaced (e.g. a node RETURNED): the plan stands.
            return cur.astype(np.int32), None, None, 0, False, {}
        if not force and d > self._delta_threshold * n:
            return None
        # retained[j] = min(counts[j], quota[j]) on schedulable nodes, 0
        # elsewhere; residual >= 0 and sums to d exactly.
        retained = np.bincount(cur[keep], minlength=m)
        residual = quota - retained

        g_new = None
        coarse_new = None
        conv: dict = {}
        if mode == "hierarchical":
            fill, coarse_new, conv = self._hierarchical_fill(
                [keys[i] for i in disp_pos.tolist()], node_order, residual, load, plan
            )
        else:
            if mode in ("sinkhorn", "scaling"):
                g_new, score, ref_err = self._class_refresh(
                    cap, alive, np.bincount(cur, minlength=m), cap_alive, mode, plan,
                )
                conv = {
                    "solver_iters": max(4, min(8, self._n_iters)),
                    "residual": ref_err,
                    "warm_ratio": _seed_warm_ratio(plan.g),
                }
            else:
                # Greedy has no potentials: order nodes by how full their
                # retained population already is.
                score = np.where(sched, retained / np.maximum(quota, 1), 1e18)
            fill = residual_capacity_assign(score, residual)
        out = cur.astype(np.int32).copy()
        out[disp_pos] = fill
        # Transport-cost audit: the flat fills hit the quotas exactly; the
        # hierarchical fill is capacity-proportional per group and can
        # drift, and a tripped audit sends the next solve full.
        stale = self._audit(np.bincount(out, minlength=m), quota, cap_alive)
        return out, g_new, coarse_new, d, stale, conv

    # ------------------------------------------------ communication graph
    def set_edge_graph(self, rows) -> int:
        """Install the cluster-merged communication graph.

        ``rows`` is the ``merge_edges`` shape (``[src, dst, bytes_per_s,
        calls_per_s, local_frac]``, extra columns optional). Client edges,
        self-edges and zero-rate rows are dropped; the rest are symmetrized,
        weighted as bytes/s plus 64 B per call, and normalized so the
        heaviest edge is 1.0. Returns the edge count. The next full solve
        refines against it when ``affinity_weight > 0``."""
        edges: dict[tuple[str, str], float] = {}
        for r in rows or ():
            src, dst = str(r[0]), str(r[1])
            if src == "client" or src == dst:
                continue
            bps = max(0.0, float(r[2]))
            cps = max(0.0, float(r[3])) if len(r) > 3 else 0.0
            w = bps + 64.0 * cps
            if w <= 0.0:
                continue
            key = (src, dst) if src < dst else (dst, src)
            edges[key] = edges.get(key, 0.0) + w
        if edges:
            top = max(edges.values())
            edges = {k: v / top for k, v in edges.items()}
        self._edge_graph = edges
        return len(edges)

    def _affinity_refine(self, keys, assignment, node_order, cap, alive):
        """Alternating linearized OT refinement over the edge graph.

        Runs in the solver thread after a FULL solve (the JAX provider's
        ``_affinity_refine``). Each pass linearizes the quadratic
        co-location objective around the current assignment: an object's
        attraction to node ``a`` is the edge-weighted sum of
        ``hfac[a, seat(neighbor)]`` (1.0 same worker, host_factor same
        host, 0.0 cross-host), folded into its cost row as a discount, and
        the Sinkhorn core solves the rows of the edge-touching subset
        (capped at ``_AFFINITY_MAX_ROWS`` heaviest, padded to a power-of-two
        bucket with zero-mass rows). A pass is accepted only if both the
        edge-cut transport cost and the total objective (capacity overflow
        + weighted cut) are non-increasing.

        The split: what decides acceptance stays on the host in the
        reference's numpy dtypes and order (edge arrays, degrees, subset,
        orientation, capacities, ``_cut``/``_total``: the test is
        ``<= prev + 1e-9`` on values near 1, finer than float32 resolution);
        each pass's (bucket x m) work runs on the provider's device
        (attraction, cost rows, ``sinkhorn``, ``plan_rounded_assign``, the
        bad-seat mask and the mover truncation), one pull of the new seats
        ending it. Spans ``affinity_refine_prep`` (with
        ``affinity_refine_index``: the key index and the edge lookup inside
        it) and ``affinity_refine_pass`` time the two.

        Returns the refined assignment (np.int32, length n) or None when
        the graph touches no key of this directory or no pass changed a
        seat.
        """
        edges = self._edge_graph  # atomic snapshot
        w_aff = self._affinity_weight
        n = len(keys)
        dev = self.device
        with span("affinity_refine_prep", n=n, edges=len(edges)):
            with span("affinity_refine_index", n=n, edges=len(edges)):
                key_ix = {k: i for i, k in enumerate(keys)}
                ei: list[int] = []
                ej: list[int] = []
                ew: list[float] = []
                for (a, b), w in edges.items():
                    ia = key_ix.get(a)
                    ib = key_ix.get(b)
                    if ia is None or ib is None:
                        continue
                    ei.append(ia)
                    ej.append(ib)
                    ew.append(w)
                del key_ix
            if not ei:
                return None
            # Each undirected edge twice, so one sum gathers every object's
            # full neighbourhood.
            e_src = np.asarray(ei + ej, np.int64)
            e_dst = np.asarray(ej + ei, np.int64)
            e_w = np.asarray(ew + ew, np.float32)

            cap_np = np.asarray(cap, np.float32)
            alive_np = np.asarray(alive, np.float32)
            m = cap_np.shape[0]
            # The host is the address up to ":port"; padded columns get
            # unique tokens, so their host mask is the identity.
            hosts = [
                node_order[i].rsplit(":", 1)[0] if i < len(node_order) else f"\x00pad{i}"
                for i in range(m)
            ]
            host_id = _host_ids(hosts)
            hf = self._affinity_host_factor
            same_host = (host_id[:, None] == host_id[None, :]).astype(np.float32)
            hfac = hf * same_host
            np.fill_diagonal(hfac, 1.0)
            dist = 1.0 - hfac  # 0 same worker / (1-hf) same host / 1 cross

            # Edge-touching subset, heaviest first when over the row cap.
            deg = np.zeros((n,), np.float32)
            np.add.at(deg, e_src, e_w)
            sub = np.nonzero(deg > 0.0)[0]
            if sub.size > _AFFINITY_MAX_ROWS:
                sub = np.sort(sub[np.argsort(-deg[sub], kind="stable")[:_AFFINITY_MAX_ROWS]])
            pos = np.full((n,), -1, np.int64)
            pos[sub] = np.arange(sub.size)
            in_sub = pos[e_src] >= 0
            # One endpoint of every edge is anchored each pass (a
            # simultaneous update lets a chatty pair swap seats forever):
            # even passes move the lighter-degree endpoint toward the
            # heavier, odd passes the other way; ties break by index.
            lighter = (deg[e_src] < deg[e_dst]) | ((deg[e_src] == deg[e_dst]) & (e_src < e_dst))

            # The balance base row (the dense solve's cost model) and the
            # slackened fair shares; the +1 covers integer granularity at
            # small fair shares.
            cap_t, alive_t = self._to_device(cap_np, alive_np)
            base = build_cost_matrix(torch.zeros_like(cap_t), cap_t, alive_t)[0]
            hfac_t = torch.from_numpy(hfac).to(dev)
            cap_alive = cap_np * alive_np
            fair = cap_alive / max(float(np.sum(cap_alive)), 1e-30) * n
            slack_cap = fair * self._affinity_slack + 1.0
            schedulable = (cap_alive > 0.0).astype(np.float64)
            total_w = float(np.sum(e_w))

        def _cut(seats: np.ndarray) -> float:
            return float(np.sum(e_w * dist[seats[e_src], seats[e_dst]])) / max(total_w, 1e-30)

        def _total(seats: np.ndarray) -> float:
            counts = np.bincount(seats, minlength=m)
            overflow = float(np.sum(np.maximum(counts - slack_cap, 0.0))) / n
            return overflow + w_aff * _cut(seats)

        seats = np.asarray(assignment, np.int32).copy()
        history = [{"pass": 0, "cut": _cut(seats), "total": _total(seats), "accepted": True}]
        g_warm = None
        accepted_any = False
        for p in range(self._affinity_passes):
            mask = in_sub & (lighter if p % 2 == 0 else ~lighter)
            if not np.any(mask):
                continue
            with span("affinity_refine_pass", p=p + 1):
                # Only the mobile endpoints are re-solved; anchors and the
                # rest hold their seats and consume capacity.
                mobile = np.unique(e_src[mask])
                sp = int(mobile.size)
                pos_p = np.full((n,), -1, np.int64)
                pos_p[mobile] = np.arange(sp)
                attract = _attraction(
                    pos_p[e_src[mask]], seats[e_dst[mask]], e_w[mask], hfac_t, sp
                )
                old = torch.from_numpy(seats[mobile].astype(np.int64)).to(dev)
                rows = torch.arange(sp, device=dev)
                cost = base.expand(sp, m) - w_aff * attract
                # Stay-put discount: a refine move still pays the handoff.
                cost[rows, old] -= self._move_cost
                frozen = np.bincount(seats, minlength=m).astype(np.float64)
                frozen -= np.bincount(seats[mobile], minlength=m)
                col_cap = torch.from_numpy(
                    np.maximum(slack_cap - frozen, 0.0) * schedulable
                ).to(dev)
                bucket = _next_bucket(sp)
                mass = torch.zeros(bucket, dtype=torch.float32, device=dev)
                mass[:sp] = 1.0
                cost_p = torch.zeros((bucket, m), dtype=torch.float32, device=dev)
                cost_p[:sp] = cost
                f, g, _err = sinkhorn(
                    cost_p, mass, col_cap.float(),
                    eps=self._eps, n_iters=self._n_iters, g_init=g_warm,
                )
                g_warm = g  # warm-starts the next linearization
                new = plan_rounded_assign(cost_p, f, g, self._eps)[:sp].long()
                # A row the rounded plan could not seat on a live column
                # keeps its seat.
                bad = (new < 0) | (new >= m) | (alive_t[new % m] <= 0.0)
                new = torch.where(bad, old, new)
                gain = cost[rows, old] - cost[rows, new]
                new_seats = _truncate_movers(new, old, gain, col_cap).cpu().numpy().astype(np.int32)
            cand = seats.copy()
            cand[mobile] = new_seats
            c_cut, c_tot = _cut(cand), _total(cand)
            ok = c_cut <= history[-1]["cut"] + 1e-9 and c_tot <= history[-1]["total"] + 1e-9
            history.append({"pass": p + 1, "cut": c_cut, "total": c_tot, "accepted": ok})
            if not ok:
                break
            if not np.array_equal(cand, seats):
                accepted_any = True
            seats = cand
        self._affinity_history = history  # atomic swap (tests/telemetry)
        return seats if accepted_any else None

    # ------------------------------------------------------- full rebalance
    def _object_weights(self, keys: list[str]) -> np.ndarray | None:
        """Per-object move prices from the ``object_costs`` hook, or None.

        A hook failure or a shape mismatch degrades to uniform pricing
        (load telemetry must never break a rebalance), and uniform weights
        are the scalar ``move_cost`` case: None keeps the collapsed path."""
        if self._object_costs is None:
            return None
        try:
            w = np.asarray(self._object_costs(keys), np.float32)
        except Exception:  # noqa: BLE001
            log.exception("object_costs hook failed; pricing moves uniformly")
            return None
        if w.shape != (len(keys),):
            return None
        w = np.clip(np.nan_to_num(w, nan=1.0, posinf=1.0), 0.0, 1e6)
        if len(keys) and float(np.ptp(w)) > 0.0:
            return w
        return None

    def _full_solve(self, mode, n, bucket, cur_idx, load, cap, alive, plan, obj_w):
        """One full re-solve on the device: ``(assignment (bucket,), g, conv)``.

        ``sinkhorn``/``scaling`` with no per-object prices and no mesh run
        the class-collapsed solve (class_quotas -> expand_class_quotas ->
        exact repair); otherwise the dense solve over the (bucket x M) cost,
        sharded over the mesh if there is one; ``greedy`` the churn-aware
        waterfill."""
        dev = self.device
        load_t, cap_t, alive_t = self._to_device(load, cap, alive)
        cap_alive = cap_t * alive_t
        m_axis = cap_alive.shape[0]
        cur_t = torch.zeros(bucket, dtype=torch.int32, device=dev)
        cur_t[:n] = torch.from_numpy(cur_idx).to(dev)
        real = torch.arange(bucket, device=dev) < n
        g_seed = plan.g if plan is not None else None
        warm_ratio = _seed_warm_ratio(g_seed)

        def repair_exact(assignment_padded):
            """Exact integer quotas at bucket shape; movers evicted first so
            the repair adds ~zero churn. Padding rows ride a sentinel column."""
            idx_full = torch.where(real, assignment_padded, m_axis)
            expected = torch.cat([
                cap_alive / cap_alive.sum().clamp_min(1e-30) * n,
                torch.tensor([bucket - n], dtype=torch.float32, device=dev),
            ])
            repaired = exact_quota_repair(
                idx_full, expected,
                prefer_keep=torch.where(real, idx_full == cur_t, True),
            )
            return route_sentinel_spill(repaired, real, m_axis, cap_alive)

        base_cost = build_cost_matrix(torch.zeros_like(load_t), cap_t, alive_t)
        if mode in ("sinkhorn", "scaling") and obj_w is None and self._mesh is None:
            # CLASS-COLLAPSED exact solve: every object with the same current
            # seat has an identical cost row, so the (N x M) problem
            # collapses to (M x M) and N drops out of the solve. The class
            # eps is sharpened until off-diagonal leakage (~M exp(-move_cost
            # / eps)) is negligible; the log-domain solver is stable at any
            # eps.
            counts = torch.bincount(cur_t[:n].long(), minlength=m_axis)[:m_axis]
            class_eps = min(
                self._eps, self._move_cost / 25.0 if self._move_cost > 0 else self._eps
            )
            quotas, g, cls_err = class_quotas(
                base_cost[0], counts, cap_alive,
                move_cost=self._move_cost, eps=class_eps, n_iters=self._n_iters,
                g_init=g_seed,
            )
            # Padding rows expand to garbage and are overridden by the
            # repair's sentinel.
            assignment = repair_exact(expand_class_quotas(quotas, cur_t))
            conv = {
                "solver_iters": self._n_iters,
                "residual": float(cls_err.cpu()),
                "warm_ratio": warm_ratio,
            }
            return assignment, g, conv
        # The (bucket x M) cost, materialised before the indexed stay-put
        # add (the JAX provider adds onto a broadcast).
        cost = base_cost.expand(bucket, m_axis).clone()
        if self._move_cost > 0:
            # Stay-put discount on each object's current seat (scaled by its
            # price when there are prices): only capacity pressure moves
            # anything, and the cold objects move first.
            stay = (
                torch.full((n,), self._move_cost, dtype=torch.float32, device=dev)
                if obj_w is None
                else self._move_cost * torch.from_numpy(obj_w).to(dev)
            )
            rows = torch.arange(n, device=dev)
            cost.index_put_((rows, cur_t[:n].long()), -stay, accumulate=True)
        mass = real.float()
        if mode in ("sinkhorn", "scaling") and self._mesh is not None:
            # The sharded solvers take no seed and report no residual: cold.
            sharded = sharded_scaling_sinkhorn if mode == "scaling" else sharded_sinkhorn
            f, g = sharded(
                self._mesh, shard_cost(self._mesh, cost), mass, cap_alive,
                eps=self._eps, n_iters=self._n_iters,
            )
            conv = {"solver_iters": self._n_iters, "warm_ratio": 0.0}
            assignment = repair_exact(plan_rounded_assign(cost, f, g, self._eps))
            return assignment, g, conv
        if mode in ("sinkhorn", "scaling"):
            dense = scaling_sinkhorn if mode == "scaling" else sinkhorn
            f, g, err = dense(
                cost, mass, cap_alive, eps=self._eps, n_iters=self._n_iters, g_init=g_seed,
            )
            conv = {
                "solver_iters": self._n_iters,
                "residual": float(err.cpu()),
                "warm_ratio": warm_ratio,
            }
            assignment = repair_exact(plan_rounded_assign(cost, f, g, self._eps))
            return assignment, g, conv
        # Churn-aware greedy: each object KEEPS its seat iff the seat is
        # alive and the object is within its node's capacity-fair share
        # (per-node rank < fair); dead seats and over-fair overflow are
        # waterfilled into the survivors' remaining headroom. Stable sort
        # keeps padding rows (mass 0, cur 0) after node 0's real rows.
        order, _, rank_sorted = rank_within_group(cur_t)
        rank = torch.empty_like(cur_t)
        rank[order] = rank_sorted
        fair = mass.sum() * cap_alive / cap_alive.sum().clamp_min(1e-30)
        cur_l = cur_t.long()
        keep = (alive_t[cur_l] > 0) & (mass > 0) & (rank < fair[cur_l])
        kept_load = torch.zeros_like(cap_t).index_add_(
            0, cur_l, torch.where(keep, mass, 0.0)
        )
        refill = greedy_balanced_assign(
            cost, torch.where(keep, 0.0, mass), cap_alive, node_load=kept_load
        )
        return torch.where(keep, cur_t, refill), None, {}

    async def rebalance(
        self,
        *,
        mode: str | None = None,
        move_sink=None,
        delta: bool | None = None,
    ) -> int:
        """Re-solve the directory; returns the number of moves.

        By default (``delta=None``) a churn event first attempts the
        incremental delta path (only displaced objects are re-solved
        against residual quotas, warm-started), and the full solve runs
        only when a delta gate trips. ``delta=False`` forces the full
        solve; ``delta=True`` forces the delta path whenever a plan exists.
        ``stats.mode`` reports which path ran: ``"<mode>+delta"``,
        ``"<mode>+collapsed"``, ``"<mode>"`` (dense, greedy or hierarchical),
        ``"<mode>+hier_at_scale"`` (a flat rebalance above
        ``_FLAT_REBALANCE_MAX_ROWS`` padded rows, a shard's on a mesh, routed
        through the hierarchical solve) or ``"<mode>+no_capacity"``; a
        hierarchical solve over a mesh in several chunks a shard adds
        ``"+mesh_chunk"``; a full solve that
        the affinity refine changed adds ``"+affinity"``.

        The epoch is snapshotted before the solve, and the result is
        discarded if the directory changed underneath it. ``move_sink``
        (``async (list[(key, from_addr, to_addr)]) -> int``) turns the apply
        into planned moves: the solve commits but rows stand, and the sink
        (the migration coordinator) actuates each move, outside the lock.
        """
        mode = self._solver_mode() if mode in (None, "auto") else mode
        if mode not in _SOLVER_MODES:
            raise ValueError(f"unknown placement mode {mode!r}")
        async with self._lock:
            with span("placement_snapshot"):
                n = len(self._placements)
                snapshot_epoch = self._epoch
                self._recount_loads()
                load, cap, alive = self._node_arrays()
                node_order = list(self._node_order)  # snapshot for off-lock use
                no_capacity = self._no_schedulable_capacity_host()
                plan = self._plan  # immutable snapshot (atomic-swap field)
                # O(displaced) fast path FIRST: for pure node-departure churn
                # the O(N) key/seat snapshot below is skipped entirely.
                fast = None
                if delta is not False and n and not no_capacity:
                    fast = self._delta_fast_snapshot(plan, n, cap, alive, force=(delta is True))
                if fast is None and n:
                    keys = list(self._placements.keys())
                    cur_idx = np.fromiter(self._placements.values(), np.int32, count=n)
        if not n:
            return 0
        if fast is not None:
            return await self._delta_fast_rebalance(
                fast, n=n, mode=mode, move_sink=move_sink, load=load, cap=cap, alive=alive,
                node_order=node_order, plan=plan, snapshot_epoch=snapshot_epoch,
            )

        bucket = _next_bucket(n)

        def _solve() -> tuple:
            """The solve, off the event loop; reads only the snapshots."""
            t0 = time.perf_counter()
            if no_capacity:
                # Zero schedulable capacity: reshuffling seats among dead
                # nodes is pure churn — stay put until liveness returns.
                solved_as = f"{mode}+no_capacity"
                with span("placement_solve", mode=solved_as, n=n):
                    return cur_idx.copy(), None, None, _elapsed_ms(t0), solved_as, 0, False, {}
            obj_w = self._object_weights(keys)
            if delta is not False and plan is not None:
                with span("placement_solve", mode=f"{mode}+delta", n=n):
                    d_res = self._delta_solve(
                        keys, cur_idx, load, cap, alive, node_order, plan, mode, obj_w,
                        force=(delta is True),
                    )
                    if d_res is not None:
                        out_d, g_d, coarse_d, displaced, stale, conv = d_res
                        out_d = _route_unseatable(out_d, len(node_order), load, alive, cap)
                        return (
                            out_d, g_d, coarse_d, _elapsed_ms(t0), f"{mode}+delta",
                            displaced, stale, conv,
                        )
            # Above _FLAT_REBALANCE_MAX_ROWS padded rows (a shard's, on a
            # mesh) a flat OT rebalance runs the two-level solve:
            # hashed-identity features with the stay-put pull toward each
            # object's current seat. A mesh's per-shard capacity split
            # breaks the class structure, so it never collapses.
            flat_rows = bucket if self._mesh is None else -(-bucket // int(self._mesh.devices.size))
            route_hier = mode in ("sinkhorn", "scaling") and flat_rows > _FLAT_REBALANCE_MAX_ROWS
            collapse = (
                mode in ("sinkhorn", "scaling") and obj_w is None and self._mesh is None
                and not route_hier
            )
            solved_as = (
                f"{mode}+hier_at_scale"
                if route_hier
                else f"{mode}+collapsed" if collapse else mode
            )
            with span("placement_solve", mode=solved_as, n=n):
                coarse_g = None
                if mode == "hierarchical" or route_hier:
                    # Never builds the flat (bucket x node_axis) cost.
                    assignment, g, coarse_g, conv = self._hierarchical_solve(
                        keys, node_order, cap, alive,
                        cur_idx=cur_idx if route_hier else None,
                        move_cost=self._move_cost if route_hier else 0.0,
                        move_w=obj_w if route_hier else None,
                        coarse_g_init=plan.coarse_g if plan is not None else None,
                    )
                    # The mesh x chunk dispatch names itself in stats.mode.
                    solved_as += conv.pop("mode_suffix", "")
                else:
                    assignment, g, conv = self._full_solve(
                        mode, n, bucket, cur_idx, load, cap, alive, plan, obj_w
                    )
                    assignment = assignment[:n].cpu().numpy()
                out = _route_unseatable(assignment, len(node_order), load, alive, cap)
            # Communication-graph refinement, full solves only (the delta
            # paths returned above; their warm potentials price pure
            # balance), from the routed assignment, a feasible seating.
            if self._affinity_weight > 0.0 and self._edge_graph:
                try:
                    refined = self._affinity_refine(keys, out, node_order, cap, alive)
                except Exception:  # noqa: BLE001 - refine must never kill a solve
                    log.exception("affinity refine failed; keeping base solve")
                    refined = None
                if refined is not None:
                    out = _route_unseatable(refined, len(node_order), load, alive, cap)
                    solved_as = f"{solved_as}+affinity"
            return out, g, coarse_g, _elapsed_ms(t0), solved_as, n, False, conv

        (
            assignment, g, coarse_g, solve_ms, solved_as, displaced, stale, conv
        ) = await asyncio.to_thread(_solve)

        async with self._lock:
            if self._epoch != snapshot_epoch:
                # Record the discarded ATTEMPT as its own stats event.
                self.stats = SolveStats(
                    n_objects=n,
                    n_nodes=len(self._node_order),
                    solve_ms=solve_ms,
                    displaced=displaced,
                    epoch=self._epoch,
                    mode=solved_as,
                    discarded=True,
                    history=self._archived_history(),
                    **_conv_fields(conv),
                )
                return 0
            # Touch only the movers: with the epoch unchanged the directory
            # equals the cur_idx snapshot.
            hist = self._archived_history()
            t_apply = time.perf_counter()
            with span("placement_apply", mode=solved_as, n=n):
                mover_pos = np.nonzero(assignment != cur_idx)[0]
                moved = 0
                planned: list[tuple[str, str, str]] = []
                for p in mover_pos.tolist():
                    if move_sink is not None:
                        # Plan, don't apply: the row flips when the sink's
                        # handoff commits.
                        planned.append(
                            (keys[p], node_order[int(cur_idx[p])], node_order[int(assignment[p])])
                        )
                    elif self._set_placement(keys[p], int(assignment[p])):
                        moved += 1
                if move_sink is not None:
                    moved = len(planned)
                if g is not None:
                    self._g = g
                    self._g_fp = self._sched_fp()
                self._recount_loads()
            self._epoch += 1
            if not solved_as.endswith("+no_capacity"):
                # Commit the plan the NEXT churn event deltas against. A
                # delta with no fresh potentials carries the previous seeds
                # forward; a full solve resets the staleness counter.
                delta_used = solved_as.endswith("+delta")
                self._plan = PlanState(
                    g=(
                        g
                        if g is not None
                        else (plan.g if delta_used and plan is not None else None)
                    ),
                    coarse_g=(
                        coarse_g
                        if coarse_g is not None
                        else (plan.coarse_g if delta_used and plan is not None else None)
                    ),
                    seat_counts=np.bincount(assignment, minlength=self._node_axis),
                    epoch=self._epoch,
                    liveness_fp=self._sched_fp(),
                    delta_solves=(
                        plan.delta_solves + 1 if delta_used and plan is not None else 0
                    ),
                    stale=stale,
                )
            self.stats = SolveStats(
                n_objects=n,
                n_nodes=len(self._node_order),
                solve_ms=solve_ms,
                apply_ms=(time.perf_counter() - t_apply) * 1e3,
                moved=moved,
                displaced=displaced,
                epoch=self._epoch,
                mode=solved_as,
                discarded=False,
                history=hist,
                **_conv_fields(conv),
            )
        if planned:
            # Grouped by (source, target) so the migration engine batches
            # contiguous runs; outside the lock (handoffs call update()).
            planned.sort(key=lambda m: (m[1], m[2]))
            await move_sink(planned)
        return moved
