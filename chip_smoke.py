#!/usr/bin/env python3
"""Run the PyTorch port's placement steps on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. ``build``   — compiles every CUDA source of ``rio_tpu_torch/kernels/csrc`` with nvcc
   (one process per source, all at once) and prints each kernel's ``ptxas`` line;
3. ``ragged``  — the fused scaling-iteration kernel against its plain PyTorch twin on
   small ragged shapes (zero-mass rows, zero-capacity columns, float32 and bfloat16 K,
   every load path), rtol 1e-4;
4. ``full_width`` — first the K-build kernel (``ops.kbuild.kbuild``, one launch) at
   1,048,576 x 1024 in float32 and bfloat16 against its twin run on the card: K and the
   shift equal bit for bit (the elements that differ and by how many ulps are printed),
   its median ms beside its byte bound and the twin's ms; then the scaling iteration as
   above at that width in bfloat16, one iteration, rtol 1e-4; then the CDF-rounding
   kernel (``ops.cdf_round.cdf_round``, one launch) on that iteration's u and v against
   its plain twin: rows agreeing >= 99.9%, residual sums
   within 1e-5 relative, its median ms beside its byte bound and the twin's ms;
5. ``main_path`` — ``placement_step`` at 1,048,576 objects x 1024 nodes (bf16 K,
   eps 0.05, 30 iterations, rounding in 65,536-row chunks) on ``make_problem(seed=0)``:
   the kernel launched 30 times, the K-build kernel once and the CDF-rounding kernel once
   (the ``scaling.k_build`` and ``placement.round`` spans read ``impl="kernel"``: no eager
   K build or rounding), every node seated at its quota of 1,024;
6. ``step_vs_plain`` — the solve through the kernel against the solve through the plain
   twin at 262,144 x 1024: u and v within rtol 1e-3 after 30 iterations, both
   assignments at quota, rows agreeing >= 99%;
7. ``logdomain_ragged`` — the fused log-domain iteration kernel against its plain
   twin, one iteration, on small ragged shapes: m = 130, 96, 40, 2600 and 1100 (column
   tiles), fewer rows than one CTA's warps, a cost base that is not 16-byte aligned,
   zero-mass rows, dead columns (some with g = -inf on input), every column dead, and
   a whole CTA's rows at zero mass; |d| <= 1e-4 + 1e-4 |ref|, identical -inf patterns;
8. ``logdomain_full_width`` — the same at 1,048,576 x 1024 float32 on the main path's
   cost matrix;
9. ``logdomain_path`` — ``logdomain_placement_step`` at 1,048,576 x 1024 (eps 0.05,
   30 iterations, rounding in 65,536-row chunks) on the same problem: the kernel
   launched 30 times, the post-solve kernel and its finalize once each, and none of
   the scaling, K-build and CDF-rounding kernels, every
   node at its quota of 1,024, mean cost < 0.25; it prints
   the largest |g| difference to the main path's scaling solve (not bounded); then
   the post-solve kernel and its finalize against their plain twin
   (``logdomain_post_round_ref``, ``marginal_err``) on the step's own f and g and on
   g moved by 0.4 eps: seats agreeing >= 99.9%, err within the float32 summation
   bound ``post_err_tol``, and with g moved an O(1) err within 1e-4 of the twin's;
10. ``logdomain_vs_plain`` — at 262,144 x 1024, 30 iterations: the kernel path against
   the plain twin's path and the unfused ``sinkhorn``, |d| <= 1e-3 + 1e-3 |ref| on f
   and g, assignments (the kernel path's rounded by the post-solve kernel, the plain
   paths' by its twin) at quota, rows agreeing >= 99%;
11. ``times`` — CUDA-event medians: each kernel, its plain twin and one library
   yardstick that the port never calls (``torch.mv`` twice for the scaling kernel;
   two ``torch.logsumexp`` sweeps for the log-domain kernel), each over batches of
   calls; each step and its stages (the main step's ``build_K`` is the marginals and
   the K-build kernel, its ``round_and_check`` the CDF-rounding kernel with its
   quantiles and the residuals' sum).
12. the ``directory`` group: ``TorchObjectPlacement`` on the card at 1,048,576 objects
   x 1,024 nodes (``node_axis_size=1024``, eps 0.05, 30 iterations, move_cost 0.5;
   ``bench.py``'s ``_incremental_rate`` kills 3% of nodes), each phase printing its
   wall ms after ``torch.cuda.synchronize()``, ``stats.mode``, ``stats.solve_ms``,
   ``moved`` and ``displaced``, and the launch counts of the hand kernels over the phase
   (0: the directory reaches none):

   - ``directory_assign``: ``sync_members`` with 1,024 members, ``assign_batch`` of
     1,048,576 new ObjectIds (4 chunks); every node holds exactly 1,024;
   - ``directory_full``: an establishing ``rebalance(delta=False)`` in mode
     ``sinkhorn+collapsed`` (``auto`` on CUDA) that moves nothing; 30 nodes die; a
     timed ``rebalance(delta=False)``: every live node at an integer fair quota (the
     multiset of ``integer_fair_quotas``, each node at the floor or ceiling of its
     share), dead nodes empty, moved = the dead nodes' population, no undisplaced move;
   - ``directory_delta``: one more node dies; ``rebalance()`` in mode
     ``sinkhorn+delta``, no undisplaced move, transport-cost ratio <= 1 + 1e-6;
   - ``directory_dense``: ``mode="scaling"`` with an ``object_costs`` hook of seeded
     weights in [1, 16): the same kill, ``rebalance(delta=False)`` in mode ``scaling``
     (the dense priced solve) at integer fair quotas; peak device memory;
   - ``directory_greedy``: the same kill under ``mode="greedy"``, timed; dead nodes
     empty, every live node within 2 of every other;
   - ``directory_standbys``: ``assign_standbys(k=1)`` on 65,536 objects of the
     ``directory_full`` provider: no standby on its object's primary, every seat on a
     live node.
13. the ``hier`` group, BASELINE row 5: 10,485,760 objects on 1,024 nodes (a
   power-of-two bucket of 16,777,216 rows: 32 chunks of 524,288, 128 groups of 8,
   fine bucket 8,192, eps 0.05, 30 + 30 iterations), each phase with its wall ms,
   peak device memory and the hand kernels' launch counts (0), the provider phases with
   ``stats.mode``, ``solve_ms``, ``apply_ms``, ``chunks``, ``chunk_ms``, moved and
   displaced:

   - ``hier_features``: ``_hash_features`` for 10,485,760 keys on the card, the host
     crc32s timed apart; on 65,536 of them the card's threefry words equal the CPU's
     and its features lie within 1e-6 of the CPU's;
   - ``hier_assign``: ``chunked_hierarchical_assign_timed`` on seeded features with 31
     nodes dead: no overflow, no row on a dead node, live loads within 10% of fair, one
     coarse-score launch a chunk and one potential-rounding launch for each of its roundings
     of at most 32 columns (the fine stage's 8 members; the coarse stage's 128 groups keep
     the eager twin); the untimed form gives the same result, each chunk's
     ``hier.coarse_score`` span reading ``impl="kernel"`` and its ``hier.round`` spans
     ``"eager"`` and ``"kernel"``; chunk 0 again on the CPU gives
     the same node counts and >= 99% of rows on the same node; then the coarse-score kernel
     alone at the benchmark cell's chunk (655,360 x 16 objects, 16 x 1,024 nodes, 32
     groups) against its twin on the card (elements that differ, max |d|), its median ms
     beside the 0.32 ms bound of its FMAs and the twin's ms; and the potential-rounding
     kernel alone on the two roundings of a solve of that chunk (655,360 x 32 and
     32 x 25,600 x 32), every node live and the 31 dead off: rows that differ from its
     twin on the card (none may), its median ms beside its bytes bound and the twin's ms;
   - ``hier_directory``: ``TorchObjectPlacement(affinity_tracker=AffinityTracker())``
     (``auto`` resolves to ``hierarchical``) at 1,048,576 objects: ``assign_batch``, a
     full rebalance in 2 chunks, 3:1 home:secondary traffic on the objects of 30 nodes
     (the tracker draws on the card: on 64 warmed and 64 cold keys and every node its
     features equal a CPU tracker's, and one cold key's draw is timed as a graph replay
     and as eager launches), those nodes killed, a ``hierarchical+delta`` rebalance that moves exactly the
     displaced objects and nothing else; its locality hit rate (displaced objects on
     their secondary) at least 10x chance;
   - ``hier_at_scale``: ``mode="sinkhorn"`` at 10,485,760 objects: ``assign_batch``,
     then ``rebalance(delta=False)`` after 31 nodes die, routed
     (``sinkhorn+hier_at_scale``, 32 chunks, 1 device) with dead nodes empty and live
     loads within 10% of fair; undisplaced moves printed. (A settling rebalance
     before the deaths was dropped to keep the script under 900 s.)

   Then ``hier_times``.
14. the ``affinity`` group: ``TorchObjectPlacement(affinity_weight=2.0)`` (host factor 0.5,
   slack 1.25, 3 passes) on 1,024 nodes, 128 hosts x 8 workers (one IP, eight ports),
   with a ``merge_edges`` graph of 524,288 rows (half disjoint pairs, half 16-leaf stars,
   Zipf(1.1) byte rates over the rows' ranks, 10 calls/s); each phase prints wall ms,
   ``stats.mode``, ``solve_ms``, ``apply_ms``, moved, the refine's host preparation and
   per-pass ms (its tracing spans), the pass history, peak device memory and the hand kernels'
   launch counts (0: the refine runs the plain ``sinkhorn``, as the reference does):

   - ``affinity_refine``: 1,048,576 objects, ``rebalance(delta=False)`` in mode
     ``sinkhorn+collapsed+affinity``; accepted passes with non-increasing cut and total,
     one past pass 0; 0 < moved <= 4,096; every node at or under its slack cap; the
     weight share of the refined subset's edges on one worker and on one host, before
     and after (the same-worker share rises);
   - ``affinity_repeat``: a second provider given the first one's directory from before
     the refine gives equal seats and an equal history (no float atomics on the path);
   - ``affinity_cpu_vs_card``: 65,536 objects and 32,768 edge rows on a CPU provider and a
     card provider: equal pass and accepted flags, cut within 1e-5, seats agreeing >= 99%;
   - ``affinity_hier``: the same directory and graph in a provider built with an
     ``AffinityTracker`` (``auto`` resolves to hierarchical): mode
     ``hierarchical+affinity``, the history as above. Then ``affinity_times``.
15. the ``persistent`` group: ``PersistentTorchObjectPlacement`` over the port's
   ``LocalObjectPlacement`` at 1,048,576 objects on 1,024 nodes, its background flusher
   held off, every row written by a timed ``flush()``:

   - ``persistent_assign``: ``assign_batch``, then a flush of exactly 1,048,576 rows that
     leaves the backing equal to the directory;
   - ``persistent_churn``: a settling full rebalance (no move, no row), 30 nodes killed, a
     ``sinkhorn+delta`` rebalance moving exactly their 30,720 objects, a flush of exactly
     those rows, no backing row on a dead node;
   - ``persistent_restore``: a fresh provider over the same backing: ``prepare()`` restores
     the first provider's directory row for row, recounts loads, starts every restored node
     dead and marks nothing dirty; ``sync_members`` with the survivors and a full
     rebalance on the card (live nodes at integer fair quotas), whose moves are flushed.
     Then ``persistent_times``.
16. the ``mesh`` group: 8 shards of the one card (``make_mesh([cuda:0] * 8)``, a (4, 2)
   grid), each phase with its wall ms after ``torch.cuda.synchronize()``, peak device
   memory and the hand kernels' launch counts (0: inside the reference's ``shard_map`` runs
   plain ``jnp``), the provider phases with ``stats.mode``, ``devices``, ``chunks``,
   ``solve_ms``, ``apply_ms``, moved and displaced:

   - ``mesh_flat``: ``make_problem(seed=0)`` at 1,048,576 x 1,024 (eps 0.05, 30
     iterations): ``sharded_sinkhorn`` and the bfloat16 ``sharded_scaling_sinkhorn``
     against the single-device ``sinkhorn`` and ``scaling_sinkhorn``, f and g within
     1e-4 (1 + |ref|); ``sharded_sinkhorn_assign`` against ``sinkhorn_assign``, rows
     differing <= 2%; every cost block a view of the one 4 GiB cost;
   - ``mesh_hier``: ``hier_assign``'s problem through
     ``mesh_chunked_hierarchical_assign_timed`` in 4 chunks a shard (32 cells of 524,288
     rows): equal to ``hier_assign``'s 32-chunk result row for row, the untimed form
     equal, no overflow, live loads within 10% of fair;
   - ``mesh_directory``: ``TorchObjectPlacement(mesh=...)`` at 1,048,576 objects, 30
     nodes killed: ``mode="sinkhorn"`` runs the dense mesh branch (mode ``sinkhorn``,
     live nodes at integer fair quotas); ``mode="hierarchical"`` runs 8 shards (mode
     ``hierarchical``), and a second full solve warm-starts; a 1-shard mesh
     (``hierarchical+mesh_chunk``, 2 chunks) seats every object as a provider with no
     mesh does;
   - ``mesh_at_scale``: ``mode="sinkhorn"`` on the mesh at 10,485,760 objects,
     ``assign_batch``, 31 nodes killed, ``rebalance(delta=False)`` in mode
     ``sinkhorn+hier_at_scale+mesh_chunk`` (8 shards, 4 chunks), dead nodes empty, live
     loads within 10% of fair; undisplaced moves printed;
   - ``mesh_nccl``: ``torch.distributed.is_nccl_available()``, a process group of one
     (NCCL, or gloo on CUDA tensors when NCCL is missing, named on the line), and
     ``sharded_hierarchical_assign`` at 1,048,576 rows through it equal to the same call
     without a group;
   - ``mesh_dryrun``: ``entry.dryrun_multichip(8)`` on the card with the reference's
     bounds; it prints the phase-2 transport-cost ratio (<= 1.12).

   Then ``mesh_times``.
17. the ``live`` group: the port's own actor runtime (``Server``, ``Client``, gossip
   membership, the ``PlacementDaemon``) on loopback over ``TorchObjectPlacement`` on the
   card, each phase with the hand kernels' launch counts (0: the directory reaches no
   kernel, as the reference's does) and whether the C++ envelope codec served
   (``native``):

   - ``live_row2``: BASELINE row 2 (``BASELINE.json`` configs[1]), ``bench.row2_torch_provider_live``:
     8 servers, 100,000 echo objects allocated through the servers' self-assign (host
     only), hops over 4,000 sampled ids: the directory holds 100,000 rows on ``cuda``,
     the directory resolver takes 1.0 hop (p99 1), the reference's random policy p99 2
     and mean > 1.5; its allocation wall and rate; then ``bench.live_route_hops`` (8 x
     2,048 on ``LocalObjectPlacement``) for the headline;
   - ``live_churn``: 8 servers with gossip (a death after 3 failed 2 s probes within
     10 s) and ``placement_daemon=True`` (poll 0.1 s, debounce 0.05 s), 50,000 echo
     objects (cut from row 2's 100,000: ``CHURN_OBJ``) and 8,192 durable counters (one acknowledged ``Add`` each, state in a shared
     ``LocalState``), every server with ``load_monitor=False`` (they share one event loop,
     whose lag would enter every node's load; the line prints ``load_monitor``); the
     server with the most rows exits; a daemon's rebalance completes
     on the card (``auto`` is ``sinkhorn`` on CUDA): no row on the dead node,
     ``displaced <= moved <= displaced + n/4`` (moved: objects whose seat changed; the
     daemons' planned moves under the same upper bound), every counter reads back its
     acknowledged value from a live node, 4,000 sampled echo ids take 1.0 hop; it prints
     ``stats.mode``, ``solve_ms``, ``apply_ms``, moved, displaced, every solve since the
     kill and the wall from the kill to the completed rebalance;
   - ``live_demo``: ``rio_tpu_torch.examples.tpu_placement`` on the card (5 servers,
     hierarchical provider with an ``AffinityTracker``, 200 objects, one server killed):
     a completed daemon re-solve in ``hierarchical`` mode that was not discarded, the
     tracker holding all 200 objects, every object answering afterwards.
18. the ``durable`` group: BASELINE row 2 on the port's durable backends, three SQLite
   files in a ``tempfile.mkdtemp()`` directory (``rio_tpu_torch.utils.durable_live``): 8
   servers on ``SqliteMembershipStorage``, ``PersistentTorchObjectPlacement`` on the card
   over ``SqliteObjectPlacement`` (``auto`` mode, the default ``flush_interval``) and
   ``SqliteState`` behind 8,192 ``DurableCounter`` s; each phase with the hand kernels' launch
   counts (0) and ``reduced`` (the cut of the object count and its cause):

   - ``durable_row2``: 59,000 echo objects (cut from 100,000: ``DUR_OBJ``) and the
     counters (one acknowledged ``Add`` each) allocated through a client; the
     write-behind drained (the backing writes and commits one row at a time); the
     file read back through a second
     ``SqliteObjectPlacement`` equals the directory key for key. It prints the
     allocation's seconds, rows written, the wait for the drain, the backing's seconds
     and microseconds a row and the file's bytes;
   - ``durable_restart``: every server flushed and stopped with ``server_exit`` (the
     flush's rows printed); a fresh provider restores the file onto the card (its
     ``prepare()`` timed), 8 fresh servers boot on new ports over the same three files:
     the restored count equals the flushed count before any traffic, every restored
     row names a ghost, 1,000 new ids seat on live servers only, 4,000 sampled restored
     ids answer through the reactive re-seat (hops printed: a completed round trip or a
     failed dial), every counter reads back its acknowledged value from a live server;
     then the rows the re-seat wrote back, drained and timed.
19. the ``affinity_live`` group: the affinity feedback loop on ``TorchObjectPlacement`` on
   the card, with the hand kernels' launch counts (0: ``greedy`` mode and the refine's plain
   ``sinkhorn``):

   - ``affinity_live``: ``rio_tpu_torch.bench.affinity_payoff`` (``bench.py``'s, at its
     sizes: 256 records x 4,096 B over 2 servers, ``affinity_weight`` 2.0, host factor
     0.05, ``spans_slo_ms`` 0.001, ``affinity_stride`` 1): bytes over TCP at least 2x
     fewer after the feedback, every cursor co-located with its consumer, fewer delivery
     spans on the wire, a ``+affinity`` solve, no record lost (the harness raises); the
     edge sampler's overhead is printed, not bounded;
   - ``affinity_demo``: ``rio_tpu_torch.examples.affinity`` (8 pairs, its own >= 2x bar).
20. the ``bench`` group: ``rio_tpu_torch.bench``'s tiers (``bench.py``'s device tiers) at
   the reference's sizes, each line holding the tier's result (with its device and power
   limit), its launch counts of the hand kernels and its peak device memory:

   - ``bench_solve``: the scaling kernel against its plain twin at 1,048,576 x 256
     bfloat16, one iteration, rtol 1e-4, and its time there beside the twin's and
     ``torch.mv`` both ways; then ``solve_rate`` at
     1,048,576 x 1,024 (30 iterations) and the row-3 extra at 1,048,576 x 256 (15): every
     node at the fair load, mean cost < 0.25 at 1,024 nodes and < 0.5 (random placement)
     at 256, the kernel launched 30 (15) times for each solve the tier issued;
   - ``bench_greedy``: ``greedy_rate`` on the solve tier's inputs, max load within 2 of fair;
   - ``bench_collapsed``: ``collapsed_rate`` (30 of 1,024 nodes dead), ``warm_assign_rate``
     (65,536) and ``incremental_rate``: dead nodes empty, the largest load at the ceiling
     of the fair share, moved >= displaced, no kernel launch;
   - ``bench_delta``: ``delta_churn_rate`` at 1,048,576 objects x 64 nodes: no undisplaced
     move, cost ratio <= 1 + 1e-6, the delta moved exactly the displaced;
   - ``bench_hier``: ``hier_rate``, BASELINE row 5 in 16 chunks of 655,360 rows: no
     overflow, loads within 10% of fair, none of the flat kernels, one coarse-score launch
     and two potential-rounding launches a chunk;
   - ``bench_headline``: the reference's last line over these results and the live
     group's route hops (so it reads "measured p99 hops").
21. ``profile``: ``torch.profiler`` (CPU and CUDA activities) over a short window of the
   main path (3 steps), the log-domain path (1 step), ``collapsed_decide`` at 1,048,576 x
   1,024, one ``hierarchical_assign`` chunk of 524,288 rows (``hier_assign``'s chunk 0) and
   a warm directory full rebalance after 30 deaths: each path's window ms (beside the
   same call's ms without the profiler, but for the rebalance), device busy ms (the union
   of its kernel, memcpy and memset spans), idle share, top 5 device operations and 3
   longest idle gaps with the host span open across each. The main-path trace must
   hold 90 launches of ``scaling_rows_kernel`` and the log-domain trace 30 of
   ``logdomain_rows_kernel``: a trace with no device event fails the phase.

22. the ``runtime`` group, after the device phases have freed the card's memory: the
   port's runtime on the card's host, with no device (``rio_tpu_torch.bench``'s runtime
   tiers, ``bench.py``'s host stages). The native library is built once first, so no
   two worker processes build it at once. Each phase prints the card's fields, ``host``
   (cores, affinity mask, load average) and the hand kernels' launch counts over the group
   so far (0):

   - ``runtime_import``: fresh interpreters with a clean environment import
     ``rio_tpu_torch.sharded``, ``rio_tpu_torch.autoscale.provision`` and
     ``rio_tpu_torch.server`` (``rio_tpu_torch.utils.import_probe``, median of 3); the
     import's and the process's seconds, and torch not loaded;
   - ``sharded_smoke``: ``python -m rio_tpu_torch.sharded --smoke`` and ``--smoke
     --shard-aware``, each node's SQLite files made first
     (``rio_tpu_torch.utils.sharded_smoke``), exit 0 with the reference's fields, the front door's requests
     served by both workers (``spread``), no redirect for the shard-aware client;
   - ``rpc``: ``rpc_throughput`` (2 servers, 64 senders x 600, ``asyncio`` and
     ``native``), ``rpc_egress`` and ``rpc_sharded`` (N = max(2, min(4, cores)) workers,
     128 objects, 2 loadgen children x 16 senders x 200; the 1-worker, batch-decode,
     shard-aware and engine A/Bs): every rate > 0, no redirect for the shard-aware
     clients, N workers, the engine A/B present when the native library built. One
     paired batch for each A/B where ``bench.py`` runs 3 or 5 (``RT_REDUCED``), never
     fewer workers or smaller windows;
   - ``runtime_tiers``: ``migration_drain``, ``hotkey_scaleout``, the five
     ``*_overhead`` tiers, ``streams_throughput``, ``qos_stage`` and
     ``autoscale_stage`` at ``bench.py``'s sizes but 6 paired batches where it runs 24
     and QoS's ``fast`` counts, the autoscale tier in a fresh process with its ramp's
     waits bounded and the times of its decisions in ``ramp_marks`` (``RT_REDUCED``,
     ``RT_RAMP``), each with its seconds, held to the
     reference's outcome bars: every object moved in both drain modes, no staleness
     violation in either hot-key mode, equal deliveries off and on, no interactive shed,
     armed fault lookups > 0, and in the ramp soak no lost acknowledged write and a
     scale-out, scale-in and retire in that order.

23. the ``examples`` group: the last tier, examples and tool of the port, on the card,
   each phase with the hand kernels' launch counts (0: the reference runs no kernel
   on these paths):

   - ``mesh_ab``: ``rio_tpu_torch.bench.hier_mesh_ab`` at ``bench.py``'s sizes,
     2,097,152 rows (``PRNGKey(18)``'s draws) x 1,024 nodes, 32 groups:
     ``mesh_chunked_hierarchical_assign_timed`` over 8 shards of the card in 65,536-row
     cells against ``chunked_hierarchical_assign_timed`` in 524,288-row chunks, 4
     chunks each: no overflow in either arm, a transport-cost ratio within 5% of 1;
   - ``multihost_solve``: ``rio_tpu_torch.examples.multihost_solve`` as a process group
     of one (NCCL) over 8 shards of the card, 32,768 objects on 64 nodes, node 5 dead:
     no row on the dead node, no overflow, live loads within 10% of fair;
   - ``migration_demo``: ``rio_tpu_torch.examples.migration`` with its provider on the
     card: ``(total, streak)`` reads (3, 3), then (4, 4) after the admin migrate and
     (5, 5) after cordon + rebalance;
   - ``endurance``: ``python -m rio_tpu_torch.tools.endurance --route-small --cordon
     --persistent`` (3 servers, 8 workers, 2,000 counters) in a fresh process, **cut**
     to 12 s with churn and samples every 3 s (``reduced``): no error, the SQLite
     backing equal to the directory, RSS warm and final printed (the tool's
     ``ru_maxrss``, which includes the peak of this process, and the child's
     ``VmRSS`` at its end).

Launch counts (``rio_tpu_torch.kernels.launch.launches``) name seven hand kernels: the flat
steps' five (``fused_scaling_iteration``, ``fused_iteration``, ``cdf_round``, ``kbuild``, and
``logdomain_post`` with its finalize, ``logdomain_post_finalize``), which a phase that says 0
holds at 0; ``coarse_scores``, which launches once in every
``hierarchical_assign`` call on the card (the hierarchical, tracker, mesh and routed at-scale
paths) and nowhere else; and ``potential_round``, which launches twice in every such call
and in the directory's roundings from potentials of at most 32 nodes.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero and prints no result. Without a CUDA
device it exits 1 at once.

Float32 sums are taken in another order on the card than in the plain twins
(a per-CTA split of the column sums, a shuffle tree for each row), and the
log-domain kernel multiplies by log2(e)/eps where the twin divides by eps and
takes approximate base-2 exponentials: that is what the tolerances absorb.
No kernel uses atomics.
"""

from __future__ import annotations

import asyncio
import json
import re
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
EXP_PER_CLOCK_PER_SM = 16  # Hopper SM: 16 special-function results (ex2) per clock

N_OBJ, N_NODES, CHUNK, N_ITERS, EPS = 1 << 20, 1024, 65536, 30, 0.05
PLAIN_N_OBJ = 262144
RTOL_KERNEL = 1e-4
RTOL_STEP = 1e-3
ROUND_ROW_AGREEMENT = 0.999  # the rounding kernel's rows against its twin's (reordered sums)
RTOL_ROUND_RES = 1e-5  # the sum of its row residuals against the twin's
# The K-build kernel against its twin on the card: the same arithmetic, so the same bits.
KBUILD_MAX_ULPS = {"f32": 0, "bf16": 0}
# Log-domain kernel against its twin: |d| <= TOL (1 + |ref|) after one iteration,
# TOL_STEP (1 + |ref|) after 30.
TOL_LOGDOMAIN = 1e-4
TOL_LOGDOMAIN_STEP = 1e-3
# The post-solve kernel's column error against marginal_err's where the error is O(1).
RTOL_POST_ERR = 1e-4


def post_err_tol(n: int, n_parts: int, warps_per_part: int) -> float:
    """An absolute bound on |err - marginal_err| of the post-solve kernel where the plan's mass is 1.

    Recursive float32 summation of positive terms errs by at most (k - 1) 2^-24 of
    their sum, k the length of the chain: a lane's ceil(n / (w n_parts)) rows, the w
    warps of a part, then the n_parts parts. marginal_err's reduction is bounded as
    the kernel's, and each exponential adds 2^-22 (ex2.approx), so
    |err - err_twin| <= 2 (k 2^-24 + 2^-22) sum_j col_j (tests/test_torch_logdomain_post_kernel.py).
    """
    k = -(-n // (warps_per_part * n_parts)) + warps_per_part + n_parts
    return 2 * (k * 2.0**-24 + 2.0**-22)

# The directory group: bench.py's _incremental_rate shape (3% of nodes dead).
DIR_OBJ, DIR_NODES, DIR_KILL, DIR_MOVE_COST = 1 << 20, 1024, 30, 0.5
STANDBY_OBJ = 65536
# The hierarchical group: BASELINE row 5 (10,485,760 objects on 1,024 nodes,
# 31 of them dead, 3%) and the tracker-driven directory at 1,048,576.
HIER_OBJ, HIER_DEAD = 10_485_760, 31
HIER_DIR_OBJ, HIER_DIR_KILL = 1 << 20, 30
HIER_SAMPLE = 65536
HIER_TRACKER_PROBE = 64  # warmed (and as many cold) keys replayed on a CPU tracker
TOL_HIER_FEATURES = 1e-6  # the card's hashed features against the CPU path's
# The coarse-score kernel against its twin (cuBLAS's FFMA GEMM, masked_fill, amax) on the
# card: the same FMA chain in the same order gives the same bits, so no element may differ.
COARSE_MAX_DIFFER = 0
# The potential-rounding kernel against its twin (the eager logit, softmax, cumsum and count)
# on the card: each step in PyTorch's own order, so no row may differ.
POTENTIAL_ROUND_MAX_DIFFER = 0
HIER_LOAD_SLACK = 0.10  # live loads within 10% of fair (tests/test_hierarchical.py:226)
HIER_ROW_AGREEMENT = 0.99  # one chunk on the card against the same chunk on the CPU
# The affinity group: 1,048,576 objects on 128 hosts x 8 workers (one IP, eight
# ports), 524,288 edge rows (1,024 servers x the edge sampler's top_k of 512),
# affinity_weight 2.0 (affinity_live.py's default), host factor, slack and
# passes at the provider's defaults.
AFF_OBJ, AFF_HOSTS, AFF_WORKERS, AFF_ROWS, AFF_WEIGHT = 1 << 20, 128, 8, 524_288, 2.0
AFF_STAR_LEAVES, AFF_ZIPF, AFF_TOP_BPS, AFF_CALLS = 16, 1.1, 1e6, 10.0
AFF_CMP_OBJ, AFF_CMP_ROWS = 65_536, 32_768  # the CPU provider against the card's
AFF_SEAT_AGREEMENT = 0.99
TOL_AFF_CUT = 1e-5
# The persistent group: 1,048,576 objects over LocalObjectPlacement, 30 nodes killed.
PERS_OBJ, PERS_KILL = 1 << 20, 30
PERS_FLUSH_INTERVAL = 3600.0
# The mesh group: 8 shards of the one card, a (4, 2) mesh; BASELINE row 5 in 4
# chunks a shard (32 cells, as hier_assign's 32 chunks); the process-group
# check at 1,048,576 rows.
MESH_SHARDS, MESH_CHUNKS, MESH_NCCL_ROWS = 8, 4, 1 << 20
TOL_MESH = 1e-4  # sharded potentials against the single-device solve (__graft_entry__.py:188-193)
MESH_ROW_MISMATCH = 0.02  # sharded rows against the single-device rounding (:198)
# The bench group: bench.py's device tiers at its sizes (the solve tier and greedy at
# 1,048,576 x 1,024; the row-3 extra at 1,048,576 x 256, 15 iterations; the warm batch
# 65,536; the delta A/B at 64 nodes; BASELINE row 5 in 16 chunks of 655,360, 32 groups).
BENCH_OBJ, BENCH_ROW3_NODES, BENCH_ROW3_ITERS = 1 << 20, 256, 15
BENCH_WARM_BATCH, BENCH_DELTA_NODES = 65_536, 64
BENCH_HIER_OBJ, BENCH_HIER_GROUPS, BENCH_HIER_CHUNK = 10_485_760, 32, 655_360
RANDOM_MEAN_COST = 0.5  # a random placement's mean cost on U[0, 1) costs
# The live group: BASELINE.json configs[1] (8 nodes, 100,000 objects; bench.py's
# row2_jax_provider_live samples 4,000 ids), 8,192 durable counters beside the echo
# population in the churn phase, and the churn bound of
# tests/test_torch_placement_server.py (moved <= displaced + n/4).
LIVE_SERVERS, LIVE_OBJ, LIVE_SAMPLE, LIVE_COUNTERS = 8, 100_000, 4_000, 8_192
# The churn phase's echo population, cut from row 2's 100,000 to keep the script
# under 900 s once the durable group runs (live_row2 keeps the full row).
CHURN_OBJ = 50_000
# The durable group: BASELINE row 2 on SQLite (the live group's 8 servers, 8,192
# counters and 4,000 sampled ids), 1,000 new ids after the restart. The backing
# writes and commits one row at a time. On an H100 80GB HBM3 host at 700 W, runs
# wrote 1,016.11-1,476.41 us a row; the one at 100,000 objects took 126.8 s. The
# echo objects are cut to what 100 s of writes allow at the slowest reading
# (100 s / 1,476.41 us = 67,731 rows, less the 8,192 counters, rounded down): the
# budget was 120 s (73,000 objects) until the runtime group took the script to
# 855.3 s. The phase prints the rate its own run measured as ``us_per_row``.
DUR_OBJ, DUR_NEW = 59_000, 1_000
DUR_REDUCED = {
    "objects": [LIVE_OBJ, DUR_OBJ], "sized_at_us_per_row": 1476.41,
    "sized_from": "the slowest of three earlier runs' writes (1016.11-1476.41 us a row)",
    "flush_budget_s": 100.0,
    "cause": "one row written and committed per update (the trait's update_batch)",
}
# The affinity_live group: affinity_live.py's sizes (256 records x 4,096 B, 2 servers,
# affinity_weight 2.0, host factor 0.05) and its bar.
AFF_LIVE_RATIO = 2.0
# The profile phase: main-path steps in its window.
PROFILE_MAIN_STEPS = 3
# The runtime group: bench.py's host stages at its sizes, but fewer paired batches
# in every A/B, to keep the script under 900 s (on an H100 80GB HBM3 host at 700 W
# the group took 302.6 s at 2 batches for egress and sharded and bench.py's counts
# elsewhere). The worker count, every window's and every batch's size stay
# bench.py's; the full battery runs in ``python -m rio_tpu_torch.bench --rpc ...``.
RT_EGRESS_BATCHES = 1
RT_SHARDED_BATCHES = {"ab_batches": 1, "decode_batches": 1, "aware_batches": 1}
RT_OVERHEAD_BATCHES = 6  # tracing, journal, series, spans, faults and the autoscale idle A/B
RT_REDUCED = {
    "rpc_egress": {"batches": [5, RT_EGRESS_BATCHES]},
    "rpc_sharded": {"one_worker_and_engine_batches": [3, RT_SHARDED_BATCHES["ab_batches"]],
                    "batch_decode_batches": [5, RT_SHARDED_BATCHES["decode_batches"]],
                    "shard_aware_batches": [3, RT_SHARDED_BATCHES["aware_batches"]]},
    "overhead_batches": [24, RT_OVERHEAD_BATCHES],
    "qos": "fast: 16 uniform batches and 40 flood probes, not 48 and 80",
    "autoscale_ramp": {"high_timeout_s": [90.0, 45.0], "settle_timeout_s": [150.0, 60.0]},
    "cause": "the script's 900 s; the full battery runs in python -m rio_tpu_torch.bench",
}
# The autoscale tier runs in a fresh process (python -m rio_tpu_torch.utils.ramp_trace,
# which also prints when the ramp's controller decided what). The ramp scales out
# once one node serves over 600 requests/s; in this process, after the device
# groups, one ramp took 74.7 s (an H100 80GB HBM3 host at 700 W; 6.7-9.2 s in a
# fresh one). Its waits are bounded: the scale-out within 45 s,
# the scale-in and the return to the floor within 60 s each (the slowest designed
# path, a drain that fails, its 15 s deadline and a 10 s retire, is under 35 s).
RT_RAMP = {"high_timeout": RT_REDUCED["autoscale_ramp"]["high_timeout_s"][1],
           "settle_timeout": RT_REDUCED["autoscale_ramp"]["settle_timeout_s"][1]}

# The examples group: bench.py's hier_mesh_ab at its sizes (2,097,152 rows x 1,024
# nodes, 32 groups, 8 shards of 65,536-row cells against 524,288-row chunks) with the
# reference capture's bars (no overflow, a transport-cost ratio within 5% of 1);
# examples/multihost_solve.py's 8 shards under one NCCL process; examples/migration.py;
# tools/endurance.py with --route-small --cordon --persistent, cut from its 60 minutes
# (churn every 45 s, a sample every 60 s) to 12 s with churn and samples every 3 s: on
# an H100 80GB HBM3 host at 700 W the script took 920.5 s with a 30 s run (churn every
# 6 s), over its 900 s.
AB_RATIO_SLACK = 0.05
END_MINUTES, END_CHURN_S, END_SAMPLE_S = 0.2, 3.0, 3.0
END_REDUCED = {
    "minutes": [60, END_MINUTES], "churn_every_s": [45.0, END_CHURN_S],
    "sample_every_s": [60.0, END_SAMPLE_S],
    "cause": "the script's 900 s; a 10-minute run is made apart from the script",
}
# Runs python -m rio_tpu_torch.tools.endurance in a fresh process and prints, after
# its summary, the hand kernels' launch counts there and its resident set at the end:
# the tool's own RSS is ru_maxrss, which a process started from this one inherits
# (the peak of the process it was forked from).
_ENDURANCE_CHILD = """
import json, runpy, sys
from chip_smoke import _launches, _reset_launches
_reset_launches()
sys.argv = ["rio_tpu_torch.tools.endurance", *sys.argv[1:]]
runpy.run_module("rio_tpu_torch.tools.endurance", run_name="__main__", alter_sys=True)
with open("/proc/self/status") as f:
    rss_kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:"))
print(json.dumps({"launches": _launches(), "vm_rss_mb": rss_kb / 1024}), flush=True)
"""


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``t_s`` is the script's seconds when the phase ended."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - T_START}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_rel_err(got, want) -> float:
    """max |got - want| / |want| over nonzero ``want``; zeros must match exactly."""
    check(bool(((got == 0) == (want == 0)).all()), "zero pattern differs")
    nz = want != 0
    if not bool(nz.any()):
        return 0.0
    return float(((got[nz] - want[nz]).abs() / want[nz].abs()).max())


def max_abs_close(got, want, tol: float, what: str) -> float:
    """Identical -inf patterns and |got - want| <= tol (1 + |want|) elsewhere; max |d|."""
    import torch

    check(bool((torch.isneginf(got) == torch.isneginf(want)).all()), f"{what}: -inf pattern differs")
    live = ~torch.isneginf(want)
    check(bool(torch.isfinite(got[live]).all()), f"{what}: non-finite where the twin is finite")
    if not bool(live.any()):
        return 0.0
    diff = (got[live] - want[live]).abs()
    check(bool((diff <= tol * (1.0 + want[live].abs())).all()), f"{what}: max |d| {float(diff.max())}")
    return float(diff.max())


def cuda_median_ms(fn, reps: int, warmup: int = 2, batch: int = 1) -> float:
    """Median ms of one call of ``fn`` over ``reps`` samples.

    Each sample is one pair of CUDA events around ``batch`` calls, divided
    by ``batch``: with a batch, the host's work between launches overlaps
    the card's instead of sitting inside the timed window.
    """
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def host_median_us(fn, reps: int, warmup: int = 5) -> float:
    """Median wall microseconds of one call of a host-bound ``fn`` that ends synchronised."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


class _Member:
    """What ``sync_members`` reads of a membership row."""

    def __init__(self, address: str, active: bool) -> None:
        self.address = address
        self.active = active


# The flat step's hand kernels: no directory, hierarchical or runtime path reaches them.
FLAT_KERNELS = ("fused_scaling_iteration", "fused_iteration", "cdf_round", "kbuild", "logdomain_post",
                "logdomain_post_finalize")


def _reset_launches() -> None:
    from rio_tpu_torch.kernels.launch import reset_launches

    reset_launches()


def _launches() -> dict:
    """The hand kernels' launch counts since :func:`_reset_launches`, by wrapper name."""
    from rio_tpu_torch.kernels.launch import launches

    return launches()


def _read_launches(what: str) -> dict:
    """:func:`_launches`; the directory and hierarchical paths reach none of
    the flat step's kernels, so each of those must be 0 (``coarse_scores``
    counts the hierarchical paths' own kernel)."""
    launches = _launches()
    check(sum(launches[k] for k in FLAT_KERNELS) == 0, f"{what} launched a flat kernel: {launches}")
    return launches


async def timed_call(coro_fn, what: str = "the directory"):
    """Run one provider call with both kernel counts at 0; its result, wall ms
    after a device synchronize, and the counts read just after."""
    import torch

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = await coro_fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return result, ms, _read_launches(what)


async def provider_call(coro_fn, what: str):
    """:func:`timed_call` plus the peak device memory of the call."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result, ms, launches = await timed_call(coro_fn, what)
    return result, ms, launches, torch.cuda.max_memory_allocated()


async def directory_phases(dev, card: dict) -> dict:
    """The ``directory`` group (phase 12): returns the times it printed."""
    import numpy as np
    import torch

    from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
    from rio_tpu_torch.ops import integer_fair_quotas
    from rio_tpu_torch.registry import ObjectId

    addrs = [f"10.{i // 256}.{i % 256}.1:5000" for i in range(DIR_NODES)]
    rng = np.random.default_rng(0)
    killed = sorted(int(i) for i in rng.choice(DIR_NODES, DIR_KILL, replace=False))
    ids = [ObjectId("Dir", str(i)) for i in range(DIR_OBJ)]
    out: dict = {}

    def members(dead) -> list:
        return [_Member(a, i not in dead) for i, a in enumerate(addrs)]

    def provider(**kw) -> TorchObjectPlacement:
        p = TorchObjectPlacement(
            eps=EPS, n_iters=N_ITERS, move_cost=DIR_MOVE_COST, node_axis_size=DIR_NODES,
            device=dev, **kw,
        )
        p.sync_members(members(()))
        return p

    def seat_array(p) -> np.ndarray:  # insertion order: aligned across calls
        return np.fromiter(p._placements.values(), np.int64, count=p.count())

    def node_counts(p) -> np.ndarray:
        return np.bincount(seat_array(p), minlength=DIR_NODES)

    def check_fair(p, dead, what: str) -> None:
        """Dead nodes empty; live nodes at the multiset of integer_fair_quotas,
        each at the floor or ceiling of its share (equal remainders may give
        the extra units to other nodes than integer_fair_quotas picks)."""
        counts = node_counts(p)
        cap_alive = np.asarray([0.0 if i in dead else 1.0 for i in range(DIR_NODES)])
        quota = integer_fair_quotas(cap_alive, DIR_OBJ)
        share = DIR_OBJ / cap_alive.sum()
        live = cap_alive > 0
        check(int(counts[~live].sum()) == 0, f"{what}: objects left on dead nodes")
        check(bool(np.array_equal(np.sort(counts), np.sort(quota))),
              f"{what}: node counts are not the integer fair quotas")
        check(bool(((counts[live] == np.floor(share)) | (counts[live] == np.ceil(share))).all()),
              f"{what}: a node is off its fair share")

    def cost_ratio(p, dead) -> float:  # bench.py's quadratic congestion ratio
        counts = node_counts(p).astype(np.float64)
        cap_alive = np.asarray([0.0 if i in dead else 1.0 for i in range(DIR_NODES)])
        quota = integer_fair_quotas(cap_alive, DIR_OBJ).astype(np.float64)
        safe = np.maximum(cap_alive, 1e-9)
        return float(np.sum(counts**2 / safe) / max(np.sum(quota**2 / safe), 1e-9))

    timed = timed_call

    def stats_fields(p) -> dict:
        s = p.stats
        return {"mode": s.mode, "solve_ms": s.solve_ms, "apply_ms": s.apply_ms,
                "moved": s.moved, "displaced": s.displaced, "residual": s.residual}

    async def assign(p):
        return await p.assign_batch(ids)

    # -- directory_assign ------------------------------------------------------
    p = provider()
    placed, ms, launches = await timed(lambda: assign(p))
    counts = node_counts(p)
    check(len(placed) == DIR_OBJ and p.count() == DIR_OBJ, "assign_batch seated every object")
    check(bool((counts == DIR_OBJ // DIR_NODES).all()),
          f"assign_batch node counts {int(counts.min())}..{int(counts.max())}")
    chunks = -(-DIR_OBJ // TorchObjectPlacement._MAX_PLACE_CHUNK)
    out["assign_ms"] = ms
    emit("directory_assign", **card, n=DIR_OBJ, m=DIR_NODES, chunks=chunks, wall_ms=ms,
         per_node=int(counts[0]), mode=p.stats.mode, solve_ms=p.stats.solve_ms, moved=0,
         displaced=0, launches=launches)
    del placed

    # -- directory_full --------------------------------------------------------
    moved, settle_ms, _ = await timed(lambda: p.rebalance(delta=False))
    check(p.stats.mode == "sinkhorn+collapsed", f"establishing solve ran {p.stats.mode}")
    check(moved == 0, f"establishing solve moved {moved} objects")
    settle = stats_fields(p)
    before = seat_array(p)
    dead = set(killed)
    displaced = int(np.isin(before, killed).sum())
    p.sync_members(members(dead))
    moved, ms, launches = await timed(lambda: p.rebalance(delta=False))
    check(p.stats.mode == "sinkhorn+collapsed", f"full solve ran {p.stats.mode}")
    after = seat_array(p)
    undisplaced = int(((before != after) & ~np.isin(before, killed)).sum())
    check(moved == displaced == DIR_KILL * (DIR_OBJ // DIR_NODES),
          f"moved {moved}, dead nodes held {displaced}")
    check(undisplaced == 0, f"{undisplaced} undisplaced objects moved")
    check_fair(p, dead, "full rebalance")
    check(0.0 <= p.stats.residual < 1e-2, f"class solve residual {p.stats.residual}")
    out["full_ms"] = ms
    out["full_solve_ms"] = p.stats.solve_ms
    emit("directory_full", **card, n=DIR_OBJ, m=DIR_NODES, killed=DIR_KILL, wall_ms=ms,
         **stats_fields(p), dead_population=displaced, undisplaced_moves=undisplaced,
         establishing={"wall_ms": settle_ms, **settle}, launches=launches)

    # -- directory_delta -------------------------------------------------------
    before = after
    extra = next(i for i in range(DIR_NODES) if i not in dead)
    dead.add(extra)
    p.sync_members(members(dead))
    moved, ms, launches = await timed(lambda: p.rebalance())
    check(p.stats.mode == "sinkhorn+delta", f"churn solve ran {p.stats.mode}")
    after = seat_array(p)
    undisplaced = int(((before != after) & (before != extra)).sum())
    ratio = cost_ratio(p, dead)
    check(undisplaced == 0, f"{undisplaced} undisplaced objects moved")
    check(moved == p.stats.displaced == int((before == extra).sum()), "delta moved the displaced set")
    check(ratio <= 1.0 + 1e-6, f"transport-cost ratio {ratio}")
    out["delta_ms"] = ms
    out["delta_solve_ms"] = p.stats.solve_ms
    emit("directory_delta", **card, n=DIR_OBJ, m=DIR_NODES, wall_ms=ms, **stats_fields(p),
         undisplaced_moves=undisplaced, cost_ratio=ratio, launches=launches)

    full, full_dead = p, set(dead)

    # -- directory_dense -------------------------------------------------------
    weights = np.random.default_rng(1).uniform(1.0, 16.0, DIR_OBJ).astype(np.float32)

    def prices(keys):  # keys are "Dir.<i>"
        return weights[np.fromiter((int(k[4:]) for k in keys), np.int64, count=len(keys))]

    p = provider(mode="scaling", object_costs=prices)
    await assign(p)
    dead = set(killed)
    displaced = int(np.isin(seat_array(p), killed).sum())
    p.sync_members(members(dead))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moved, ms, launches = await timed(lambda: p.rebalance(delta=False))
    peak = torch.cuda.max_memory_allocated()
    check(p.stats.mode == "scaling", f"priced solve ran {p.stats.mode}")
    check_fair(p, dead, "dense rebalance")
    out["dense_ms"] = ms
    out["dense_solve_ms"] = p.stats.solve_ms
    out["dense_peak_bytes"] = peak
    emit("directory_dense", **card, n=DIR_OBJ, m=DIR_NODES, killed=DIR_KILL, wall_ms=ms,
         **stats_fields(p), dead_population=displaced, peak_bytes=peak, launches=launches)
    del p

    # -- directory_greedy ------------------------------------------------------
    p = provider(mode="greedy")
    await assign(p)
    displaced = int(np.isin(seat_array(p), killed).sum())
    p.sync_members(members(dead))
    moved, ms, launches = await timed(lambda: p.rebalance(delta=False))
    check(p.stats.mode == "greedy", f"greedy solve ran {p.stats.mode}")
    counts = node_counts(p)
    live_counts = counts[[i for i in range(DIR_NODES) if i not in dead]]
    check(int(counts[killed].sum()) == 0, "greedy left objects on dead nodes")
    check(int(live_counts.max()) - int(live_counts.min()) <= 2,
          f"greedy node counts {int(live_counts.min())}..{int(live_counts.max())}")
    out["greedy_ms"] = ms
    out["greedy_solve_ms"] = p.stats.solve_ms
    emit("directory_greedy", **card, n=DIR_OBJ, m=DIR_NODES, killed=DIR_KILL, wall_ms=ms,
         **stats_fields(p), dead_population=displaced,
         live_counts=[int(live_counts.min()), int(live_counts.max())], launches=launches)
    # -- directory_standbys (on the directory_full provider) -------------------
    p, dead = full, full_dead
    sub = ids[:STANDBY_OBJ]
    rows, ms, launches = await timed(lambda: p.assign_standbys(sub, k=1))
    live_idx = [i for i in range(DIR_NODES) if i not in dead]
    live = {addrs[i] for i in live_idx}
    primaries = await p.lookup_batch(sub)
    check(all(len(r) == 1 for r in rows), "a standby seat went unfilled")
    check(all(r[0] != pr for r, pr in zip(rows, primaries)), "a standby sits on its primary")
    check(all(r[0] in live for r in rows), "a standby sits on a dead node")
    per_node = np.bincount([p._nodes[r[0]].index for r in rows], minlength=DIR_NODES)[live_idx]
    out["standbys_ms"] = ms
    emit("directory_standbys", **card, n=STANDBY_OBJ, m=DIR_NODES, k=1, wall_ms=ms,
         standbys_per_live_node=[int(per_node.min()), int(per_node.max())], launches=launches)
    return out


def seat_array_of(p):
    """Each object's node index, in the directory's insertion order."""
    import numpy as np

    return np.fromiter(p._placements.values(), np.int64, count=p.count())


def hier_stats_fields(p) -> dict:
    s = p.stats
    return {"mode": s.mode, "solve_ms": s.solve_ms, "apply_ms": s.apply_ms,
            "chunks": s.chunks, "devices": s.devices, "chunk_ms": s.chunk_ms,
            "moved": s.moved, "displaced": s.displaced, "residual": s.residual}


def live_spread(loads, gone, n, what: str) -> list:
    """Dead nodes empty; live loads within HIER_LOAD_SLACK of fair; [min, max]."""
    import numpy as np

    live = np.asarray([i not in gone for i in range(DIR_NODES)])
    fair = n / live.sum()
    check(int(loads[~live].sum()) == 0, f"{what}: objects on dead nodes")
    lo, hi = int(loads[live].min()), int(loads[live].max())
    check((1 - HIER_LOAD_SLACK) * fair <= lo and hi <= (1 + HIER_LOAD_SLACK) * fair,
          f"{what}: live loads {lo}..{hi} against fair {fair:.1f}")
    return [lo, hi]


def hier_dead() -> list:
    """The HIER_DEAD nodes that BASELINE row 5's phases kill."""
    import numpy as np

    return sorted(int(i) for i in np.random.default_rng(2).choice(DIR_NODES, HIER_DEAD, replace=False))


def hier_assign_inputs(dev, dead):
    """``hier_assign``'s problem at the provider's shape: seeded (n_pad, 16)
    object and (16, m) node features, unit capacities, ``dead`` nodes off,
    the solve keywords and the chunk count (rows over ``_HIER_CHUNK_ROWS``)."""
    import torch

    from rio_tpu_torch.object_placement import torch_placement as tp

    n_pad = tp._next_bucket(HIER_OBJ)
    n_chunks = max(1, n_pad // tp._HIER_CHUNK_ROWS)
    rows = n_pad // n_chunks
    n_groups, group_size = DIR_NODES // 8, 8
    alive = torch.ones(DIR_NODES)
    alive[dead] = 0.0
    live_cap = alive.view(n_groups, group_size).sum(dim=1)
    share = float(live_cap.max() / live_cap.sum())
    bucket = min(tp._next_bucket(max(8, int(1.3 * rows * share)), minimum=8), rows)
    kw = dict(n_groups=n_groups, bucket=bucket, eps=EPS, coarse_iters=N_ITERS, fine_iters=N_ITERS)
    gen = torch.Generator(device=dev).manual_seed(11)
    obj = torch.randn((n_pad, tp._FEAT_DIM), generator=gen, device=dev)
    node = torch.randn((tp._FEAT_DIM, DIR_NODES), generator=gen, device=dev) * 0.2
    return obj, node, torch.ones(DIR_NODES, device=dev), alive.to(dev), kw, n_chunks


def coarse_kernel_fields(obj, node, alive) -> dict:
    """The coarse-score kernel alone at the benchmark cell's chunk (BENCH_HIER_CHUNK rows of
    ``obj`` against ``node`` in BENCH_HIER_GROUPS groups): its result against the twin's on
    the card (every node live, and ``alive``'s dead nodes off), its median ms against the
    bound of its FMAs and the twin's ms."""
    import torch

    from rio_tpu_torch.ops import coarse_score as CS

    x, groups = obj[:BENCH_HIER_CHUNK], BENCH_HIER_GROUPS
    n, d = x.shape
    m = node.shape[1]
    everyone = torch.ones(m, dtype=torch.bool, device=node.device)
    fields: dict = {"n": n, "d": d, "m": m, "groups": groups}
    for name, live in (("all_live", everyone), ("dead_off", alive > 0)):
        got = CS.coarse_scores(x, node, live, groups)
        want = CS.coarse_scores_ref(x, node, live, groups)
        finite = torch.isfinite(want)
        differ = int((got != want).sum())
        max_abs = float((got - want)[finite].abs().max())
        check(torch.equal(finite, torch.isfinite(got)) and differ <= COARSE_MAX_DIFFER,
              f"coarse-score kernel ({name}): {differ} elements differ, max |d| {max_abs}")
        fields[name] = {"elements_differ": differ, "max_abs_diff": max_abs}
    ms = cuda_median_ms(lambda: CS.coarse_scores(x, node, everyone, groups), reps=20, batch=10)
    plain_ms = cuda_median_ms(lambda: CS.coarse_scores_ref(x, node, everyone, groups), reps=5)
    bound_ms = 2 * n * m * d / F32_FLOPS_PER_S * 1e3
    fields.update(ms=ms, bound_ms=bound_ms, bound_share=bound_ms / ms, plain_ms=plain_ms)
    return fields


def potential_round_fields(obj, node, alive) -> dict:
    """The potential-rounding kernel alone on both roundings of one two-level solve of the
    benchmark cell's chunk (BENCH_HIER_CHUNK rows of ``obj``, BENCH_HIER_GROUPS groups), every
    node live and ``alive``'s dead nodes off: rows that differ from the twin on the card, and
    at each stage its median ms against the bound of its bytes and the twin's ms."""
    import torch

    from rio_tpu_torch.ops import potential_round as PR
    from rio_tpu_torch.parallel import hierarchical as H

    sinkhorn_ops = sys.modules["rio_tpu_torch.ops.sinkhorn"]
    m = node.shape[1]
    fields: dict = {}
    for name, live in (("all_live", torch.ones(m, device=node.device)), ("dead_off", alive)):
        calls = []

        def spy(*args):
            calls.append(args)
            return PR.potential_round(*args)

        sinkhorn_ops.potential_round = spy
        try:
            H.hierarchical_assign(obj[:BENCH_HIER_CHUNK], node, torch.ones(m, device=node.device),
                                  live, n_groups=BENCH_HIER_GROUPS)
        finally:
            sinkhorn_ops.potential_round = PR.potential_round
        check(len(calls) == 2, f"a solve made {len(calls)} roundings, want 2")
        for stage, args in zip(("coarse", "fine"), calls):
            got, want = PR.potential_round(*args), PR.potential_round_ref(*args)
            differ = int((got != want).sum())
            check(differ <= POTENTIAL_ROUND_MAX_DIFFER,
                  f"potential-rounding kernel ({name}, {stage}): {differ} rows differ")
            entry = fields.setdefault(stage, {"shape": list(args[0].shape)})
            entry[f"rows_differ_{name}"] = differ
            if name == "all_live":
                cost = args[0]
                bound_ms = (cost.numel() * 4 + 3 * 4 * cost[..., 0].numel()) / HBM_BYTES_PER_S * 1e3
                ms = cuda_median_ms(lambda: PR.potential_round(*args), reps=20, batch=10)
                plain_ms = cuda_median_ms(lambda: PR.potential_round_ref(*args), reps=5)
                entry.update(ms=ms, bound_ms=bound_ms, bound_share=bound_ms / ms, plain_ms=plain_ms)
    return fields


async def hier_phases(dev, card: dict, keep: dict) -> dict:
    """The ``hier`` group (phase 13): returns the times it printed and puts
    ``hier_assign``'s assignment (numpy) into ``keep``."""
    import numpy as np
    import torch

    from rio_tpu_torch import tracing
    from rio_tpu_torch.object_placement import AffinityTracker, TorchObjectPlacement
    from rio_tpu_torch.object_placement import torch_placement as tp
    from rio_tpu_torch.ops import prng
    from rio_tpu_torch.ops.potential_round import MAX_KERNEL_COLS
    from rio_tpu_torch.parallel.hierarchical import (
        chunked_hierarchical_assign,
        chunked_hierarchical_assign_timed,
        hierarchical_assign,
    )
    from rio_tpu_torch.registry import ObjectId

    addrs = [f"10.{i // 256}.{i % 256}.2:5000" for i in range(DIR_NODES)]
    dead = hier_dead()
    out: dict = {}

    def members(gone) -> list:
        return [_Member(a, i not in gone) for i, a in enumerate(addrs)]

    stats_fields, seat_array = hier_stats_fields, seat_array_of

    # -- hier_features: _hash_features for HIER_OBJ keys ------------------------
    keys = [f"Hier.{i}" for i in range(HIER_OBJ)]
    t0 = time.perf_counter()
    seeds = tp._key_seeds(keys)
    crc_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    feats = tp._hash_features(keys, device=dev)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_launches("_hash_features")
    peak = torch.cuda.max_memory_allocated()
    # The draws alone, from seeds already on the card (_hash_features' loop).
    seeds_t = torch.from_numpy(seeds).to(dev)
    draws = torch.empty_like(feats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, HIER_OBJ, tp._HASH_CHUNK_KEYS):
        draws[start:start + tp._HASH_CHUNK_KEYS] = prng.normal(
            seeds_t[start:start + tp._HASH_CHUNK_KEYS], tp._FEAT_DIM
        )
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(draws, feats), "the draws differ from _hash_features")
    sample = np.arange(0, HIER_OBJ, HIER_OBJ // HIER_SAMPLE)[:HIER_SAMPLE]
    sample_keys = [keys[i] for i in sample]
    sample_seeds = torch.from_numpy(tp._key_seeds(sample_keys))
    words_equal = torch.equal(
        prng.random_bits(sample_seeds.to(dev), tp._FEAT_DIM).cpu(),
        prng.random_bits(sample_seeds, tp._FEAT_DIM),
    )
    check(words_equal, "threefry words on the card differ from the CPU's")
    feat_err = float((feats[torch.from_numpy(sample).to(dev)].cpu()
                      - tp._hash_features(sample_keys)).abs().max())
    check(feat_err <= TOL_HIER_FEATURES, f"features on the card vs the CPU: max |d| {feat_err}")
    out.update(features_ms=total_ms, features_crc_ms=crc_ms, features_draw_ms=draw_ms)
    emit("hier_features", **card, n=HIER_OBJ, dim=tp._FEAT_DIM, wall_ms=total_ms, crc_ms=crc_ms,
         draw_ms=draw_ms, sample=HIER_SAMPLE, words_equal=words_equal, max_abs_err=feat_err,
         tol=TOL_HIER_FEATURES, peak_bytes=peak, launches=launches)
    del keys, seeds, feats, draws, seeds_t

    # -- hier_assign: chunked_hierarchical_assign_timed at the provider's shape --
    obj, node, cap, alive, kw, n_chunks = hier_assign_inputs(dev, dead)
    n_pad, n_groups, bucket = obj.shape[0], kw["n_groups"], kw["bucket"]
    rows = n_pad // n_chunks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res, chunk_ms = chunked_hierarchical_assign_timed(obj, node, cap, alive, n_chunks=n_chunks, **kw)
    assignment = res.assignment.cpu().numpy()
    assign_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_launches("the hierarchical solve")
    peak = torch.cuda.max_memory_allocated()
    check(launches["coarse_scores"] == n_chunks,
          f"{launches['coarse_scores']} coarse-score launches for {n_chunks} chunks")
    # Each chunk rounds over its groups, then over each group's members; a rounding of more
    # than MAX_KERNEL_COLS columns (here the coarse stage's 128 groups) keeps the eager twin.
    round_want = ["kernel" if cols <= MAX_KERNEL_COLS else "eager"
                  for cols in (n_groups, DIR_NODES // n_groups)] * n_chunks
    check(launches["potential_round"] == round_want.count("kernel"),
          f"{launches['potential_round']} potential-rounding launches for {n_chunks} chunks")
    check(int(res.overflow) == 0, f"overflow {int(res.overflow)}")
    spread = live_spread(np.bincount(assignment, minlength=DIR_NODES), set(dead), n_pad,
                         "hierarchical assign")
    coarse_impl, round_impl = [], []  # each chunk's spans: "kernel", not "eager"
    tracing.add_sink(lambda sp: sp.name == "hier.coarse_score" and coarse_impl.append(sp.attrs["impl"]))
    tracing.add_sink(lambda sp: sp.name == "hier.round" and round_impl.append(sp.attrs["impl"]))
    try:
        untimed = chunked_hierarchical_assign(obj, node, cap, alive, n_chunks=n_chunks, **kw)
    finally:
        tracing.clear_sinks()
    check(coarse_impl == ["kernel"] * n_chunks, f"coarse-score spans {coarse_impl}")
    check(round_impl == round_want, f"rounding spans {round_impl}")
    check(torch.equal(untimed.assignment, res.assignment) and torch.equal(untimed.group, res.group)
          and int(untimed.overflow) == int(res.overflow), "untimed form differs from the timed form")
    # Chunk 0 again on the CPU, against its own share of the capacity.
    t0 = time.perf_counter()
    cpu = hierarchical_assign(obj[:rows].cpu(), node.cpu(), cap.cpu() / n_chunks, alive.cpu(), **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    card0, cpu0 = assignment[:rows], cpu.assignment.numpy()
    agree = float(np.mean(card0 == cpu0))
    check(np.array_equal(np.bincount(card0, minlength=DIR_NODES), np.bincount(cpu0, minlength=DIR_NODES)),
          "chunk 0's node counts differ between the card and the CPU")
    check(agree >= HIER_ROW_AGREEMENT, f"chunk 0 rows agree {agree} with the CPU")
    keep["hier_assign"] = assignment  # mesh_hier's reference
    coarse_kernel = coarse_kernel_fields(obj, node, alive)
    round_kernel = potential_round_fields(obj, node, alive)
    out.update(assign_ms=assign_ms, chunk_ms_median=statistics.median(chunk_ms),
               chunk_ms_first=chunk_ms[0], chunk_ms_max=max(chunk_ms))
    emit("hier_assign", **card, n=HIER_OBJ, rows=n_pad, m=DIR_NODES, dead=HIER_DEAD,
         groups=n_groups, chunks=n_chunks, bucket=bucket, n_iters=N_ITERS, wall_ms=assign_ms,
         chunk_ms=chunk_ms, overflow=int(res.overflow), live_loads=spread,
         coarse_residual=float(res.coarse_err), cpu_chunk_ms=cpu_ms, cpu_row_agreement=agree,
         coarse_impl=coarse_impl, coarse_kernel=coarse_kernel, round_impl=round_impl,
         round_kernel=round_kernel, peak_bytes=peak, launches=launches)
    del obj, node, res, untimed, cpu, assignment

    # -- hier_directory: AffinityTracker + auto -> hierarchical ------------------
    tracker = AffinityTracker()
    p = TorchObjectPlacement(eps=EPS, n_iters=N_ITERS, node_axis_size=DIR_NODES,
                             affinity_tracker=tracker, device=dev)
    p.sync_members(members(()))
    check(p._solver_mode() == "hierarchical", f"auto with a tracker is {p._solver_mode()}")
    ids = [ObjectId("HDir", str(i)) for i in range(HIER_DIR_OBJ)]
    _, assign_ms, launches, peak = await provider_call(lambda: p.assign_batch(ids), "assign_batch")
    moved, full_ms, full_launches, full_peak = await provider_call(
        lambda: p.rebalance(delta=False), "the hierarchical rebalance")
    check(p.stats.mode == "hierarchical" and p.stats.devices == 1, f"full solve {p.stats.mode}")
    check(p.stats.chunks == max(1, tp._next_bucket(HIER_DIR_OBJ) // tp._HIER_CHUNK_ROWS),
          f"full solve in {p.stats.chunks} chunks")
    full = stats_fields(p)
    full_spread = live_spread(np.bincount(seat_array(p), minlength=DIR_NODES), set(), HIER_DIR_OBJ,
                              "hierarchical full rebalance")
    # Warm the tracker on the objects of HIER_DIR_KILL nodes spread across
    # groups: 3:1 home:secondary traffic, secondaries uniform over the
    # survivors (tests/test_affinity_payoff.py).
    homes = [5 + i * (DIR_NODES // HIER_DIR_KILL) for i in range(HIER_DIR_KILL)]
    survivors = [addrs[i] for i in range(DIR_NODES) if i not in set(homes)]
    work = [(k, addrs[j]) for k, j in p._placements.items() if j in set(homes)]
    secondary = {k: survivors[(i * 7 + 3) % len(survivors)] for i, (k, _) in enumerate(work)}
    t0 = time.perf_counter()
    for k, home in work:
        for _ in range(4):
            for _ in range(3):
                tracker.observe(k, home)
            tracker.observe(k, secondary[k])
    warm_ms = (time.perf_counter() - t0) * 1e3
    # The tracker draws on the provider's card: its learned and cold
    # features and its node embeddings equal a CPU tracker's on the same
    # calls, bit for bit.
    check(tracker.device == p.device, f"the tracker draws on {tracker.device}")
    cpu_tracker = AffinityTracker(device="cpu")
    probe = [k for k, _ in work[:HIER_TRACKER_PROBE]]
    for k in probe:
        home = addrs[p._placements[k]]
        for _ in range(4):
            for _ in range(3):
                cpu_tracker.observe(k, home)
            cpu_tracker.observe(k, secondary[k])
    probe += [f"HCold.{i}" for i in range(HIER_TRACKER_PROBE)]
    check(np.array_equal(tracker.obj_features(probe), cpu_tracker.obj_features(probe))
          and np.array_equal(tracker.node_features(addrs), cpu_tracker.node_features(addrs)),
          "the tracker's features on the card differ from the CPU's")
    # One cold key's draw, host-bound: the tracker's captured graph against
    # eager launches (median wall us of a call, which ends in a copy back).
    one_key_us = host_median_us(lambda: tracker._draw(["HCold.0"]), reps=200)
    eager_key_us = host_median_us(lambda: tp._hash_features(["HCold.0"], device=dev).cpu(), reps=50)
    before = seat_array(p)
    p.sync_members(members(set(homes)))
    moved, delta_ms, delta_launches, delta_peak = await provider_call(
        lambda: p.rebalance(), "the hierarchical delta")
    check(p.stats.mode == "hierarchical+delta", f"churn solve {p.stats.mode}")
    after = seat_array(p)
    on_dead = np.isin(before, homes)
    undisplaced = int(((before != after) & ~on_dead).sum())
    check(moved == p.stats.displaced == int(on_dead.sum()) == len(work),
          f"delta moved {moved}, displaced {p.stats.displaced}, dead nodes held {int(on_dead.sum())}")
    check(undisplaced == 0, f"{undisplaced} undisplaced objects moved")
    check(int(np.isin(after, homes).sum()) == 0, "objects left on dead nodes")
    index = {a: i for i, a in enumerate(addrs)}
    hits = sum(p._placements[k] == index[secondary[k]] for k, _ in work)
    hit_rate = hits / len(work)
    chance = 1.0 / len(survivors)
    check(hit_rate >= 10 * chance, f"locality hit rate {hit_rate} against chance {chance}")
    out.update(dir_assign_ms=assign_ms, dir_full_ms=full_ms, dir_full_solve_ms=full["solve_ms"],
               dir_warm_ms=warm_ms, dir_delta_ms=delta_ms, dir_delta_solve_ms=p.stats.solve_ms)
    emit("hier_directory", **card, n=HIER_DIR_OBJ, m=DIR_NODES, killed=HIER_DIR_KILL,
         assign={"wall_ms": assign_ms, "peak_bytes": peak, "launches": launches},
         full={"wall_ms": full_ms, **full, "live_loads": full_spread, "peak_bytes": full_peak,
               "launches": full_launches},
         warm_ms=warm_ms, warmed_objects=len(work), tracker_device=str(tracker.device),
         one_key_draw_us=one_key_us, eager_one_key_draw_us=eager_key_us,
         wall_ms=delta_ms, **stats_fields(p),
         undisplaced_moves=undisplaced, locality_hit_rate=hit_rate, chance=chance,
         peak_bytes=delta_peak, launches=delta_launches)
    del p, tracker, ids, work, secondary

    # -- hier_at_scale: a flat mode above _FLAT_REBALANCE_MAX_ROWS ---------------
    p = TorchObjectPlacement(mode="sinkhorn", eps=EPS, n_iters=N_ITERS, node_axis_size=DIR_NODES,
                             device=dev)
    p.sync_members(members(()))
    ids = [ObjectId("Hier", str(i)) for i in range(HIER_OBJ)]
    _, assign_ms, launches, peak = await provider_call(lambda: p.assign_batch(ids), "assign_batch")
    del ids
    steps = {}
    for step, gone in (("kill", set(dead)),):
        before = seat_array(p)
        p.sync_members(members(gone))
        moved, ms, step_launches, step_peak = await provider_call(
            lambda: p.rebalance(delta=False), "the routed rebalance")
        check(p.stats.mode == "sinkhorn+hier_at_scale", f"{step}: routed rebalance ran {p.stats.mode}")
        check(p.stats.chunks == n_chunks and p.stats.devices == 1,
              f"{step}: {p.stats.chunks} chunks on {p.stats.devices} devices")
        after = seat_array(p)
        spread = live_spread(np.bincount(after, minlength=DIR_NODES), gone, HIER_OBJ,
                             f"routed rebalance ({step})")
        undisplaced = int(((before != after) & ~np.isin(before, list(gone))).sum())
        steps[step] = {"wall_ms": ms, **stats_fields(p), "live_loads": spread,
                       "undisplaced_moves": undisplaced, "peak_bytes": step_peak,
                       "launches": step_launches}
    out.update(scale_assign_ms=assign_ms, scale_kill_ms=steps["kill"]["wall_ms"], scale_kill_solve_ms=steps["kill"]["solve_ms"])
    emit("hier_at_scale", **card, n=HIER_OBJ, m=DIR_NODES, killed=HIER_DEAD,
         assign={"wall_ms": assign_ms, "peak_bytes": peak, "launches": launches}, **steps)
    return out


def affinity_edge_rows(n_obj: int, n_rows: int, seed: int) -> list[list]:
    """``merge_edges`` rows over objects ``Aff.<i>`` (i < n_obj): half disjoint
    producer -> consumer pairs, half ``AFF_STAR_LEAVES``-leaf stars, on distinct
    objects drawn from ``seed``. Byte rates follow Zipf(``AFF_ZIPF``) over the
    rows' ranks (the row of rank r sends ``AFF_TOP_BPS / r**AFF_ZIPF`` B/s), in a
    random order; every row makes ``AFF_CALLS`` calls a second."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_pairs = n_rows // 2
    n_stars = (n_rows - n_pairs) // AFF_STAR_LEAVES
    n_star_rows = n_stars * AFF_STAR_LEAVES
    need = 2 * n_pairs + n_stars * (AFF_STAR_LEAVES + 1)
    check(n_pairs + n_star_rows == n_rows and need <= n_obj, f"{n_rows} edge rows over {n_obj} objects")
    obj = rng.permutation(n_obj)[:need]
    hubs = obj[2 * n_pairs : 2 * n_pairs + n_stars]
    src = np.concatenate([obj[0 : 2 * n_pairs : 2], np.repeat(hubs, AFF_STAR_LEAVES)])
    dst = np.concatenate([obj[1 : 2 * n_pairs : 2], obj[2 * n_pairs + n_stars :]])
    bps = AFF_TOP_BPS / (rng.permutation(n_rows) + 1.0) ** AFF_ZIPF
    return [[f"Aff.{a}", f"Aff.{b}", float(x), AFF_CALLS, 0.0]
            for a, b, x in zip(src.tolist(), dst.tolist(), bps.tolist())]


def solve_fields(p) -> dict:
    """The last solve's mode, times and counts."""
    s = p.stats
    return {"mode": s.mode, "solve_ms": s.solve_ms, "apply_ms": s.apply_ms,
            "moved": s.moved, "displaced": s.displaced}


class RefineTimer:
    """Collects the refine's spans through a sink on the port's tracing,
    registered while the block runs: ``affinity_refine_prep`` (host
    preparation), ``affinity_refine_index`` inside it (the key index over the
    directory and the edge lookup) and ``affinity_refine_pass`` (each pass's
    device work, ending in the pull of its seats)."""

    def __enter__(self):
        from rio_tpu_torch import tracing

        self.prep_ms: list[float] = []
        self.index_ms: list[float] = []
        self.pass_ms: list[float] = []
        names = {"affinity_refine_prep": self.prep_ms, "affinity_refine_index": self.index_ms,
                 "affinity_refine_pass": self.pass_ms}

        def sink(s) -> None:
            if s.name in names:
                names[s.name].append(s.duration * 1e3)

        tracing.add_sink(sink)
        return self

    def __exit__(self, *exc) -> bool:
        from rio_tpu_torch import tracing

        tracing.clear_sinks()
        return False

    def fields(self) -> dict:
        return {"refine_prep_ms": sum(self.prep_ms), "refine_index_ms": sum(self.index_ms),
                "refine_pass_ms": self.pass_ms,
                "refine_ms": sum(self.prep_ms) + sum(self.pass_ms)}


def check_history(p, what: str) -> list:
    """The refine ran and changed seats: accepted passes with non-increasing
    ``cut`` and ``total`` (the acceptance test's 1e-9), one of them past pass 0."""
    hist = [dict(h) for h in p._affinity_history]
    accepted = [h for h in hist if h["accepted"]]
    for prev, cur in zip(accepted, accepted[1:]):
        check(cur["cut"] <= prev["cut"] + 1e-9 and cur["total"] <= prev["total"] + 1e-9,
              f"{what}: an accepted pass raised cut or total: {hist}")
    check(any(h["pass"] > 0 for h in accepted), f"{what}: no pass past 0 accepted: {hist}")
    return hist


async def affinity_phases(dev, card: dict) -> dict:
    """The ``affinity`` group (phase 14): returns the times it printed."""
    import numpy as np
    import torch

    from rio_tpu_torch.object_placement import AffinityTracker, TorchObjectPlacement
    from rio_tpu_torch.object_placement import torch_placement as tp
    from rio_tpu_torch.registry import ObjectId

    addrs = [f"10.{80 + h // 256}.{h % 256}.1:{5000 + w}"
             for h in range(AFF_HOSTS) for w in range(AFF_WORKERS)]
    m = len(addrs)
    out: dict = {}

    def provider(device, **kw) -> TorchObjectPlacement:
        p = TorchObjectPlacement(eps=EPS, n_iters=N_ITERS, move_cost=DIR_MOVE_COST,
                                 node_axis_size=m, affinity_weight=AFF_WEIGHT, device=device, **kw)
        p.sync_members([_Member(a, True) for a in addrs])
        return p

    def seat_array(p) -> np.ndarray:
        return np.fromiter(p._placements.values(), np.int64, count=p.count())

    async def seated(device, n_obj, rows, **kw):
        """A provider with ``n_obj`` objects assigned and the graph installed;
        the assign's wall ms and the installed edge count."""
        p = provider(device, **kw)
        t0 = time.perf_counter()
        await p.assign_batch([ObjectId("Aff", str(i)) for i in range(n_obj)])
        assign_ms = (time.perf_counter() - t0) * 1e3
        edges = p.set_edge_graph(rows)
        check(edges > 0, "no edge installed")
        return p, assign_ms, edges

    def copied(device, keys, seats, **kw) -> TorchObjectPlacement:
        """A provider holding ``keys`` on ``seats`` (another provider's
        directory, by node index) with the graph installed: the same state
        without a second ``assign_batch``."""
        q = provider(device, **kw)
        q._apply_chunk(keys, seats)
        check(q.set_edge_graph(rows) == edges, "the copy installed another graph")
        return q

    async def refine(p, what: str) -> tuple:
        with RefineTimer() as timer:
            moved, ms, launches, peak = await provider_call(
                lambda: p.rebalance(delta=False), what)
        return moved, {"wall_ms": ms, **solve_fields(p), **timer.fields(),
                       "peak_bytes": peak, "launches": launches}

    # -- affinity_refine: 1,048,576 objects, 524,288 edge rows ------------------
    t0 = time.perf_counter()
    rows = affinity_edge_rows(AFF_OBJ, AFF_ROWS, seed=3)
    rows_ms = (time.perf_counter() - t0) * 1e3
    p, assign_ms, edges = await seated(dev, AFF_OBJ, rows, mode="sinkhorn")
    keys, before = list(p._placements), seat_array(p)
    moved, res = await refine(p, "the refined rebalance")
    check(p.stats.mode == "sinkhorn+collapsed+affinity", f"refined solve ran {p.stats.mode}")
    hist = check_history(p, "affinity_refine")
    after = seat_array(p)
    n_changed = int((before != after).sum())
    check(0 < moved == n_changed <= tp._AFFINITY_MAX_ROWS,
          f"moved {moved}, seats changed {n_changed}, cap {tp._AFFINITY_MAX_ROWS}")
    counts = np.bincount(after, minlength=m)
    slack_cap = AFF_OBJ / m * p._affinity_slack + 1.0
    check(int(counts.max()) <= slack_cap, f"a node holds {int(counts.max())} > slack cap {slack_cap}")
    # The refined subset (the 4,096 heaviest-degree objects, with the
    # refine's degrees) and the weight share of its edges on one worker and
    # on one host, before and after.
    e_src = np.fromiter((int(a[4:]) for a, _ in p._edge_graph), np.int64, count=edges)
    e_dst = np.fromiter((int(b[4:]) for _, b in p._edge_graph), np.int64, count=edges)
    e_w = np.fromiter(p._edge_graph.values(), np.float32, count=edges)
    deg = np.zeros(AFF_OBJ, np.float32)
    np.add.at(deg, np.concatenate([e_src, e_dst]), np.concatenate([e_w, e_w]))
    touching = np.nonzero(deg > 0.0)[0]
    sub = touching[np.argsort(-deg[touching], kind="stable")[:tp._AFFINITY_MAX_ROWS]]
    in_sub = np.zeros(AFF_OBJ, bool)
    in_sub[sub] = True
    sub_edges = in_sub[e_src] | in_sub[e_dst]

    def shares(seats) -> dict:
        w = e_w[sub_edges]
        a, b = seats[e_src[sub_edges]], seats[e_dst[sub_edges]]
        total = float(w.sum())
        return {"same_worker": float(w[a == b].sum()) / total,
                "same_host": float(w[a // AFF_WORKERS == b // AFF_WORKERS].sum()) / total}

    share_before, share_after = shares(before), shares(after)
    check(share_after["same_worker"] > share_before["same_worker"],
          f"the subset's same-worker share fell: {share_before} -> {share_after}")
    out.update(aff_rows_ms=rows_ms, aff_assign_ms=assign_ms, aff_refine_wall_ms=res["wall_ms"],
               aff_refine_solve_ms=res["solve_ms"], aff_refine_prep_ms=res["refine_prep_ms"],
               aff_refine_pass_ms=res["refine_pass_ms"])
    emit("affinity_refine", **card, n=AFF_OBJ, m=m, hosts=AFF_HOSTS, workers=AFF_WORKERS,
         edge_rows=AFF_ROWS, edges=edges, subset=int(sub.size), subset_edges=int(sub_edges.sum()),
         rows_ms=rows_ms, assign_ms=assign_ms, **res, history=hist, max_node=int(counts.max()),
         slack_cap=float(slack_cap), subset_share_before=share_before,
         subset_share_after=share_after)

    # -- affinity_repeat: the same solve from the same state ---------------------
    p2 = copied(dev, keys, before, mode="sinkhorn")
    _, res2 = await refine(p2, "the repeated refine")
    equal_seats = bool(np.array_equal(seat_array(p2), after))
    check(equal_seats and p2._affinity_history == p._affinity_history and res2["mode"] == res["mode"],
          "the repeated refine differs from the first")
    out.update(aff_repeat_wall_ms=res2["wall_ms"], aff_repeat_solve_ms=res2["solve_ms"])
    emit("affinity_repeat", **card, n=AFF_OBJ, m=m, **res2, equal_seats=equal_seats,
         equal_history=True)
    del p, p2, after, e_src, e_dst, e_w, deg

    # -- affinity_cpu_vs_card: 65,536 objects, 32,768 edge rows ------------------
    cmp_rows = affinity_edge_rows(AFF_CMP_OBJ, AFF_CMP_ROWS, seed=4)
    side = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        q, _, _ = await seated(device, AFF_CMP_OBJ, cmp_rows, mode="sinkhorn")
        _, res_q = await refine(q, f"the refine on the {name}")
        check(q.stats.mode == "sinkhorn+collapsed+affinity", f"{name}: refined solve ran {q.stats.mode}")
        side[name] = (seat_array(q), [dict(h) for h in q._affinity_history], res_q)
    (seats_cpu, hist_cpu, res_cpu), (seats_card, hist_card, res_card) = side["cpu"], side["card"]
    check([(h["pass"], h["accepted"]) for h in hist_cpu] == [(h["pass"], h["accepted"]) for h in hist_card],
          f"accepted flags differ: {hist_cpu} vs {hist_card}")
    cut_err = max(abs(a["cut"] - b["cut"]) for a, b in zip(hist_cpu, hist_card))
    check(cut_err <= TOL_AFF_CUT, f"cut differs by {cut_err}")
    agree = float(np.mean(seats_cpu == seats_card))
    check(agree >= AFF_SEAT_AGREEMENT, f"seats agree on {agree}")
    out.update(aff_cmp_cpu_solve_ms=res_cpu["solve_ms"], aff_cmp_card_solve_ms=res_card["solve_ms"])
    emit("affinity_cpu_vs_card", **card, n=AFF_CMP_OBJ, m=m, edge_rows=AFF_CMP_ROWS,
         seat_agreement=agree, cut_max_abs_err=cut_err, tol=TOL_AFF_CUT, history=hist_card,
         on_cpu={k: res_cpu[k] for k in ("wall_ms", "solve_ms", "refine_ms", "moved")},
         on_card={k: res_card[k] for k in ("wall_ms", "solve_ms", "refine_ms", "moved", "launches")})
    del side, cmp_rows, q

    # -- affinity_hier: the same graph after the hierarchical solve --------------
    p = copied(dev, keys, before, affinity_tracker=AffinityTracker())
    del keys, before
    check(p._solver_mode() == "hierarchical", f"auto with a tracker is {p._solver_mode()}")
    _, res = await refine(p, "the hierarchical refine")
    check(p.stats.mode == "hierarchical+affinity", f"hierarchical solve ran {p.stats.mode}")
    hist = check_history(p, "affinity_hier")
    out.update(aff_hier_wall_ms=res["wall_ms"], aff_hier_solve_ms=res["solve_ms"],
               aff_hier_refine_ms=res["refine_ms"])
    emit("affinity_hier", **card, n=AFF_OBJ, m=m, edge_rows=AFF_ROWS, **res,
         chunks=p.stats.chunks, history=hist)
    return out


async def persistent_phases(dev, card: dict) -> dict:
    """The ``persistent`` group (phase 15): returns the times it printed."""
    import numpy as np

    from rio_tpu_torch.object_placement import LocalObjectPlacement, PersistentTorchObjectPlacement
    from rio_tpu_torch.ops import integer_fair_quotas
    from rio_tpu_torch.registry import ObjectId

    addrs = [f"10.{i // 256}.{i % 256}.3:5000" for i in range(DIR_NODES)]
    killed = sorted(int(i) for i in np.random.default_rng(5).choice(DIR_NODES, PERS_KILL, replace=False))
    dead = set(killed)
    live = [_Member(a, i not in dead) for i, a in enumerate(addrs)]
    out: dict = {}

    def provider() -> PersistentTorchObjectPlacement:
        # The background flusher never fires inside a phase: every row is
        # written by the phase's own timed flush().
        return PersistentTorchObjectPlacement(
            backing, flush_interval=PERS_FLUSH_INTERVAL, mode="sinkhorn", eps=EPS,
            n_iters=N_ITERS, move_cost=DIR_MOVE_COST, node_axis_size=DIR_NODES, device=dev)

    def rows_of(p) -> dict:
        return {k: p._node_order[i] for k, i in p._placements.items()}

    async def flush(p) -> tuple[int, float]:
        t0 = time.perf_counter()
        n = await p.flush()
        return n, (time.perf_counter() - t0) * 1e3

    # -- persistent_assign ------------------------------------------------------
    backing = LocalObjectPlacement()
    p = provider()
    p.sync_members([_Member(a, True) for a in addrs])
    await p.prepare()
    check(p.count() == 0, "an empty backing restored rows")
    ids = [ObjectId("Pers", str(i)) for i in range(PERS_OBJ)]
    _, assign_ms, launches, peak = await provider_call(lambda: p.assign_batch(ids), "assign_batch")
    written, flush_ms = await flush(p)
    check(written == PERS_OBJ == backing.count(), f"flushed {written}, backing holds {backing.count()}")
    check(backing._placements == rows_of(p), "the backing differs from the directory")
    out.update(pers_assign_ms=assign_ms, pers_flush_ms=flush_ms,
               pers_flush_us_per_row=flush_ms * 1e3 / written)
    emit("persistent_assign", **card, n=PERS_OBJ, m=DIR_NODES, wall_ms=assign_ms, rows=written,
         flush_ms=flush_ms, flush_us_per_row=flush_ms * 1e3 / written, peak_bytes=peak,
         launches=launches)
    del ids

    # -- persistent_churn: 30 nodes die, the delta path, an exact flush ----------
    moved, settle_ms, _, _ = await provider_call(lambda: p.rebalance(delta=False), "the settle")
    settled, _ = await flush(p)
    check(moved == settled == 0, f"the settle moved {moved}, flushed {settled}")
    before = rows_of(p)
    p.sync_members(live)
    moved, ms, launches, peak = await provider_call(lambda: p.rebalance(), "the churn rebalance")
    check(p.stats.mode == "sinkhorn+delta", f"churn solve ran {p.stats.mode}")
    after = rows_of(p)
    changed = {k for k, a in after.items() if before[k] != a}
    check(moved == len(changed) == p.stats.displaced == PERS_KILL * (PERS_OBJ // DIR_NODES),
          f"moved {moved}, changed {len(changed)}, displaced {p.stats.displaced}")
    check(set(p._dirty) == changed, "the dirty set is not the moved rows")
    written, churn_flush_ms = await flush(p)
    check(written == moved, f"flushed {written} rows for {moved} moves")
    check(backing._placements == after, "the backing differs from the directory after the churn")
    dead_addrs = {addrs[i] for i in killed}
    check(not dead_addrs & set(backing._placements.values()), "a backing row names a dead node")
    out.update(pers_churn_ms=ms, pers_churn_solve_ms=p.stats.solve_ms, pers_churn_flush_ms=churn_flush_ms)
    emit("persistent_churn", **card, n=PERS_OBJ, m=DIR_NODES, killed=PERS_KILL, wall_ms=ms,
         **solve_fields(p), settle_ms=settle_ms, rows=written, flush_ms=churn_flush_ms,
         flush_us_per_row=churn_flush_ms * 1e3 / written, peak_bytes=peak, launches=launches)
    await p.aclose()

    # -- persistent_restore: a fresh provider over the same backing --------------
    q = provider()
    _, restore_ms, launches, _ = await provider_call(q.prepare, "the restore")
    restored = rows_of(q)
    check(restored == after, "the restored directory differs from the first provider's")
    per_node = np.bincount(np.fromiter(q._placements.values(), np.int64, count=q.count()),
                           minlength=len(q._node_order))
    check(all(s.load == per_node[s.index] for s in q._nodes.values()), "loads were not recounted")
    nodes_restored = len(q._nodes)
    check(nodes_restored == DIR_NODES - PERS_KILL and not any(s.alive for s in q._nodes.values()),
          "restored nodes are not all dead before registration")
    check(q._dirty == {}, "the restore marked rows dirty")
    q.sync_members(live)
    moved, ms, full_launches, peak = await provider_call(
        lambda: q.rebalance(delta=False), "the restored rebalance")
    check(q.stats.mode == "sinkhorn+collapsed", f"restored full solve ran {q.stats.mode}")
    counts = np.bincount(np.fromiter(q._placements.values(), np.int64, count=q.count()),
                         minlength=len(q._node_order))
    live_idx = [q._nodes[a].index for a in addrs if a not in dead_addrs]
    dead_idx = [q._nodes[a].index for a in dead_addrs]
    quota = integer_fair_quotas(np.ones(len(live_idx)), PERS_OBJ)
    check(int(counts[dead_idx].sum()) == 0, "objects on dead nodes after the restore")
    check(bool(np.array_equal(np.sort(counts[live_idx]), np.sort(quota))),
          "restored rebalance: live nodes off their integer fair quotas")
    written, final_flush_ms = await flush(q)
    check(written == moved, f"flushed {written} rows for {moved} moves")
    check(backing._placements == rows_of(q), "the backing differs after the restored rebalance")
    await q.aclose()
    out.update(pers_restore_ms=restore_ms, pers_restore_us_per_row=restore_ms * 1e3 / len(restored),
               pers_restored_rebalance_ms=ms, pers_restored_solve_ms=q.stats.solve_ms)
    emit("persistent_restore", **card, n=len(restored), m=DIR_NODES, restore_ms=restore_ms,
         restore_us_per_row=restore_ms * 1e3 / len(restored), restore_launches=launches,
         nodes_restored=nodes_restored, wall_ms=ms, **solve_fields(q), rows=written,
         flush_ms=final_flush_ms, peak_bytes=peak, launches=full_launches)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def measured(fn, what: str):
    """Run ``fn`` with both kernel counts at 0: its result, wall ms after a
    device synchronize, the counts (each must be 0) and the peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return result, ms, _read_launches(what), torch.cuda.max_memory_allocated()


async def mesh_phases(dev, card: dict, hier_assignment) -> tuple[dict, dict]:
    """The ``mesh`` group (phase 16): returns the times it printed and each
    kernel's launches summed over the group (0). ``hier_assignment`` is
    ``hier_assign``'s 32-chunk single-device result."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rio_tpu_torch import entry
    from rio_tpu_torch.object_placement import TorchObjectPlacement
    from rio_tpu_torch.object_placement import torch_placement as tp
    from rio_tpu_torch.ops import integer_fair_quotas, scaling_sinkhorn, sinkhorn, sinkhorn_assign
    from rio_tpu_torch.parallel import (
        make_mesh,
        multihost,
        shard_cost,
        sharded_scaling_sinkhorn,
        sharded_sinkhorn,
        sharded_sinkhorn_assign,
    )
    from rio_tpu_torch.parallel.hierarchical import (
        mesh_chunked_hierarchical_assign,
        mesh_chunked_hierarchical_assign_timed,
        sharded_hierarchical_assign,
    )
    from rio_tpu_torch.registry import ObjectId

    mesh = make_mesh([dev] * MESH_SHARDS)
    check(mesh.devices.shape == (4, 2) and not mesh.distributed, f"mesh {mesh}")
    out: dict = {}
    launches_total = dict.fromkeys(_launches(), 0)

    def count(launches: dict) -> dict:
        for k, v in launches.items():
            launches_total[k] += v
        return launches

    async def provider_step(coro_fn, what: str):
        result, ms, launches, peak = await provider_call(coro_fn, what)
        return result, ms, count(launches), peak

    # -- mesh_flat: the dense sharded solves at 1,048,576 x 1,024 ----------------
    cost, mass, cap = entry.make_problem(N_OBJ, N_NODES, seed=0, device=dev)
    sc = shard_cost(mesh, cost)
    views = all(b.untyped_storage().data_ptr() == cost.untyped_storage().data_ptr()
                for b in sc.blocks.values())
    check(views and len(sc.blocks) == MESH_SHARDS, "shard_cost copied the cost")
    flat: dict = {}
    (f_ld, g_ld), ms, launches, peak = measured(
        lambda: sharded_sinkhorn(mesh, sc, mass, cap, eps=EPS, n_iters=N_ITERS), "sharded_sinkhorn")
    single, single_ms, _, single_peak = measured(
        lambda: sinkhorn(cost, mass, cap, eps=EPS, n_iters=N_ITERS), "sinkhorn")
    flat["sharded_sinkhorn"] = {
        "wall_ms": ms, "single_ms": single_ms, "peak_bytes": peak, "single_peak_bytes": single_peak,
        "f_max_abs": max_abs_close(f_ld, single.f, TOL_MESH, "sharded_sinkhorn f"),
        "g_max_abs": max_abs_close(g_ld, single.g, TOL_MESH, "sharded_sinkhorn g"), "launches": count(launches)}
    del single, f_ld, g_ld
    (f_sc, g_sc), ms, launches, peak = measured(
        lambda: sharded_scaling_sinkhorn(mesh, sc, mass, cap, eps=EPS, n_iters=N_ITERS,
                                         kernel_dtype=torch.bfloat16), "sharded_scaling_sinkhorn")
    single, single_ms, _, single_peak = measured(
        lambda: scaling_sinkhorn(cost, mass, cap, eps=EPS, n_iters=N_ITERS, kernel_dtype=torch.bfloat16),
        "scaling_sinkhorn")
    flat["sharded_scaling_sinkhorn"] = {
        "kernel_dtype": "bfloat16", "wall_ms": ms, "single_ms": single_ms, "peak_bytes": peak,
        "single_peak_bytes": single_peak,
        "f_max_abs": max_abs_close(f_sc, single.f, TOL_MESH, "sharded_scaling_sinkhorn f"),
        "g_max_abs": max_abs_close(g_sc, single.g, TOL_MESH, "sharded_scaling_sinkhorn g"),
        "launches": count(launches)}
    del single, f_sc, g_sc
    rows_sh, ms, launches, peak = measured(
        lambda: sharded_sinkhorn_assign(mesh, sc, mass, cap, eps=EPS, n_iters=N_ITERS),
        "sharded_sinkhorn_assign")
    rows_si, _ = sinkhorn_assign(cost, mass, cap, eps=EPS, n_iters=N_ITERS)
    mismatch = float((rows_sh != rows_si).float().mean())
    check(mismatch <= MESH_ROW_MISMATCH, f"sharded rows differ from the single-device rounding on {mismatch}")
    flat["sharded_sinkhorn_assign"] = {"wall_ms": ms, "peak_bytes": peak, "row_mismatch": mismatch,
                                       "launches": count(launches)}
    out.update(flat_sinkhorn_ms=flat["sharded_sinkhorn"]["wall_ms"],
               flat_single_sinkhorn_ms=flat["sharded_sinkhorn"]["single_ms"],
               flat_scaling_ms=flat["sharded_scaling_sinkhorn"]["wall_ms"],
               flat_single_scaling_ms=flat["sharded_scaling_sinkhorn"]["single_ms"],
               flat_assign_ms=ms)
    emit("mesh_flat", **card, n=N_OBJ, m=N_NODES, mesh=mesh.shape, eps=EPS, n_iters=N_ITERS,
         tol=TOL_MESH, cost_bytes=cost.numel() * cost.element_size(), cost_held_once=views,
         max_row_mismatch=MESH_ROW_MISMATCH, **flat)
    del cost, mass, cap, sc, rows_sh, rows_si
    torch.cuda.empty_cache()

    # -- mesh_hier: BASELINE row 5 over 8 shards x 4 chunks -----------------------
    dead = hier_dead()
    obj, node, cap, alive, kw, n_chunks = hier_assign_inputs(dev, dead)
    check(n_chunks == MESH_SHARDS * MESH_CHUNKS, f"hier_assign ran {n_chunks} chunks")
    (res, chunk_ms), ms, launches, peak = measured(
        lambda: mesh_chunked_hierarchical_assign_timed(mesh, obj, node, cap, alive, n_chunks=MESH_CHUNKS, **kw),
        "the mesh x chunk solve")
    assignment = res.assignment.cpu().numpy()
    equal = bool(np.array_equal(assignment, hier_assignment))
    check(equal, "the 8 x 4 mesh solve differs from hier_assign's 32 chunks")
    check(int(res.overflow) == 0, f"overflow {int(res.overflow)}")
    spread = live_spread(np.bincount(assignment, minlength=DIR_NODES), set(dead), obj.shape[0], "mesh_hier")
    untimed, untimed_ms, untimed_launches, _ = measured(
        lambda: mesh_chunked_hierarchical_assign(mesh, obj, node, cap, alive, n_chunks=MESH_CHUNKS, **kw),
        "the untimed mesh x chunk solve")
    check(torch.equal(untimed.assignment, res.assignment) and torch.equal(untimed.group, res.group)
          and int(untimed.overflow) == int(res.overflow) and torch.equal(untimed.coarse_g, res.coarse_g),
          "the untimed form differs from the timed form")
    count(untimed_launches)
    out.update(hier_ms=ms, hier_untimed_ms=untimed_ms, hier_chunk_ms_median=statistics.median(chunk_ms))
    emit("mesh_hier", **card, n=HIER_OBJ, rows=obj.shape[0], m=DIR_NODES, dead=HIER_DEAD,
         mesh=mesh.shape, chunks_a_shard=MESH_CHUNKS, cells=MESH_SHARDS * MESH_CHUNKS,
         cell_rows=obj.shape[0] // (MESH_SHARDS * MESH_CHUNKS), groups=kw["n_groups"], bucket=kw["bucket"],
         wall_ms=ms, chunk_ms=chunk_ms, untimed_ms=untimed_ms, overflow=int(res.overflow),
         live_loads=spread, equals_hier_assign=equal, coarse_residual=float(res.coarse_err),
         peak_bytes=peak, launches=count(launches))
    del obj, node, res, untimed, assignment
    torch.cuda.empty_cache()

    # -- mesh_directory: TorchObjectPlacement(mesh=...) at 1,048,576 x 1,024 ------
    addrs = [f"10.{i // 256}.{i % 256}.4:5000" for i in range(DIR_NODES)]
    killed = sorted(int(i) for i in np.random.default_rng(3).choice(DIR_NODES, DIR_KILL, replace=False))

    def members(gone) -> list:
        return [_Member(a, i not in gone) for i, a in enumerate(addrs)]

    ids = [ObjectId("Mesh", str(i)) for i in range(DIR_OBJ)]
    directory: dict = {}

    async def seated(**kw):
        p = TorchObjectPlacement(eps=EPS, n_iters=N_ITERS, move_cost=DIR_MOVE_COST,
                                 node_axis_size=DIR_NODES, **kw)
        p.sync_members(members(()))
        _, ms, launches, peak = await provider_step(lambda: p.assign_batch(ids), "assign_batch")
        return p, {"wall_ms": ms, "peak_bytes": peak, "launches": launches}

    async def full(p, what: str, gone=()) -> dict:
        """A timed ``rebalance(delta=False)``; moves of objects not on the
        ``gone`` nodes are counted as undisplaced."""
        before = seat_array_of(p)
        _, ms, launches, peak = await provider_step(lambda: p.rebalance(delta=False), what)
        after = seat_array_of(p)
        gone_idx = [p._nodes[addrs[i]].index for i in gone]
        undisplaced = int(((before != after) & ~np.isin(before, gone_idx)).sum())
        return {"wall_ms": ms, **hier_stats_fields(p), "warm_ratio": p.stats.warm_ratio,
                "undisplaced_moves": undisplaced, "peak_bytes": peak, "launches": launches}

    # mode="sinkhorn": the dense branch over the sharded cost, no collapse.
    p, assign = await seated(mode="sinkhorn", mesh=mesh)
    check(p.device == dev, f"the provider sits on {p.device}")
    p.sync_members(members(set(killed)))
    dense = await full(p, "the dense mesh rebalance", killed)
    check(p.stats.mode == "sinkhorn", f"the dense mesh rebalance ran {p.stats.mode}")
    counts = np.bincount(seat_array_of(p), minlength=DIR_NODES)
    live_idx = [p._nodes[a].index for i, a in enumerate(addrs) if i not in killed]
    dead_idx = [p._nodes[addrs[i]].index for i in killed]
    check(int(counts[dead_idx].sum()) == 0, "objects on dead nodes after the dense mesh rebalance")
    quota = integer_fair_quotas(np.ones(len(live_idx)), DIR_OBJ)
    check(bool(np.array_equal(np.sort(counts[live_idx]), np.sort(quota))),
          "dense mesh rebalance: live nodes off their integer fair quotas")
    directory["sinkhorn"] = {"assign": assign, **dense, "live_loads": [int(counts[live_idx].min()),
                                                                       int(counts[live_idx].max())]}
    del p

    # mode="hierarchical": every shard's rows alone, then a warm second solve.
    p, assign = await seated(mode="hierarchical", mesh=mesh)
    p.sync_members(members(set(killed)))
    first = await full(p, "the hierarchical mesh rebalance", killed)
    check(p.stats.mode == "hierarchical" and p.stats.devices == MESH_SHARDS and p.stats.chunks == 1,
          f"hierarchical mesh rebalance: {p.stats.mode} on {p.stats.devices} shards, {p.stats.chunks} chunks")
    first["live_loads"] = live_spread(np.bincount(seat_array_of(p), minlength=DIR_NODES), set(killed),
                                      DIR_OBJ, "hierarchical mesh rebalance")
    second = await full(p, "the warm hierarchical mesh rebalance", killed)
    check(p.stats.mode == "hierarchical" and p.stats.warm_ratio > 0,
          f"second mesh solve: {p.stats.mode}, warm ratio {p.stats.warm_ratio}")
    directory["hierarchical"] = {"assign": assign, "first": first, "second": second}
    del p

    # A 1-shard mesh against no mesh, on the same directory.
    one, _ = await seated(mode="hierarchical", mesh=make_mesh([dev]))
    plain, _ = await seated(mode="hierarchical", device=dev)
    check(one._placements == plain._placements, "the two directories differ before the solve")
    one_full = await full(one, "the 1-shard mesh rebalance")
    plain_full = await full(plain, "the single-device rebalance")
    chunks = max(1, tp._next_bucket(DIR_OBJ) // tp._HIER_CHUNK_ROWS)
    check(one.stats.mode == "hierarchical+mesh_chunk" and one.stats.devices == 1 and one.stats.chunks == chunks,
          f"1-shard mesh: {one.stats.mode}, {one.stats.devices} shards, {one.stats.chunks} chunks")
    check(plain.stats.mode == "hierarchical" and plain.stats.chunks == chunks, f"no mesh: {plain.stats.mode}")
    equal_seats = one._placements == plain._placements
    check(equal_seats, "the 1-shard mesh's seats differ from the single-device provider's")
    directory["one_shard"] = {"mesh": one_full, "no_mesh": plain_full, "equal_seats": equal_seats}
    del one, plain, ids
    out.update(dir_dense_ms=directory["sinkhorn"]["wall_ms"], dir_dense_solve_ms=directory["sinkhorn"]["solve_ms"],
               dir_hier_ms=first["wall_ms"], dir_hier_solve_ms=first["solve_ms"],
               dir_hier_warm_solve_ms=second["solve_ms"], dir_one_shard_solve_ms=one_full["solve_ms"],
               dir_no_mesh_solve_ms=plain_full["solve_ms"])
    emit("mesh_directory", **card, n=DIR_OBJ, m=DIR_NODES, killed=DIR_KILL, mesh=mesh.shape, **directory)
    torch.cuda.empty_cache()

    # -- mesh_at_scale: a routed flat rebalance over the mesh at 10,485,760 -------
    p = TorchObjectPlacement(mode="sinkhorn", eps=EPS, n_iters=N_ITERS, node_axis_size=DIR_NODES, mesh=mesh)
    p.sync_members(members(()))
    ids = [ObjectId("MeshScale", str(i)) for i in range(HIER_OBJ)]
    _, assign_ms, launches, peak = await provider_step(lambda: p.assign_batch(ids), "assign_batch")
    del ids
    before = seat_array_of(p)
    p.sync_members(members(set(dead)))
    _, ms, step_launches, step_peak = await provider_step(lambda: p.rebalance(delta=False),
                                                          "the routed mesh rebalance")
    mode = "sinkhorn+hier_at_scale+mesh_chunk"
    check(p.stats.mode == mode, f"routed mesh rebalance ran {p.stats.mode}")
    check(p.stats.devices == MESH_SHARDS and p.stats.chunks == MESH_CHUNKS,
          f"routed mesh rebalance: {p.stats.chunks} chunks on {p.stats.devices} shards")
    after = seat_array_of(p)
    spread = live_spread(np.bincount(after, minlength=DIR_NODES), set(dead), HIER_OBJ, "routed mesh rebalance")
    undisplaced = int(((before != after) & ~np.isin(before, [p._nodes[addrs[i]].index for i in dead])).sum())
    out.update(scale_assign_ms=assign_ms, scale_kill_ms=ms, scale_kill_solve_ms=p.stats.solve_ms,
               scale_kill_apply_ms=p.stats.apply_ms)
    emit("mesh_at_scale", **card, n=HIER_OBJ, m=DIR_NODES, killed=HIER_DEAD, mesh=mesh.shape,
         assign={"wall_ms": assign_ms, "peak_bytes": peak, "launches": launches},
         wall_ms=ms, **hier_stats_fields(p), live_loads=spread, undisplaced_moves=undisplaced,
         peak_bytes=step_peak, launches=step_launches)
    del p, before, after
    torch.cuda.empty_cache()

    # -- mesh_nccl: the collectives through a process group of one -------------
    nccl = dist.is_nccl_available()
    backend = "nccl" if nccl else "gloo"
    gen = torch.Generator(device=dev).manual_seed(13)
    obj = torch.randn((MESH_NCCL_ROWS, tp._FEAT_DIM), generator=gen, device=dev)
    node = torch.randn((tp._FEAT_DIM, DIR_NODES), generator=gen, device=dev) * 0.2
    alive = torch.ones(DIR_NODES, device=dev)
    alive[dead] = 0.0
    cap = torch.ones(DIR_NODES, device=dev)
    kw = dict(n_groups=DIR_NODES // 8, eps=EPS, coarse_iters=N_ITERS, fine_iters=N_ITERS)
    plain, plain_ms, launches, _ = measured(
        lambda: sharded_hierarchical_assign(mesh, obj, node, cap, alive, **kw), "the sharded solve")
    count(launches)
    up = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)
    try:
        check(not up and dist.get_backend() == backend, f"the group runs {dist.get_backend()}")
        gmesh = make_mesh([dev] * MESH_SHARDS)
        check(gmesh.distributed and gmesh.devices.shape == mesh.devices.shape, f"group mesh {gmesh}")
        grouped, ms, launches, peak = measured(
            lambda: sharded_hierarchical_assign(gmesh, obj, node, cap, alive, **kw), "the grouped solve")
    finally:
        dist.destroy_process_group()
    equal = (torch.equal(grouped.assignment, plain.assignment) and int(grouped.overflow) == int(plain.overflow)
             and torch.equal(grouped.coarse_g, plain.coarse_g))
    check(equal, "the solve with a process group up differs from the solve without one")
    out.update(nccl_grouped_ms=ms, nccl_plain_ms=plain_ms)
    emit("mesh_nccl", **card, nccl_available=nccl, backend=backend, world_size=1, rows=MESH_NCCL_ROWS,
         m=DIR_NODES, mesh=mesh.shape, wall_ms=ms, plain_ms=plain_ms, equal=equal,
         overflow=int(grouped.overflow), peak_bytes=peak, launches=count(launches))
    del obj, node, plain, grouped

    # -- mesh_dryrun: entry.dryrun_multichip over 8 shards of the card ----------
    result, ms, launches, peak = measured(lambda: entry.dryrun_multichip(MESH_SHARDS, device=dev), "the dryrun")
    ratio = result["phase2"]["cost_ratio"]
    check(ratio <= 1.12, f"phase-2 transport-cost ratio {ratio}")
    out.update(dryrun_ms=ms)
    emit("mesh_dryrun", **card, wall_ms=ms, cost_ratio=ratio, **result, peak_bytes=peak,
         launches=count(launches))
    return out, launches_total


def live_phases(dev, card: dict) -> dict:
    """The ``live`` group (phase 17): the port's own runtime on the card's directory.

    Returns ``{"route_hops": ...}`` for the bench group's headline.
    """
    from rio_tpu_torch import bench as B
    from rio_tpu_torch.examples.tpu_placement import N_OBJECTS as DEMO_OBJ
    from rio_tpu_torch.examples.tpu_placement import run_demo
    from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
    from rio_tpu_torch.utils.churn_live import measure_daemon_churn

    # -- live_row2 ---------------------------------------------------------------
    _reset_launches()
    row2 = B.row2_torch_provider_live(
        dev, n_servers=LIVE_SERVERS, n_objects=LIVE_OBJ, sample_size=LIVE_SAMPLE
    )
    launches = _read_launches("live_row2")
    hops = B.live_route_hops()  # bench.py's 8 x 2,048 on LocalObjectPlacement
    ours, ref = row2["ours"], row2["reference"]
    check(row2["directory_device"].startswith("cuda"), f"row 2 directory on {row2['directory_device']}")
    check(row2["count"] == LIVE_OBJ, f"row 2 directory holds {row2['count']} rows")
    check(ours["n"] == ref["n"] == LIVE_SAMPLE, f"row 2 sampled {ours['n']}, {ref['n']}")
    check(ours["mean"] == 1.0 and ours["p99"] == 1.0, f"row 2 directory hops {ours}")
    check(ref["p99"] == 2.0 and ref["mean"] > 1.5, f"row 2 random-policy hops {ref}")
    check(hops["ours"]["p99"] == 1.0 and hops["reference"]["p99"] == 2.0, f"route hops {hops}")
    emit("live_row2", **card, row2_torch_provider=row2, route_hops=hops, launches=launches)

    # -- live_churn --------------------------------------------------------------
    placement = TorchObjectPlacement(move_cost=DIR_MOVE_COST, device=dev)
    check(placement.device.type == "cuda", f"churn directory on {placement.device}")
    check(placement._solver_mode() == "sinkhorn", f"auto resolves to {placement._solver_mode()}")
    _reset_launches()
    churn = asyncio.run(measure_daemon_churn(
        placement, n_servers=LIVE_SERVERS, n_echo=CHURN_OBJ, n_counters=LIVE_COUNTERS,
        sample_size=LIVE_SAMPLE,
    ))
    launches = _read_launches("live_churn")
    n = CHURN_OBJ + LIVE_COUNTERS
    st = churn["stats"]
    check(churn["n_objects"] == n and placement.count() == n, f"churn directory holds {placement.count()}")
    check(churn["dead_rows"] == 0, f"{churn['dead_rows']} rows left on the dead node")
    check(churn["displaced"] <= churn["moved"] <= churn["displaced"] + n // 4,
          f"moved {churn['moved']}, displaced {churn['displaced']}")
    check(churn["planned_moves"] <= churn["displaced"] + n // 4,
          f"the daemons planned {churn['planned_moves']} moves, displaced {churn['displaced']}")
    check(st["mode"].startswith("sinkhorn") and not st["discarded"], f"churn solve {st}")
    check(churn["counters"] == LIVE_COUNTERS and churn["lost"] == [], f"counters lost: {churn['lost']}")
    check(churn["hops"]["mean"] == 1.0 and churn["hops"]["n"] == LIVE_SAMPLE, f"hops after churn {churn['hops']}")
    emit("live_churn", **card, directory_device=str(placement.device), **churn, launches=launches)

    # -- live_demo ---------------------------------------------------------------
    _reset_launches()
    demo = asyncio.run(run_demo(dev, verbose=False))
    launches = _read_launches("live_demo")
    check(demo["device"].startswith("cuda"), f"demo directory on {demo['device']}")
    check(demo["mode"].startswith("hierarchical") and not demo["discarded"] and demo["n_objects"],
          f"demo re-solve {demo}")
    check(demo["observed"] == DEMO_OBJ, f"the tracker observed {demo['observed']} objects")
    check(demo["reachable"] == DEMO_OBJ and demo["redirects"] == 0, f"demo {demo}")
    emit("live_demo", **card, **demo, launches=launches)
    return {"route_hops": hops}


def durable_phases(dev, card: dict) -> None:
    """The ``durable`` group (phase 18): BASELINE row 2 persists to SQLite and restarts."""
    import shutil
    import tempfile

    from rio_tpu_torch.utils import durable_live as D

    rt = D.port_runtime(dev)
    data_dir = tempfile.mkdtemp(prefix="rio_durable_")
    try:
        # -- durable_row2 ------------------------------------------------------------
        _reset_launches()
        first = asyncio.run(D.first_life(
            rt, data_dir, n_servers=LIVE_SERVERS, n_objects=DUR_OBJ, n_counters=LIVE_COUNTERS
        ))
        launches = _read_launches("durable_row2")
        n = DUR_OBJ + LIVE_COUNTERS
        check(first["n_servers"] == LIVE_SERVERS, f"{first['n_servers']} servers")
        check(first["directory_device"].startswith("cuda"), f"directory on {first['directory_device']}")
        check(first["directory_rows"] == first["file_rows"] == n,
              f"directory {first['directory_rows']} rows, file {first['file_rows']}, want {n}")
        check(first["rows_equal"], "the file's rows differ from the directory")
        check(sorted(set(first["acked"].values())) == [1], "a counter's Add was not acknowledged at 1")
        check(first["exited_cleanly"], "a server did not exit")
        emit("durable_row2", **card, reduced=DUR_REDUCED,
             **{k: v for k, v in first.items() if k not in ("acked", "addresses", "pre_exit_flush_rows",
                                                        "closing_flush_rows", "exit_s", "exited_cleanly")},
             launches=launches)

        # -- durable_restart ---------------------------------------------------------
        _reset_launches()
        second = asyncio.run(D.second_life(
            rt, data_dir, first, n_servers=LIVE_SERVERS, n_new=DUR_NEW, sample_size=LIVE_SAMPLE
        ))
        launches = _read_launches("durable_restart")
        flushed = first["file_rows"]
        check(second["restored"] == flushed, f"restored {second['restored']} of {flushed} rows")
        check(second["restored_on_ghosts"] == flushed and second["restored_on_live"] == 0,
              f"restored rows on ghosts {second['restored_on_ghosts']}, on live {second['restored_on_live']}")
        check(second["new_on_ghosts"] == 0 and second["new_on_live"] == DUR_NEW,
              f"new ids on ghosts {second['new_on_ghosts']}, on live {second['new_on_live']}")
        check(second["answered"] == second["hops"]["n"] == LIVE_SAMPLE,
              f"{second['answered']} of {LIVE_SAMPLE} sampled ids answered")
        check(second["counters"] == LIVE_COUNTERS and second["lost"] == [], f"counters lost: {second['lost']}")
        check(second["exited_cleanly"], "a server of the second life did not exit")
        stop = {k: first[k] for k in ("pre_exit_flush_rows", "closing_flush_rows", "exit_s", "exited_cleanly")}
        emit("durable_restart", **card, reduced=DUR_REDUCED, first_stop=stop, flushed=flushed,
             **second, launches=launches)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def affinity_live_phases(dev, card: dict) -> None:
    """The ``affinity_live`` group (phase 19): the affinity feedback loop on the card's provider."""
    from rio_tpu_torch import bench as B
    from rio_tpu_torch.examples.affinity import N_PAIRS
    from rio_tpu_torch.examples.affinity import main as affinity_demo

    # -- affinity_live -------------------------------------------------------------
    _reset_launches()
    out = B.affinity_payoff(dev)
    launches = _read_launches("affinity_live")
    spans = out["delivery_wire_spans"]
    check(out["host"]["platform"] == "cuda", f"the provider ran on {out['host']}")
    check(out["bytes_ratio"] >= AFF_LIVE_RATIO, f"bytes ratio {out['bytes_ratio']}")
    check(out["pairs_colocated"] == out["partitions"], f"{out['pairs_colocated']} of {out['partitions']} pairs")
    check(spans["affinity"] < spans["blind"], f"delivery wire spans {spans}")
    check("+affinity" in str(out["solved_as"]), f"solved as {out['solved_as']}")
    emit("affinity_live", **card, provider_device=str(dev), **out, launches=launches)

    # -- affinity_demo -------------------------------------------------------------
    _reset_launches()
    demo = asyncio.run(affinity_demo(dev))
    launches = _read_launches("affinity_demo")
    check(demo["pairs"] == N_PAIRS and demo["ratio"] >= AFF_LIVE_RATIO, f"demo {demo}")
    emit("affinity_demo", **card, provider_device=str(dev), **demo, launches=launches)


def _check_rates(values, what: str) -> int:
    """Every rate in ``values`` (a number, or a list or dict of them) > 0; how many."""
    flat = list(values.values()) if isinstance(values, dict) else \
        list(values) if isinstance(values, list) else [values]
    for r in flat:
        check(isinstance(r, (int, float)) and r > 0, f"{what}: rate {r}")
    return len(flat)


def _scale_chain_order(chain: list[str]) -> list[str]:
    """The first scale_out, scale_in and retired of the ramp's journal chain, in order."""
    firsts: list[str] = []
    for entry in chain:
        action = entry.split(":", 1)[0]
        if action in ("scale_out", "scale_in", "retired") and action not in firsts:
            firsts.append(action)
    return firsts


def runtime_phases(card: dict) -> None:
    """The ``runtime`` group (phase 22): the runtime's processes and host stages, no device."""
    import os

    from rio_tpu_torch import bench as B
    from rio_tpu_torch import native
    from rio_tpu_torch.utils.import_probe import probe

    root = os.path.dirname(os.path.abspath(__file__))
    _reset_launches()
    t0 = time.perf_counter()
    native_built = native.get() is not None  # once, before any worker process loads it
    native_s = time.perf_counter() - t0

    # -- runtime_import ------------------------------------------------------------
    modules = ["rio_tpu_torch.sharded", "rio_tpu_torch.autoscale.provision", "rio_tpu_torch.server"]
    imported = probe(modules, root)
    check(imported["loaded"] == [], f"importing the runtime loaded {imported['loaded']}")
    emit("runtime_import", **card, host=B._host_provenance(), **imported,
         native_built=native_built, native_build_s=native_s, launches=_read_launches("runtime_import"))

    # -- sharded_smoke -------------------------------------------------------------
    smokes = {}
    for name, flags in (("redirect", []), ("shard_aware", ["--shard-aware"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "rio_tpu_torch.utils.sharded_smoke", *flags],
                             cwd=root, capture_output=True, text=True, timeout=120)
        check(out.returncode == 0, f"sharded smoke {flags} exited {out.returncode}: {out.stderr[-2000:]}")
        line = next((ln for ln in out.stdout.splitlines() if ln.startswith("SMOKE OK ")), None)
        check(line is not None, f"sharded smoke {flags} printed no SMOKE OK")
        result = json.loads(line[len("SMOKE OK "):])
        check(result["ok"] and result["n"] == 16, f"sharded smoke {result}")
        check(len(result["spread"]) == 2 and sum(result["spread"].values()) == 16,
              f"the front door's requests were not served by both workers: {result['spread']}")
        if flags:
            check(result["redirects"] == 0 and result["shard_routes"] == 16, f"shard-aware smoke {result}")
        smokes[name] = {**result, "seconds": time.perf_counter() - t0}
    emit("sharded_smoke", **card, host=B._host_provenance(), **smokes,
         launches=_read_launches("sharded_smoke"))

    # -- rpc -------------------------------------------------------------------------
    n_workers = max(2, min(4, os.cpu_count() or 1))
    baseline = B.sqlite_baseline_rate()
    seconds = {}
    t0 = time.perf_counter()
    rpc = B.rpc_throughput(baseline)
    seconds["rpc_throughput"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    egress = B.rpc_egress(baseline, batches=RT_EGRESS_BATCHES)
    seconds["rpc_egress"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = B.rpc_sharded(baseline, **RT_SHARDED_BATCHES)
    seconds["rpc_sharded"] = time.perf_counter() - t0
    transports = ["asyncio"] + (["native"] if native_built else [])
    rates = sum(_check_rates(rpc[t], f"rpc_throughput {t}") for t in transports)
    for t in transports:
        rates += _check_rates(egress[t]["per_frame"] + egress[t]["coalesced"], f"rpc_egress {t}")
    one, decode, agg = sharded["one_worker"], sharded["batch_decode"], sharded["n_workers"]
    rates += _check_rates(one["plain_1proc"] + one["sharded_1worker"], "rpc_sharded one_worker")
    rates += _check_rates(decode["off"] + decode["on"], "rpc_sharded batch_decode")
    rates += _check_rates([agg["aggregate_rate"]] + [g["rate"] for g in agg["generators"]],
                          "rpc_sharded n_workers")
    check(("native" in rpc) == native_built, f"rpc_throughput transports {sorted(rpc)}")
    aware = sharded["shard_aware"]
    check(aware["redirects"]["shard_aware"] == 0, f"shard-aware clients paid redirects: {aware['redirects']}")
    check(aware["shard_routes"] > 0, "no shard-aware client dialled its shard directly")
    check(sharded["n_workers"]["n_workers"] == aware["n_workers"] == n_workers,
          f"sharded ran {sharded['n_workers']['n_workers']} workers, want {n_workers}")
    rates += _check_rates(aware["redirect_routed"] + aware["shard_aware"], "rpc_sharded shard_aware")
    if native_built:
        engine = sharded.get("engine", {"error": "missing"})
        check("error" not in engine, f"engine A/B {engine}")
        rates += _check_rates(engine["asyncio"] + engine["native"], "rpc_sharded engine")
    emit("rpc", **card, host=B._host_provenance(), reduced=RT_REDUCED, sqlite_baseline=baseline,
         rpc_msgs_per_sec=rpc, rpc_egress=egress, rpc_sharded=sharded, rates_checked=rates,
         seconds=seconds, launches=_read_launches("rpc"))

    # -- runtime_tiers -------------------------------------------------------------
    tiers, seconds = {}, {}
    cut = {"batches": RT_OVERHEAD_BATCHES}
    for flag, kwargs in (("migration", {}), ("hotkey", {}), ("tracing", cut), ("journal", cut),
                         ("series", cut), ("spans", cut), ("faults", cut), ("streams", {}),
                         ("qos", {"fast": True})):
        key, tier = B.RUNTIME_TIERS[flag]
        t0 = time.perf_counter()
        tiers[key] = tier(**kwargs)
        seconds[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "rio_tpu_torch.utils.ramp_trace", "--idle", json.dumps(cut),
                          "--ramp", json.dumps(RT_RAMP)], cwd=root, capture_output=True, text=True,
                         timeout=600)
    check(run.returncode == 0, f"the autoscale tier exited {run.returncode}: {run.stdout[-1000:]} "
                               f"{run.stderr[-2000:]}")
    child = json.loads(run.stdout.strip().splitlines()[-1])
    check(sum(child["launches"].values()) == 0, f"the autoscale tier launched a kernel: {child['launches']}")
    tiers["autoscale"] = child["result"]
    seconds["autoscale"] = time.perf_counter() - t0
    mig = tiers["migration_drain"]
    for mode in ("per_key", "batched"):
        check(mig[mode]["moved"] == mig["n_objects"], f"migration {mode} moved {mig[mode]['moved']}")
    for mode in ("baseline", "replica_reads"):
        check(tiers["hotkey"][mode]["staleness_violations"] == 0, f"hot-key {mode}: {tiers['hotkey'][mode]}")
    streams = tiers["streams"]["delivered"]
    check(streams["off"] == streams["on"] > 0, f"streams delivered {streams}")
    check(tiers["qos"]["flood"]["interactive_sheds_on"] == 0, f"qos flood {tiers['qos']['flood']}")
    check(tiers["faults"]["lookup_ops_per_sec"]["armed_idle"] > 0, f"faults {tiers['faults']}")
    ramp = tiers["autoscale"]["ramp"]
    check(ramp["lost"] == 0, f"the ramp lost acknowledged writes: {ramp}")
    check(_scale_chain_order(ramp["chain"]) == ["scale_out", "scale_in", "retired"],
          f"the ramp's journal chain {ramp['chain']}")
    _check_rates([mig[mode]["migrations_per_sec"] for mode in ("per_key", "batched")], "migration")
    for key in ("tracing", "journal", "series", "spans", "faults"):
        _check_rates(tiers[key]["msgs_per_sec"], key)
    _check_rates(tiers["faults"]["lookup_ops_per_sec"], "faults lookups")
    _check_rates(tiers["streams"]["publish_acks_per_sec"], "streams publish")
    _check_rates(tiers["streams"]["deliver_msgs_per_sec"], "streams deliver")
    _check_rates(tiers["qos"]["uniform"]["msgs_per_sec"], "qos uniform")
    _check_rates(tiers["autoscale"]["idle"]["msgs_per_sec"], "autoscale idle")
    emit("runtime_tiers", **card, host=B._host_provenance(), reduced=RT_REDUCED, **tiers, seconds=seconds,
         ramp_marks=child["marks"], launches=_read_launches("runtime_tiers"),
         autoscale_launches=child["launches"])


def examples_phases(dev, card: dict) -> None:
    """The ``examples`` group (phase 23): the last tier, examples and tool of the port."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from rio_tpu_torch import bench as B
    from rio_tpu_torch.examples import migration, multihost_solve

    # -- mesh_ab: bench.py's hier_mesh_ab at its sizes -----------------------------
    t0 = time.perf_counter()
    ab, ms, launches, peak = measured(lambda: B.hier_mesh_ab(device=dev), "hier_mesh_ab")
    for arm in ("mesh_chunk", "chunked_only"):
        check(ab[arm]["overflow"] == 0, f"hier_mesh_ab {arm} overflow {ab[arm]['overflow']}")
    ratio = ab["transport_cost"]["ratio"]
    check(abs(ratio - 1.0) <= AB_RATIO_SLACK, f"hier_mesh_ab transport-cost ratio {ratio}")
    check((ab["mesh_chunk"]["n_chunks"], ab["chunked_only"]["n_chunks"]) == (4, 4),
          f"hier_mesh_ab chunks {ab['mesh_chunk']['n_chunks']}, {ab['chunked_only']['n_chunks']}")
    emit("mesh_ab", **card, **ab, wall_ms=ms, peak_bytes=peak, launches=launches,
         seconds=time.perf_counter() - t0)

    # -- multihost_solve: 8 shards of the card under one NCCL process --------------
    t0 = time.perf_counter()
    argv = ["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1", "--process-id", "0",
            "--device", str(dev)]
    out = io.StringIO()
    backends = []
    init_group = dist.init_process_group

    def recorded_init(backend=None, *args, **kwargs):
        backends.append(backend)
        return init_group(backend, *args, **kwargs)

    dist.init_process_group = recorded_init  # multihost.initialize looks it up on the module
    try:
        with contextlib.redirect_stdout(out):
            solved, ms, launches, peak = measured(lambda: multihost_solve.main(argv), "multihost_solve")
    finally:
        dist.init_process_group = init_group
    check(backends == ["nccl" if dev.type == "cuda" else "gloo"], f"multihost_solve joined {backends}")
    n_live = solved["live_nodes"]
    fair = solved["n_obj"] / n_live
    check(solved["dead_node_load"] == 0 and solved["overflow"] == 0, f"multihost_solve {solved}")
    check((1 - HIER_LOAD_SLACK) * fair <= solved["load_min"] <= solved["load_max"]
          <= (1 + HIER_LOAD_SLACK) * fair, f"multihost_solve loads {solved}")
    check(solved["processes"] == 1 and solved["n_obj"] == 32_768, f"multihost_solve {solved}")
    emit("multihost_solve", **card, **solved, backend=backends[0], world_size=1,
         printed=out.getvalue().splitlines(), wall_ms=ms, peak_bytes=peak, launches=launches,
         seconds=time.perf_counter() - t0)

    # -- migration_demo: examples/migration.py with the provider on the card -------
    t0 = time.perf_counter()
    made = []
    provider = migration.TorchObjectPlacement

    class _Recorded(provider):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    migration.TorchObjectPlacement = _Recorded
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _, ms, launches, _ = measured(lambda: asyncio.run(migration.main(dev)), "the migration demo")
    finally:
        migration.TorchObjectPlacement = provider
    printed = out.getvalue().splitlines()
    pairs = [tuple(int(x) for x in m) for m in re.findall(r"total=(\d+) streak=(\d+)", out.getvalue())]
    check(len(made) == 1 and made[0].device.type == "cuda", "the migration demo's provider is not on the card")
    check(pairs == [(3, 3), (4, 4), (5, 5)], f"migration (total, streak) pairs {pairs}")
    emit("migration_demo", **card, pairs=pairs, directory_device=str(made[0].device),
         mode=made[0].stats.mode, printed=printed, wall_ms=ms, launches=launches,
         seconds=time.perf_counter() - t0)

    # -- endurance: tools/endurance.py, cut, with its provider on the card ---------
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rio_endurance_")
    try:
        root = os.path.dirname(os.path.abspath(__file__))
        flags = ["--minutes", str(END_MINUTES), "--churn-every", str(END_CHURN_S),
                 "--sample-every", str(END_SAMPLE_S), "--route-small", "--cordon",
                 "--device", str(dev), "--persistent", os.path.join(tmp, "endurance.db")]
        run = subprocess.run([sys.executable, "-c", _ENDURANCE_CHILD, *flags], cwd=root,
                             capture_output=True, text=True, timeout=END_MINUTES * 60 + 180)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(run.returncode == 0, f"endurance exited {run.returncode}: {run.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in run.stdout.splitlines() if ln.startswith("{")]
    summary = next(ln for ln in lines if "ok" in ln)
    child = next(ln for ln in lines if "launches" in ln)
    launches = child["launches"]
    samples = [ln for ln in lines if "t_min" in ln]
    check(sum(launches[k] for k in FLAT_KERNELS) == 0, f"endurance launched a flat kernel: {launches}")
    check(summary["ok"] and summary["errors"] == 0, f"endurance {summary}")
    check(summary["backing_convergence"] == "exact", f"endurance backing {summary['backing_convergence']}")
    check(summary["churn_cycles"] >= 1 and summary["requests"] > 0, f"endurance {summary}")
    check(summary["rss_warm_mb"] is not None and summary["rss_final_mb"] is not None,
          f"endurance RSS {summary['rss_warm_mb']}, {summary['rss_final_mb']}")
    emit("endurance", **card, host=B._host_provenance(), reduced=END_REDUCED, **summary,
         vm_rss_final_mb=child["vm_rss_mb"], samples=samples, flags=flags[:-1], launches=launches,
         seconds=time.perf_counter() - t0)


def run_tier(fn, what: str, kernel_ok: bool = False):
    """Run one bench tier with both kernel counts at 0: its result, the counts
    read just after and its peak device memory. Unless ``kernel_ok``, a tier
    that launched a kernel fails."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    result = fn()
    torch.cuda.synchronize()
    launches = _launches() if kernel_ok else _read_launches(what)
    return result, launches, torch.cuda.max_memory_allocated()


def bench_phases(dev, card: dict, live: dict | None = None) -> int:
    """The ``bench`` group (phase 20); returns the scaling kernel's launches in it.

    ``live`` holds the live group's ``route_hops`` for the headline."""
    import math

    import torch

    from rio_tpu_torch import bench as B
    from rio_tpu_torch.ops import scaling as S

    n = BENCH_OBJ
    detail: dict = {}

    # -- bench_solve -------------------------------------------------------------
    # The scaling kernel against its twin at the row-3 width before any timing.
    m3 = BENCH_ROW3_NODES
    cost3 = B.tier_inputs(n, m3)
    c3 = torch.from_numpy(cost3).to(dev)
    a, b, K, _ = S.scaling_kernel(
        c3, torch.ones(n, device=dev), torch.ones(m3, device=dev), eps=EPS,
        kernel_dtype=torch.bfloat16,
    )
    v = torch.ones(m3, device=dev)
    u_k, v_k = S.fused_scaling_iteration(K, a, b, v)
    torch.cuda.synchronize()
    u_p, v_p = S.fused_scaling_iteration_ref(K, a, b, v)
    eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
    max_abs = max(float((u_k - u_p).abs().max()), float((v_k - v_p).abs().max()))
    check(eu <= RTOL_KERNEL and ev <= RTOL_KERNEL, f"kernel at {n}x{m3}: {eu}, {ev}")
    kernel_ms = cuda_median_ms(lambda: S.fused_scaling_iteration(K, a, b, v), reps=20, batch=10)
    plain_ms = cuda_median_ms(lambda: S.fused_scaling_iteration_ref(K, a, b, v), reps=10, batch=3)
    # The library yardstick at this width too: torch.mv both ways in bfloat16.
    v16, u16 = v.to(torch.bfloat16), torch.full((n,), 1.0 / n, device=dev, dtype=torch.bfloat16)
    library_ms = cuda_median_ms(lambda: (torch.mv(K, v16), torch.mv(K.t(), u16)), reps=10, batch=10)
    bytes_ms = (n * m3 * 2 + 4 * (n + 2 * m3) + 4 * (n + m3)) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n * m3 / F32_FLOPS_PER_S * 1e3
    kernel_256 = {"n": n, "m": m3, "rtol": RTOL_KERNEL, "u_rel": eu, "v_rel": ev,
                  "max_abs_err": max_abs, "ms_per_iter": kernel_ms, "plain_ms_per_iter": plain_ms,
                  "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    del c3, a, b, K, u_k, v_k, u_p, v_p, v16, u16

    cost = B.tier_inputs(n, N_NODES)
    solve, launches, peak = run_tier(
        lambda: B.solve_rate(n, n_nodes=N_NODES, cost=cost, device=dev), "solve_rate", kernel_ok=True
    )
    # One K build a solve; the rounding kernel launches once a timed step.
    want = {"fused_scaling_iteration": N_ITERS * solve["solves"], "fused_iteration": 0,
            "kbuild": solve["solves"], "coarse_scores": 0, "potential_round": 0}
    check({k: launches[k] for k in want} == want and launches["cdf_round"] > 0,
          f"solve_rate launches {launches}, want {want} and the rounding kernel")
    kernel_launches = launches["fused_scaling_iteration"]
    check(solve["max_load"] == solve["fair_load"], f"solve_rate max load {solve['max_load']}")
    check(solve["mean_cost"] < 0.25, f"solve_rate mean cost {solve['mean_cost']}")
    row3, launches3, peak3 = run_tier(
        lambda: B.solve_rate(n, n_nodes=m3, n_iters=BENCH_ROW3_ITERS, cost=cost3, device=dev),
        "row 3", kernel_ok=True,
    )
    want3 = {"fused_scaling_iteration": BENCH_ROW3_ITERS * row3["solves"], "fused_iteration": 0,
             "kbuild": row3["solves"], "coarse_scores": 0, "potential_round": 0}
    check({k: launches3[k] for k in want3} == want3 and launches3["cdf_round"] > 0,
          f"row-3 launches {launches3}, want {want3} and the rounding kernel")
    kernel_launches += launches3["fused_scaling_iteration"]
    check(row3["max_load"] == row3["fair_load"], f"row-3 max load {row3['max_load']}")
    check(row3["mean_cost"] < RANDOM_MEAN_COST, f"row-3 mean cost {row3['mean_cost']}")
    del cost3
    detail["solve_tier"], detail["baseline_row3_1m_x_256"] = solve, row3
    emit("bench_solve", **card, kernel_256=kernel_256, solve_tier=solve, launches=launches,
         peak_bytes=peak, baseline_row3_1m_x_256=row3, row3_launches=launches3,
         row3_peak_bytes=peak3)

    # -- bench_greedy ------------------------------------------------------------
    greedy, launches, peak = run_tier(lambda: B.greedy_rate(n, N_NODES, cost=cost, device=dev), "greedy_rate")
    check(greedy["max_load"] - greedy["fair_load"] <= 2, f"greedy max load {greedy['max_load']}")
    del cost
    detail["greedy"] = greedy
    emit("bench_greedy", **card, greedy=greedy, launches=launches, peak_bytes=peak)

    # -- bench_collapsed ---------------------------------------------------------
    def churn_checks(r: dict, what: str) -> None:
        ceiling = math.ceil(r["n_obj"] / (N_NODES - r["dead_nodes"]))
        check(r["dead_load"] == 0, f"{what}: {r['dead_load']} objects on dead nodes")
        check(r["max_load"] == ceiling, f"{what}: max load {r['max_load']}, want {ceiling}")
        check(r["moved"] >= r["displaced"], f"{what}: moved {r['moved']} < displaced {r['displaced']}")

    collapsed, launches, peak = run_tier(lambda: B.collapsed_rate(n, N_NODES, device=dev), "collapsed_rate")
    churn_checks(collapsed, "collapsed_rate")
    warm, warm_launches, warm_peak = run_tier(
        lambda: B.warm_assign_rate(BENCH_WARM_BATCH, N_NODES, device=dev), "warm_assign_rate"
    )
    check(warm["max_load"] - warm["fair_load"] <= 1, f"warm batch max load {warm['max_load']}")
    incremental, inc_launches, inc_peak = run_tier(
        lambda: B.incremental_rate(n, BENCH_WARM_BATCH, N_NODES, device=dev), "incremental_rate"
    )
    churn_checks(incremental, "incremental_rate")
    detail.update(collapsed_tier=collapsed, warm_assign=warm, incremental=incremental)
    emit("bench_collapsed", **card, collapsed_tier=collapsed, launches=launches, peak_bytes=peak,
         warm_assign=warm, warm_launches=warm_launches, warm_peak_bytes=warm_peak,
         incremental=incremental, incremental_launches=inc_launches, incremental_peak_bytes=inc_peak)

    # -- bench_delta -------------------------------------------------------------
    delta, launches, peak = run_tier(
        lambda: B.delta_churn_rate(n, BENCH_DELTA_NODES, device=dev), "delta_churn_rate"
    )
    check(delta["undisplaced_moves"] == 0, f"delta moved {delta['undisplaced_moves']} undisplaced")
    check(delta["cost_ratio"] <= 1 + 1e-6, f"delta cost ratio {delta['cost_ratio']}")
    check(delta["delta_moved"] == delta["displaced"],
          f"delta moved {delta['delta_moved']}, displaced {delta['displaced']}")
    detail["delta_tier"] = delta
    emit("bench_delta", **card, delta_tier=delta, launches=launches, peak_bytes=peak)

    # -- bench_hier --------------------------------------------------------------
    hier, launches, peak = run_tier(
        lambda: B.hier_rate(BENCH_HIER_OBJ, N_NODES, BENCH_HIER_GROUPS,
                            chunk_rows=BENCH_HIER_CHUNK, device=dev),
        "hier_rate",
    )
    fair = hier["fair_load"]
    check(hier["overflow"] == 0, f"hier_rate overflow {hier['overflow']}")
    check(hier["n_chunks"] == BENCH_HIER_OBJ // BENCH_HIER_CHUNK, f"hier_rate chunks {hier['n_chunks']}")
    check(launches["coarse_scores"] > 0 and launches["coarse_scores"] % hier["n_chunks"] == 0,
          f"hier_rate made {launches['coarse_scores']} coarse-score launches, not one a chunk")
    check(launches["potential_round"] == 2 * launches["coarse_scores"],
          f"hier_rate made {launches['potential_round']} potential-rounding launches, not two a chunk")
    check((1 - HIER_LOAD_SLACK) * fair <= hier["min_load"] and hier["max_load"] <= (1 + HIER_LOAD_SLACK) * fair,
          f"hier_rate loads {hier['min_load']}..{hier['max_load']}, fair {fair}")
    detail["baseline_row5_hier"] = hier
    emit("bench_hier", **card, baseline_row5_hier=hier, launches=launches, peak_bytes=peak)

    detail.update(live or {})
    emit("bench_headline", **card, **B.headline(detail, B.sqlite_baseline_rate()))
    return kernel_launches


def window_report(window) -> dict:
    """A finished ``rio_bench.trace.Tracer``'s idle share, five top device
    operations and three longest idle gaps, in milliseconds."""
    from rio_bench.trace import idle_report

    r = idle_report(window.device, window.host, window.window, top=5, gaps=3)
    return {
        "window_ms": r["window_us"] / 1e3,
        "busy_ms": r["busy_us"] / 1e3,
        "idle_share": 1.0 - r["busy_us"] / r["window_us"],
        "top_ops": [{"name": n, "ms": us / 1e3} for n, us in r["top_ops"]],
        "gaps": [{"host": n, "ms": us / 1e3} for n, us in r["gaps"]],
    }


def launch_count(window, fragment: str) -> int:
    """Device spans of a finished ``Tracer`` whose name holds ``fragment``
    (a kernel's launches; names in the trace are demangled)."""
    return sum(fragment in s.name for s in window.device)


async def profile_phase(dev, card: dict) -> None:
    """The ``profile`` phase (21): the device's idle share on five paths."""
    import numpy as np
    import torch

    from rio_bench.trace import Tracer
    from rio_tpu_torch import bench as B
    from rio_tpu_torch.entry import logdomain_placement_step, make_problem, placement_step
    from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
    from rio_tpu_torch.parallel.hierarchical import hierarchical_assign
    from rio_tpu_torch.registry import ObjectId

    paths: dict = {}

    def profiled(name: str, fn) -> Tracer:
        """A warm call, one timed without the profiler (its cost shows beside
        the window), then the profiled window."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3
        window = Tracer()
        window.start()
        fn()
        window.stop()
        paths[name] = {**window_report(window), "unprofiled_ms": unprofiled_ms}
        return window

    cost, mass, cap = make_problem(N_OBJ, N_NODES, seed=0, device=dev)

    def main_steps():
        for _ in range(PROFILE_MAIN_STEPS):
            placement_step(cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev)

    w = profiled("main_path", main_steps)
    launches = launch_count(w, "scaling_rows_kernel")
    check(launches == N_ITERS * PROFILE_MAIN_STEPS,
          f"the main-path trace holds {launches} scaling_rows_kernel spans, "
          f"want {N_ITERS * PROFILE_MAIN_STEPS}")
    paths["main_path"].update(steps=PROFILE_MAIN_STEPS, scaling_rows_kernel=launches)

    w = profiled("logdomain_path", lambda: logdomain_placement_step(
        cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev))
    launches = launch_count(w, "logdomain_rows_kernel")
    check(launches == N_ITERS, f"the log-domain trace holds {launches} logdomain_rows_kernel spans")
    paths["logdomain_path"].update(steps=1, logdomain_rows_kernel=launches)
    del cost, mass, cap
    torch.cuda.empty_cache()

    cur = torch.from_numpy(
        np.random.default_rng(2).integers(0, N_NODES, DIR_OBJ, dtype=np.int32)).to(dev)
    ones = torch.ones(N_NODES, device=dev)
    alive = ones.clone()
    alive[:DIR_KILL] = 0.0
    profiled("collapsed", lambda: B.collapsed_decide(cur, ones, alive))
    del cur

    obj, node, hcap, halive, kw, n_chunks = hier_assign_inputs(dev, hier_dead())
    rows = obj.shape[0] // n_chunks
    profiled("hier_chunk", lambda: hierarchical_assign(obj[:rows], node, hcap / n_chunks, halive, **kw))
    paths["hier_chunk"].update(rows=rows, n_groups=kw["n_groups"])
    del obj, node
    torch.cuda.empty_cache()

    addrs = [f"10.{i // 256}.{i % 256}.1:5000" for i in range(DIR_NODES)]
    killed = set(int(i) for i in np.random.default_rng(0).choice(DIR_NODES, DIR_KILL, replace=False))
    p = TorchObjectPlacement(eps=EPS, n_iters=N_ITERS, mode="sinkhorn", move_cost=DIR_MOVE_COST,
                             node_axis_size=DIR_NODES, device=dev)
    p.sync_members([_Member(a, True) for a in addrs])
    await p.assign_batch([ObjectId("Prof", str(i)) for i in range(DIR_OBJ)])
    await p.rebalance(delta=False)  # the first solve: the next one starts warm
    p.sync_members([_Member(a, i not in killed) for i, a in enumerate(addrs)])
    w = Tracer()
    w.start()
    moved = await p.rebalance(delta=False)
    w.stop()
    check(p.stats.mode == "sinkhorn+collapsed", f"profiled rebalance ran {p.stats.mode}")
    paths["directory_full"] = {**window_report(w), "mode": p.stats.mode, "moved": moved,
                               "solve_ms": p.stats.solve_ms, "apply_ms": p.stats.apply_ms}
    emit("profile", **card, paths=paths)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from rio_tpu_torch.entry import (
        logdomain_placement_step,
        make_problem,
        placement_step,
        repair_to_quota,
        round_and_repair,
    )
    from rio_tpu_torch import tracing
    from rio_tpu_torch.kernels import build
    from rio_tpu_torch.ops import cdf_round as CR
    from rio_tpu_torch.ops import kbuild as KB
    from rio_tpu_torch.ops import logdomain_post as LP
    from rio_tpu_torch.ops import scaling as S
    from rio_tpu_torch.ops.pallas_sinkhorn import fused_iteration, fused_iteration_ref, pallas_sinkhorn
    from rio_tpu_torch.ops.sinkhorn import (
        block_quantiles,
        exact_quota_repair,
        log_marginals,
        marginal_err,
        normalize_marginals,
        sinkhorn,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = {"card": smi, "kind": torch.cuda.get_device_name(0)}
    emit("device", **card, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count(), sm_max_mhz=sm_mhz, sms=sms)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    ptxas = []  # "<kernel>: <registers line>", and any line that reports a spill
    for log in logs.values():
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
                ptxas.append(f"{kernel}: {line.strip()}")
    emit("build", seconds=build_s, sources=list(build.SOURCES), ptxas=ptxas)

    # -- 3. ragged shapes: kernel vs plain twin -----------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    ragged = []
    for n, m, kdt, offset in [
        (1000, 130, torch.float32, 0),   # one element per lane (130*4 bytes not 16-aligned)
        (1000, 130, torch.bfloat16, 0),
        (777, 1024, torch.bfloat16, 0),  # 16-byte loads, one column tile
        (300, 96, torch.float32, 0),
        (513, 2600, torch.bfloat16, 0),  # three column tiles
        (257, 1024, torch.bfloat16, 3),  # K base not 16-byte aligned
        (5, 40, torch.float32, 0),       # fewer rows than one CTA's warps
    ]:
        K = torch.empty(n * m + offset, dtype=kdt, device=dev)[offset:].view(n, m)
        K.copy_(torch.rand((n, m), generator=gen, device=dev) * 0.99 + 0.01)
        a = torch.rand(n, generator=gen, device=dev)
        a[::7] = 0.0
        a /= a.sum()
        b = torch.full((m,), 1.0 / m, device=dev)
        b[::11] = 0.0
        v = torch.rand(m, generator=gen, device=dev) + 0.5
        u_k, v_k = S.fused_scaling_iteration(K, a, b, v)
        torch.cuda.synchronize()
        u_p, v_p = S.fused_scaling_iteration_ref(K, a, b, v)
        eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
        check(eu <= RTOL_KERNEL and ev <= RTOL_KERNEL, f"ragged {n}x{m} {kdt}: {eu}, {ev}")
        ragged.append({"n": n, "m": m, "dtype": str(kdt), "offset": offset,
                       "u_rel": eu, "v_rel": ev})
    emit("ragged", rtol=RTOL_KERNEL, cases=ragged)

    # -- 4. full width: kernel vs plain twin --------------------------------
    cost, mass, cap = make_problem(N_OBJ, N_NODES, seed=0, device=dev)
    a, b = normalize_marginals(mass, cap)
    # The K-build kernel against its twin (the eager K build, run on the card).
    kbuild_kernel = {}
    for kdt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        launches_before = _launches()["kbuild"]
        K, shift = KB.kbuild(cost, eps=EPS, kernel_dtype=kdt)
        torch.cuda.synchronize()
        kb_launches = _launches()["kbuild"] - launches_before
        K_p, shift_p = KB.kbuild_ref(cost, eps=EPS, kernel_dtype=kdt)
        bits = torch.int32 if kdt == torch.float32 else torch.int16
        ulps = (K.view(bits).int() - K_p.view(bits).int()).abs()  # K > 0: ulps apart
        differ, max_ulps = int((ulps > 0).sum()), int(ulps.max())
        shift_differ = int((shift != shift_p).sum())
        del K_p, shift_p, ulps
        check(kb_launches == 1, f"the K-build kernel launched {kb_launches} times")
        check(shift_differ == 0 and max_ulps <= KBUILD_MAX_ULPS[name],
              f"K-build kernel {name}: {differ} elements differ, by up to {max_ulps} ulps; "
              f"{shift_differ} shifts differ")
        kb_ms = cuda_median_ms(lambda: KB.kbuild(cost, eps=EPS, kernel_dtype=kdt), reps=20, batch=10)
        kb_plain_ms = cuda_median_ms(lambda: KB.kbuild_ref(cost, eps=EPS, kernel_dtype=kdt), reps=5)
        # The float32 cost read once, K written once, the float32 shift written once.
        kb_bound_ms = N_OBJ * N_NODES * (4 + K.element_size()) + 4 * N_OBJ
        kb_bound_ms = kb_bound_ms / HBM_BYTES_PER_S * 1e3
        kbuild_kernel[name] = {"ms": kb_ms, "bound_ms": kb_bound_ms, "bound_share": kb_bound_ms / kb_ms,
                               "plain_ms": kb_plain_ms, "launches": kb_launches,
                               "elements_differ": differ, "max_ulps": max_ulps,
                               "shifts_differ": shift_differ}
    v = torch.ones(N_NODES, device=dev)
    u_k, v_k = S.fused_scaling_iteration(K, a, b, v)
    torch.cuda.synchronize()
    u_p, v_p = S.fused_scaling_iteration_ref(K, a, b, v)
    eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
    max_abs = max(float((u_k - u_p).abs().max()), float((v_k - v_p).abs().max()))
    check(eu <= RTOL_KERNEL and ev <= RTOL_KERNEL, f"full width: {eu}, {ev}")

    # The CDF-rounding kernel on that iteration's state, against its twin.
    q = block_quantiles(u_k > 0, CHUNK)
    launches_before = _launches()["cdf_round"]
    idx_k, res_k = CR.cdf_round(K, u_k, v_k, a, q)
    torch.cuda.synchronize()
    round_launches = _launches()["cdf_round"] - launches_before
    idx_p, res_p = CR.cdf_round_ref(K, u_k, v_k, a, q)
    round_agree = float((idx_k == idx_p).float().mean())
    res_rel = abs(float(res_k.sum()) - float(res_p.sum())) / float(res_p.sum())
    check(round_launches == 1, f"the rounding kernel launched {round_launches} times")
    check(round_agree >= ROUND_ROW_AGREEMENT and res_rel <= RTOL_ROUND_RES,
          f"rounding kernel: rows {round_agree}, residual {res_rel}")
    round_ms = cuda_median_ms(lambda: CR.cdf_round(K, u_k, v_k, a, q), reps=20, batch=10)
    round_plain_ms = cuda_median_ms(lambda: CR.cdf_round_ref(K, u_k, v_k, a, q), reps=5)
    # K once; u, a, q, v and vk read and idx and res written, 4 bytes each.
    round_bound_ms = (N_OBJ * N_NODES * 2 + 4 * (4 * N_OBJ + 2 * N_NODES) + 4 * N_OBJ) / HBM_BYTES_PER_S * 1e3
    emit("full_width", n=N_OBJ, m=N_NODES, rtol=RTOL_KERNEL, u_rel=eu, v_rel=ev, max_abs_err=max_abs,
         kbuild_kernel=kbuild_kernel,
         round_kernel={"ms": round_ms, "bound_ms": round_bound_ms, "bound_share": round_bound_ms / round_ms,
                       "plain_ms": round_plain_ms, "launches": round_launches,
                       "row_agreement": round_agree, "res_sum_rel": res_rel})
    del K, u_k, v_k, u_p, v_p, idx_k, res_k, idx_p, res_p

    # -- 5. the main path ---------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    impl = {"scaling.k_build": [], "placement.round": []}  # each span's ``impl``: "kernel", not "eager"
    tracing.add_sink(lambda sp: sp.name in impl and impl[sp.name].append(sp.attrs["impl"]))
    t0 = time.perf_counter()
    try:
        assignment, mean_cost, err = placement_step(
            cost, mass, cap, eps=EPS, n_iters=N_ITERS, kernel_dtype=torch.bfloat16,
            chunk=CHUNK, device=dev,
        )
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        tracing.clear_sinks()
    counts = _launches()
    launches = counts["fused_scaling_iteration"]
    round_launches = counts["cdf_round"]
    kbuild_launches = counts["kbuild"]
    peak = torch.cuda.max_memory_allocated()
    check(counts["coarse_scores"] == 0, "the main path launched the coarse-score kernel")
    check(counts["potential_round"] == 0, "the main path launched the potential-rounding kernel")
    check(launches == N_ITERS, f"kernel launched {launches} times, want {N_ITERS}")
    check(round_launches == 1 and impl["placement.round"] == ["kernel"],
          f"the rounding kernel launched {round_launches} times (want 1), rounding spans {impl}")
    check(kbuild_launches == 1 and impl["scaling.k_build"] == ["kernel"],
          f"the K-build kernel launched {kbuild_launches} times (want 1), K-build spans {impl}")
    check(assignment.shape == (N_OBJ,), "assignment shape")
    check(int(assignment.min()) >= 0 and int(assignment.max()) < N_NODES, "index range")
    loads = torch.bincount(assignment.long(), minlength=N_NODES)
    quota = N_OBJ // N_NODES
    check(bool((loads == quota).all()), f"node loads {int(loads.min())}..{int(loads.max())}")
    mean_cost, err = float(mean_cost), float(err)
    check(mean_cost < 0.25, f"mean assigned cost {mean_cost} (random placement: 0.50)")
    check(err == err and err < 1e-2, f"row-marginal error {err}")
    emit("main_path", n=N_OBJ, m=N_NODES, chunk=CHUNK, n_iters=N_ITERS, launches=launches,
         round_launches=round_launches, round_impl=impl["placement.round"],
         kbuild_launches=kbuild_launches, k_build_impl=impl["scaling.k_build"],
         potential_round_launches=counts["potential_round"], quota=quota,
         mean_cost=mean_cost, row_marginal_err=err, first_step_s=step_s, peak_bytes=peak)
    del assignment, loads

    # -- 6. whole step: kernel path vs plain path ---------------------------
    pc, pm, pcap = make_problem(PLAIN_N_OBJ, N_NODES, seed=1, device=dev)
    u_k, v_k, K, _ = S.fused_scaling_core(pc, pm, pcap, eps=EPS, n_iters=N_ITERS)
    pa, pb = normalize_marginals(pm, pcap)
    u_p, v_p = torch.zeros_like(pa), torch.ones_like(pb)
    for _ in range(N_ITERS):
        u_p, v_p = S.fused_scaling_iteration_ref(K, pa, pb, v_p)
    eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
    check(eu <= RTOL_STEP and ev <= RTOL_STEP, f"30 iterations: {eu}, {ev}")
    asg_k, cost_k, _ = round_and_repair(pc, pm, pcap, u_k, v_k, K, chunk=CHUNK)
    asg_p, cost_p, _ = round_and_repair(pc, pm, pcap, u_p, v_p, K, chunk=CHUNK)
    pquota = PLAIN_N_OBJ // N_NODES
    for asg in (asg_k, asg_p):
        check(bool((torch.bincount(asg.long(), minlength=N_NODES) == pquota).all()), "quota")
    agree = float((asg_k == asg_p).float().mean())
    check(agree >= 0.99, f"row agreement {agree}")
    emit("step_vs_plain", n=PLAIN_N_OBJ, m=N_NODES, rtol=RTOL_STEP, u_rel=eu, v_rel=ev,
         row_agreement=agree, mean_cost_kernel=float(cost_k), mean_cost_plain=float(cost_p))
    del pc, pm, pcap, K, asg_k, asg_p

    # -- 7. log-domain kernel on ragged shapes: kernel vs plain twin ---------
    neg_inf = float("-inf")
    ragged = []
    for n, m, offset, case in [
        (1000, 130, 0, "scalar loads"),          # 130*4 bytes is not a multiple of 16
        (300, 96, 0, "one 16-byte load a lane"),
        (5, 40, 0, "fewer rows than one CTA's warps"),
        (777, 1024, 0, "one full column tile"),
        (513, 2600, 0, "three column tiles"),
        (257, 1024, 3, "cost base not 16-byte aligned"),
        (200, 1100, 1, "misaligned, two column tiles"),
        (100, 96, 0, "every column dead"),
        (24, 128, 0, "a whole CTA's rows at zero mass"),  # 3 CTAs of 8 rows: CTA 1 is dead
    ]:
        c_r = torch.empty(n * m + offset, device=dev)[offset:].view(n, m)
        c_r.copy_(torch.rand((n, m), generator=gen, device=dev))
        mass_r = torch.rand(n, generator=gen, device=dev) + 0.1
        mass_r[::7] = 0.0
        cap_r = torch.rand(m, generator=gen, device=dev) + 0.5
        cap_r[::11] = 0.0
        g_r = torch.randn(m, generator=gen, device=dev) * 0.05
        g_r[::22] = neg_inf  # dead columns of an earlier iteration
        if case == "every column dead":
            cap_r.zero_()
            g_r.fill_(neg_inf)
        if case == "a whole CTA's rows at zero mass":
            mass_r[8:16] = 0.0
        la_r, lb_r = log_marginals(*normalize_marginals(mass_r, cap_r))
        f_k, g_k = fused_iteration(c_r, la_r, lb_r, g_r, EPS)
        torch.cuda.synchronize()
        f_p, g_p = fused_iteration_ref(c_r, la_r, lb_r, g_r, EPS)
        ef = max_abs_close(f_k, f_p, TOL_LOGDOMAIN, f"logdomain {n}x{m} ({case}) f")
        eg = max_abs_close(g_k, g_p, TOL_LOGDOMAIN, f"logdomain {n}x{m} ({case}) g")
        if case == "every column dead":
            check(bool(torch.isfinite(f_k[mass_r > 0]).all()), "every column dead: f must be finite")
        ragged.append({"n": n, "m": m, "offset": offset, "case": case, "f_max_abs": ef,
                       "g_max_abs": eg})
    emit("logdomain_ragged", tol=TOL_LOGDOMAIN, cases=ragged)

    # -- 8. log-domain kernel at full width: kernel vs plain twin ------------
    log_a, log_b = log_marginals(*normalize_marginals(mass, cap))
    g_in = torch.randn(N_NODES, generator=gen, device=dev) * 0.05
    f_k, g_k = fused_iteration(cost, log_a, log_b, g_in, EPS)
    torch.cuda.synchronize()
    f_p, g_p = fused_iteration_ref(cost, log_a, log_b, g_in, EPS)
    ef = max_abs_close(f_k, f_p, TOL_LOGDOMAIN, "logdomain full width f")
    eg = max_abs_close(g_k, g_p, TOL_LOGDOMAIN, "logdomain full width g")
    ld_max_abs = max(ef, eg)
    emit("logdomain_full_width", n=N_OBJ, m=N_NODES, tol=TOL_LOGDOMAIN, f_max_abs=ef, g_max_abs=eg)
    del f_k, g_k, f_p, g_p

    # -- 9. the log-domain path ------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    ld_assignment, ld_mean_cost, ld_err = logdomain_placement_step(
        cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev,
    )
    torch.cuda.synchronize()
    ld_step_s = time.perf_counter() - t0
    counts = _launches()
    ld_launches = counts["fused_iteration"]
    ld_peak = torch.cuda.max_memory_allocated()
    check(ld_launches == N_ITERS, f"log-domain kernel launched {ld_launches} times, want {N_ITERS}")
    check(counts["fused_scaling_iteration"] == 0, "the log-domain path launched the scaling kernel")
    check(counts["cdf_round"] == 0, "the log-domain path launched the rounding kernel")
    check(counts["kbuild"] == 0, "the log-domain path launched the K-build kernel")
    check(counts["coarse_scores"] == 0, "the log-domain path launched the coarse-score kernel")
    check(counts["potential_round"] == 0, "the log-domain path launched the potential-rounding kernel")
    check(counts["logdomain_post"] == counts["logdomain_post_finalize"] == 1,
          f"the log-domain path launched the post-solve kernel {counts['logdomain_post']} times and its "
          f"finalize {counts['logdomain_post_finalize']}, want 1 and 1")
    check(ld_assignment.shape == (N_OBJ,), "log-domain assignment shape")
    loads = torch.bincount(ld_assignment.long(), minlength=N_NODES)
    check(loads.shape == (N_NODES,) and bool((loads == quota).all()),
          f"log-domain node loads {int(loads.min())}..{int(loads.max())}")
    ld_mean_cost, ld_err = float(ld_mean_cost), float(ld_err)
    check(ld_mean_cost < 0.25, f"log-domain mean assigned cost {ld_mean_cost} (random: 0.50)")
    check(ld_err == ld_err and ld_err < 1e-2, f"log-domain column-marginal error {ld_err}")
    # The same problem through the main path's scaling solve: tpu_pallas_check's
    # max_dg_vs_xla, printed and not bounded (bf16 K on the scaling side).
    ld_res = pallas_sinkhorn(cost, mass, cap, eps=EPS, n_iters=N_ITERS)
    sc_res = S.fused_scaling_sinkhorn(
        cost, mass, cap, eps=EPS, n_iters=N_ITERS, kernel_dtype=torch.bfloat16
    )
    live = torch.isfinite(ld_res.g) & torch.isfinite(sc_res.g)
    max_dg = float((ld_res.g[live] - sc_res.g[live]).abs().max())
    del sc_res
    # The post-solve kernel against its plain twin (the seats per 65,536-row block,
    # then marginal_err) on the step's own f and g, where the error is summation
    # noise, and on g moved by 0.4 eps, where each column misses its mass by O(1).
    _, b_ld = normalize_marginals(mass, cap)
    q_ld = block_quantiles(torch.isfinite(ld_res.f), CHUNK)
    g_moved = ld_res.g + 0.02 * torch.randn(N_NODES, generator=gen, device=dev)
    post_vs_twin = {}
    for case, g_case in (("converged", ld_res.g), ("moved_g", g_moved)):
        rows = LP.logdomain_post(cost, ld_res.f, g_case, q_ld, EPS)
        err_k = float(LP.logdomain_post_finalize(rows, cost, ld_res.f, g_case, b_ld, EPS))
        idx_t = LP.logdomain_post_round_ref(cost, ld_res.f, g_case, q_ld, EPS)
        err_t = float(marginal_err(cost, ld_res.f, g_case, b_ld, EPS))
        agree = float((rows.idx == idx_t).float().mean())
        check(agree >= ROUND_ROW_AGREEMENT, f"post-solve kernel ({case}): seats agree on {agree}")
        if case == "converged":  # the plan's mass is 1
            tol = post_err_tol(N_OBJ, rows.col_parts.shape[0], 8)
        else:
            check(err_t > 0.1, f"moved g: the twin's err {err_t} is no O(1) violation")
            tol = RTOL_POST_ERR * err_t
        check(abs(err_k - err_t) <= tol,
              f"post-solve kernel ({case}): err {err_k} against the twin's {err_t}, bound {tol}")
        post_vs_twin[case] = {"row_agreement": agree, "err": err_k, "err_twin": err_t, "err_tol": tol}
        del rows, idx_t
    emit("logdomain_path", n=N_OBJ, m=N_NODES, chunk=CHUNK, n_iters=N_ITERS, launches=ld_launches,
         quota=quota, mean_cost=ld_mean_cost, col_marginal_err=ld_err, first_step_s=ld_step_s,
         peak_bytes=ld_peak, max_dg_vs_scaling=max_dg, post_vs_twin=post_vs_twin)
    del ld_assignment, loads, g_moved, q_ld

    # -- 10. log-domain path: kernel vs plain twin vs unfused sinkhorn --------
    pc, pm, pcap = make_problem(PLAIN_N_OBJ, N_NODES, seed=1, device=dev)
    res_k = pallas_sinkhorn(pc, pm, pcap, eps=EPS, n_iters=N_ITERS)
    pla, plb = log_marginals(*normalize_marginals(pm, pcap))
    f_p, g_p = torch.zeros_like(pla), torch.zeros_like(plb)
    for _ in range(N_ITERS):
        f_p, g_p = fused_iteration_ref(pc, pla, plb, g_p, EPS)
    res_u = sinkhorn(pc, pm, pcap, eps=EPS, n_iters=N_ITERS)
    pquota = PLAIN_N_OBJ // N_NODES
    vs = {}
    pq = block_quantiles(torch.isfinite(res_k.f), CHUNK)  # every row real: the same for each side
    # The kernel path rounds with the post-solve kernel, the plain paths with its twin.
    asg_k, cost_k = repair_to_quota(LP.logdomain_post(pc, res_k.f, res_k.g, pq, EPS).idx, pc, pcap)
    for name, f_r, g_r in (("twin", f_p, g_p), ("unfused", res_u.f, res_u.g)):
        ef = max_abs_close(res_k.f, f_r, TOL_LOGDOMAIN_STEP, f"30 iterations vs {name}: f")
        eg = max_abs_close(res_k.g, g_r, TOL_LOGDOMAIN_STEP, f"30 iterations vs {name}: g")
        asg_r, cost_r = repair_to_quota(LP.logdomain_post_round_ref(pc, f_r, g_r, pq, EPS), pc, pcap)
        for asg in (asg_k, asg_r):
            check(bool((torch.bincount(asg.long(), minlength=N_NODES) == pquota).all()), "quota")
        agree = float((asg_k == asg_r).float().mean())
        check(agree >= 0.99, f"row agreement with {name} {agree}")
        vs[name] = {"f_max_abs": ef, "g_max_abs": eg, "row_agreement": agree,
                    "mean_cost": float(cost_r)}
    emit("logdomain_vs_plain", n=PLAIN_N_OBJ, m=N_NODES, tol=TOL_LOGDOMAIN_STEP,
         mean_cost_kernel=float(cost_k), **vs)
    del pc, pm, pcap, res_k, res_u, f_p, g_p, asg_k, asg_r, pq

    # -- 11. times at full width --------------------------------------------
    a, b = normalize_marginals(mass, cap)
    K, _ = KB.kbuild(cost, eps=EPS, kernel_dtype=torch.bfloat16)
    u = torch.full((N_OBJ,), 1.0 / N_OBJ, device=dev)
    v = torch.ones(N_NODES, device=dev)
    launches_before = _launches()["fused_scaling_iteration"]
    kernel_ms = cuda_median_ms(lambda: S.fused_scaling_iteration(K, a, b, v), reps=20, batch=10)
    plain_ms = cuda_median_ms(lambda: S.fused_scaling_iteration_ref(K, a, b, v), reps=10, batch=3)
    v16, u16 = v.to(torch.bfloat16), u.to(torch.bfloat16)
    library_ms = cuda_median_ms(
        lambda: (torch.mv(K, v16), torch.mv(K.t(), u16)), reps=10, batch=10
    )
    del K

    # The step's stages, each timed alone on a real solve's state.
    def solve(K, a, b):
        v = torch.ones(N_NODES, device=dev)
        for _ in range(N_ITERS):
            _, v = S.fused_scaling_iteration(K, a, b, v)

    def round_and_check(K, u, v):
        rounded, res = CR.cdf_round(K, u, v, a, block_quantiles(u > 0, CHUNK))
        return rounded, res.sum()

    u, v, K, _ = S.fused_scaling_core(cost, mass, cap, eps=EPS, n_iters=N_ITERS)
    rounded, _ = round_and_check(K, u, v)
    expected = cap / cap.sum() * N_OBJ
    stages_ms = {
        "build_K": cuda_median_ms(  # as fused_scaling_core: the marginals and the K-build kernel
            lambda: (normalize_marginals(mass, cap), KB.kbuild(cost, eps=EPS, kernel_dtype=torch.bfloat16)),
            reps=5,
        ),
        "solve_30_iters": cuda_median_ms(lambda: solve(K, a, b), reps=5),
        "round_and_check": cuda_median_ms(lambda: round_and_check(K, u, v), reps=5),
        "quota_repair": cuda_median_ms(lambda: exact_quota_repair(rounded, expected), reps=5),
    }
    del K, rounded
    step_ms = cuda_median_ms(
        lambda: placement_step(cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev),
        reps=10, warmup=1,
    )
    check(_launches()["fused_scaling_iteration"] > launches_before, "timed the kernel")
    n, m = N_OBJ, N_NODES
    bytes_moved = n * m * 2 + 4 * (n + 2 * m) + 4 * (n + m)  # K, a, b, v in; u, v' out
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n * m / F32_FLOPS_PER_S * 1e3  # two float32 multiply-adds per element of K
    bound_ms = max(bytes_ms, ops_ms)

    # The log-domain kernel, its twin and the two-sweep library form (what the
    # unfused sinkhorn runs; the port never calls it), on a converged g.
    f_ld, g_ld = ld_res.f, ld_res.g
    launches_before = _launches()["fused_iteration"]
    ld_kernel_ms = cuda_median_ms(
        lambda: fused_iteration(cost, log_a, log_b, g_ld, EPS), reps=20, batch=10
    )
    ld_plain_ms = cuda_median_ms(
        lambda: fused_iteration_ref(cost, log_a, log_b, g_ld, EPS), reps=5, batch=2
    )

    def two_sweeps():
        f = EPS * (log_a - torch.logsumexp((g_ld[None, :] - cost) / EPS, 1))
        return torch.logsumexp((f[:, None] - cost) / EPS, 0)

    ld_library_ms = cuda_median_ms(two_sweeps, reps=5, batch=2)

    def ld_solve():
        g = torch.zeros(N_NODES, device=dev)
        for _ in range(N_ITERS):
            _, g = fused_iteration(cost, log_a, log_b, g, EPS)

    ld_q = block_quantiles(torch.isfinite(f_ld), CHUNK)
    ld_rows = LP.logdomain_post(cost, f_ld, g_ld, ld_q, EPS)
    _, b_unit = normalize_marginals(mass, cap)
    ld_stages_ms = {
        "solve_30_iters": cuda_median_ms(ld_solve, reps=5),
        "round_and_col_sums": cuda_median_ms(
            lambda: LP.logdomain_post(cost, f_ld, g_ld, ld_q, EPS), reps=5
        ),
        "quota_repair": cuda_median_ms(lambda: exact_quota_repair(ld_rows.idx, expected), reps=5),
        "col_marginal_err": cuda_median_ms(
            lambda: LP.logdomain_post_finalize(ld_rows, cost, f_ld, g_ld, b_unit, EPS), reps=5
        ),
    }
    del ld_rows, ld_q
    ld_step_ms = cuda_median_ms(
        lambda: logdomain_placement_step(
            cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev
        ),
        reps=5, warmup=1,
    )
    check(_launches()["fused_iteration"] > launches_before, "timed the log-domain kernel")
    # Cost read once, log_a, log_b, g in; f, g' out. Two exponentials per element
    # at the SM's special-function rate and its highest clock.
    ld_bytes = 4 * n * m + 4 * (n + 2 * m) + 4 * (n + m)
    ld_bytes_ms = ld_bytes / HBM_BYTES_PER_S * 1e3
    ld_exp_ms = 2 * n * m / (EXP_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6) * 1e3
    ld_bound_ms = max(ld_bytes_ms, ld_exp_ms)

    emit("times", **card, kernel_ms_per_iter=kernel_ms, bound_ms=bound_ms,
         plain_ms_per_iter=plain_ms, library_ms=library_ms, step_ms=step_ms,
         solve_kernel_ms=kernel_ms * N_ITERS, stages_ms=stages_ms, peak_bytes=peak,
         bound_share=bound_ms / kernel_ms,
         logdomain={
             "kernel_ms_per_iter": ld_kernel_ms, "plain_ms_per_iter": ld_plain_ms,
             "library_ms": ld_library_ms, "bytes": ld_bytes, "bytes_ms": ld_bytes_ms,
             "exps": 2 * n * m, "exp_ms": ld_exp_ms, "sm_max_mhz": sm_mhz, "sms": sms,
             "bound_ms": ld_bound_ms, "bound_share": ld_bound_ms / ld_kernel_ms,
             "step_ms": ld_step_ms, "stages_ms": ld_stages_ms, "peak_bytes": ld_peak,
         })

    # -- 12. the directory provider -------------------------------------------
    del cost, mass, cap, ld_res, f_ld, g_ld, a, b, u, v
    torch.cuda.empty_cache()
    directory = asyncio.run(directory_phases(dev, card))
    emit("directory_times", **card, **directory)

    # -- 13. the hierarchical solve ---------------------------------------------
    torch.cuda.empty_cache()
    keep: dict = {}
    hier = asyncio.run(hier_phases(dev, card, keep))
    emit("hier_times", **card, **hier)

    # -- 14. the affinity refine ------------------------------------------------
    torch.cuda.empty_cache()
    affinity = asyncio.run(affinity_phases(dev, card))
    emit("affinity_times", **card, **affinity)

    # -- 15. the persistent provider -------------------------------------------
    torch.cuda.empty_cache()
    persistent = asyncio.run(persistent_phases(dev, card))
    emit("persistent_times", **card, **persistent)

    # -- 16. the mesh-sharded solves ----------------------------------------------
    torch.cuda.empty_cache()
    mesh_times, mesh_launches = asyncio.run(mesh_phases(dev, card, keep.pop("hier_assign")))
    emit("mesh_times", **card, **mesh_times)

    # -- 17. the port's runtime: a live cluster on the card's directory ----------------
    torch.cuda.empty_cache()
    live = live_phases(dev, card)

    # -- 18. the durable backends: a live cluster persists to SQLite and restarts -----
    torch.cuda.empty_cache()
    durable_phases(dev, card)

    # -- 19. the affinity feedback loop on a live cluster --------------------------
    affinity_live_phases(dev, card)

    # -- 20. bench.py's device tiers -----------------------------------------------
    torch.cuda.empty_cache()
    bench_launches = bench_phases(dev, card, live)

    # -- 21. the device's idle share ---------------------------------------------
    torch.cuda.empty_cache()
    asyncio.run(profile_phase(dev, card))

    # -- 22. the runtime's processes and host stages, after the card's memory is freed --
    torch.cuda.empty_cache()
    runtime_phases(card)

    # -- 23. the last tier, examples and tool of the port ---------------------------
    torch.cuda.empty_cache()
    examples_phases(dev, card)

    print(json.dumps({"kernels": [{
        "name": "fused_scaling_iteration",
        "route": "cuda",
        "source": "rio_tpu_torch/kernels/csrc/scaling_iteration.cu",
        "replaces": "rio_tpu/ops/scaling.py:235",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "mesh_launches": mesh_launches["fused_scaling_iteration"],
        "bench_launches": bench_launches,
    }, {
        "name": "fused_iteration",
        "route": "cuda",
        "source": "rio_tpu_torch/kernels/csrc/logdomain_iteration.cu",
        "replaces": "rio_tpu/ops/pallas_sinkhorn.py:99",
        "launches": ld_launches,
        "max_abs_err": ld_max_abs,
        "ms": ld_kernel_ms,
        "plain_ms": ld_plain_ms,
        "bound_ms": ld_bound_ms,
        "bound_by": "bytes" if ld_bytes_ms >= ld_exp_ms else "operations",
        "library_ms": ld_library_ms,
        "mesh_launches": mesh_launches["fused_iteration"],
        "bench_launches": 0,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
