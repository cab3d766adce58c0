"""Live-cluster endurance run on the port (the twin of ``tools/endurance.py``).

Boots N real TCP servers in one process on a TorchObjectPlacement, hammers
them with client traffic while churning the membership (cordon -> re-solve
-> uncordon cycles plus periodic full rebalances), and samples RSS /
request counts / directory invariants. Exercises whichever solve path the
flags select — including the at-scale routing added late in r5
(``--route-small`` forces every flat re-solve through hier_at_scale with
the chunked two-level pipeline, thresholds shrunk so the production code
paths run at test-scale populations).

The provider runs on CUDA unless ``--device`` names another device.

Usage:
    python -m rio_tpu_torch.tools.endurance \
        --minutes 60 --objects 2000 --route-small [--device cpu]
Prints one JSON sample line per interval and a final summary JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import resource
import sys
import time

from rio_tpu_torch import AppData, Registry, ServiceObject, handler, message
from rio_tpu_torch.object_placement import torch_placement as jp_mod
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement


@message
class Bump:
    amount: int = 1


@message
class Count:
    value: int = 0


class Counter(ServiceObject):
    def __init__(self):
        self.value = 0

    @handler
    async def bump(self, msg: Bump, ctx: AppData) -> Count:
        self.value += msg.amount
        return Count(value=self.value)


def build_registry() -> Registry:
    r = Registry()
    r.add_type(Counter)
    return r


async def main(args: argparse.Namespace) -> None:
    from rio_tpu_torch.utils.server_utils import run_integration_test, wait_for_active_members

    if args.route_small:
        jp_mod._FLAT_REBALANCE_MAX_ROWS = 256
        from rio_tpu_torch.parallel import hierarchical as hier_mod  # noqa: F401
        jp_mod._HIER_CHUNK_ROWS = 1024

    if args.persistent:
        from rio_tpu_torch.object_placement.persistent import PersistentTorchObjectPlacement
        from rio_tpu_torch.object_placement.sqlite import SqliteObjectPlacement

        placement = PersistentTorchObjectPlacement(
            SqliteObjectPlacement(args.persistent),
            mode=args.mode, n_iters=10, move_cost=args.move_cost, device=args.device,
        )
    else:
        placement = TorchObjectPlacement(
            mode=args.mode, n_iters=10, move_cost=args.move_cost, device=args.device
        )
    stats = {
        "requests": 0, "errors": 0, "churn_cycles": 0, "rebalances": 0,
        "samples": [],
    }
    stop = asyncio.Event()

    async def body(cluster) -> None:
        clients = [cluster.client() for _ in range(args.workers)]

        async def worker(c, wid: int) -> None:
            i = 0
            while not stop.is_set():
                oid = str((wid * 7919 + i * 31) % args.objects)
                try:
                    await c.send("Counter", oid, Bump(amount=1), returns=Count)
                    stats["requests"] += 1
                except Exception:
                    stats["errors"] += 1
                    await asyncio.sleep(0.05)
                i += 1

        async def churn() -> None:
            k = 0
            while not stop.is_set():
                await asyncio.sleep(args.churn_every)
                addr = cluster.addresses[k % len(cluster.addresses)]
                try:
                    if args.cordon and len(cluster.addresses) > 1:
                        placement.cordon(addr)
                        await placement.rebalance()  # vacate the cordoned node
                        stats["rebalances"] += 1
                        placement.uncordon(addr)
                    await placement.rebalance()
                    stats["rebalances"] += 1
                    stats["churn_cycles"] += 1
                except Exception as e:
                    stats["errors"] += 1
                    print(f"# churn error: {e!r}", file=sys.stderr)
                k += 1

        async def sampler() -> None:
            t0 = time.monotonic()
            last_req = 0
            while not stop.is_set():
                await asyncio.sleep(args.sample_every)
                rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
                sample = {
                    "t_min": round((time.monotonic() - t0) / 60, 1),
                    "requests": stats["requests"],
                    "req_per_s": round((stats["requests"] - last_req) / args.sample_every, 1),
                    "errors": stats["errors"],
                    "churn_cycles": stats["churn_cycles"],
                    "rss_mb": round(rss_mb, 1),
                    "directory": len(placement._placements),
                    "solve_mode": placement.stats.mode,
                }
                if hasattr(placement, "_dirty"):
                    sample["dirty"] = len(placement._dirty)
                last_req = stats["requests"]
                stats["samples"].append(sample)
                print(json.dumps(sample), flush=True)

        workers = [asyncio.create_task(worker(c, i)) for i, c in enumerate(clients)]
        aux = [asyncio.create_task(churn()), asyncio.create_task(sampler())]
        await asyncio.sleep(args.minutes * 60)
        stop.set()
        for t in workers + aux:
            t.cancel()
        await asyncio.gather(*workers, *aux, return_exceptions=True)
        for c in clients:
            res = c.close()
            if asyncio.iscoroutine(res):
                await res

    await run_integration_test(
        body,
        registry_builder=build_registry,
        num_servers=args.servers,
        timeout=args.minutes * 60 + 120,
        placement=placement,
        gossip=True,
    )
    convergence = None
    if args.persistent:
        # The write-behind store must converge to exactly the mirror. Marks
        # made in the final coalesce window are still in the dirty set when
        # the harness tears down — aclose() (final flush + flusher stop) is
        # the planned-shutdown step; without it this check reports spurious
        # divergence for a convergent run.
        try:
            await placement.aclose()
            # A FRESH connection on purpose: the verdict must come from
            # what is actually on disk, not from any state the run's own
            # backing handle might be caching.
            backing = SqliteObjectPlacement(args.persistent)
            await backing.prepare()
            stored = {
                str(it.object_id): it.server_address for it in await backing.items()
            }
            backing.close()
            mirror = {
                k: placement._node_order[idx]
                for k, idx in placement._placements.items()
            }
            convergence = "exact" if stored == mirror else (
                f"DIVERGED: {len(stored)} stored vs {len(mirror)} mirrored, "
                f"{sum(1 for k in mirror if stored.get(k) != mirror[k])} mismatched"
            )
        except Exception as e:
            # A shutdown-flush failure must not discard the whole run's
            # summary — report it as the verdict instead.
            convergence = f"CHECK FAILED: {type(e).__name__}: {e}"

    first_rss = stats["samples"][1]["rss_mb"] if len(stats["samples"]) > 1 else None
    last_rss = stats["samples"][-1]["rss_mb"] if stats["samples"] else None
    print(json.dumps({
        "ok": stats["errors"] == 0 and convergence in (None, "exact"),
        "minutes": args.minutes,
        "requests": stats["requests"],
        "errors": stats["errors"],
        "churn_cycles": stats["churn_cycles"],
        "rss_warm_mb": first_rss,
        "rss_final_mb": last_rss,
        "route_small": bool(args.route_small),
        "mode_final": placement.stats.mode,
        "backing_convergence": convergence,
    }), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=60)
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--mode", default="sinkhorn")
    ap.add_argument("--move-cost", type=float, default=0.5)
    ap.add_argument("--churn-every", type=float, default=45.0)
    ap.add_argument("--sample-every", type=float, default=60.0)
    ap.add_argument("--route-small", action="store_true")
    ap.add_argument("--persistent", metavar="SQLITE_PATH", default=None,
                    help="wrap the provider in write-behind persistence on this db")
    ap.add_argument("--cordon", action="store_true")
    ap.add_argument("--device", default=None, help="the provider's device (CUDA when not given)")
    asyncio.run(main(ap.parse_args()))
