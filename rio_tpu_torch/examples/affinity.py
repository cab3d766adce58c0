"""affinity: communication-aware placement that cuts bytes over TCP.

The edge sampler (``rio_tpu_torch/affinity``, on by default in every server)
watches *who talks to whom* at the dispatch path: each served request
records a ``(source actor | "client", target actor)`` edge with EMA
byte/call rates. This demo closes the full feedback loop on a live
2-node cluster:

1. **workload** — 8 ``Front`` actors each forward every request to a
   partner ``Back`` actor, local-first (the cursor/saga delivery idiom:
   try the in-server dispatch queue; only a REDIRECT falls back to a
   cluster client and stamps the edge sender-side).
2. **adversarial seating** — the directory is pre-seated load-BALANCED
   but pair-SPLIT: every Front on one node, its Back on the other, so a
   load-only solver has no reason to move anything while every forward
   crosses TCP.
3. **scrape → merge → solve** — per-node graphs come back over the wire
   via the admin ``DumpEdges`` command (``cluster_edges`` merges them;
   the ``python -m rio_tpu_torch.admin edges`` CLI renders the same view),
   ``set_edge_graph`` installs the merged graph, and a full rebalance
   runs the alternating linearized-OT refine on top of the unchanged
   Sinkhorn core.
4. **payoff** — identical traffic again: every pair is now co-seated,
   forwards resolve in-process, and the TCP byte counters collapse. The
   demo asserts co-location and a >= 2x bytes-over-TCP drop.

The twin of ``examples/affinity.py`` on the port's runtime, with
:class:`~rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement`
as the provider, on CUDA unless the caller asks for another device. Run::

    python -m rio_tpu_torch.examples.affinity [DEVICE]

Nothing runs at import.
"""

import asyncio
import sys

from rio_tpu_torch import (
    AppData,
    Client,
    LocalStorage,
    ObjectId,
    ObjectPlacementItem,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
)
from rio_tpu_torch.affinity import EdgeSampler
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider
from rio_tpu_torch.errors import HandlerError
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
from rio_tpu_torch.registry import type_id

N_PAIRS = 8
ROUNDS = 40
PAD = 2048


@message
class Work:
    seq: int = 0
    pad: bytes = b""


@message
class Ack:
    seq: int = 0


class Back(ServiceObject):
    """The chatty partner: receives the padded forwards."""

    @handler
    async def work(self, msg: Work, ctx: AppData) -> Ack:
        return Ack(seq=msg.seq)


class Front(ServiceObject):
    """Forwards every request to its partner Back, local-first.

    Inside a dispatched handler the affinity source is already bound to
    this actor's identity, so the in-process leg needs no extra code: the
    partner's dispatch records the ``Front.i -> Back.i`` edge by itself.
    Only the remote fallback leg stamps the edge explicitly — the wire
    carries no source identity, so the receiving node would otherwise
    attribute it to ``"client"``.
    """

    def __init__(self) -> None:
        self._remote = False

    @handler
    async def work(self, msg: Work, ctx: AppData) -> Ack:
        # The client's trigger frame is small; the Front fattens the
        # payload it pushes to its partner — so the Front->Back leg is
        # the traffic that matters, exactly the shape co-location fixes.
        fat = Work(seq=msg.seq, pad=b"\x00" * PAD)
        if not self._remote:
            try:
                return await self.send(ctx, Back, self.id, fat, returns=Ack)
            except HandlerError as e:
                if not str(e).startswith("REDIRECT"):
                    raise
                self._remote = True  # seated elsewhere; go remote
        ack = await ctx.get(Client).send(Back, self.id, fat, returns=Ack)
        sampler = ctx.try_get(EdgeSampler)
        if sampler is not None:
            sampler.observe(
                f"{type_id(Front)}.{self.id}",
                f"{type_id(Back)}.{self.id}",
                len(fat.pad),
                False,
            )
        return ack


async def main(device=None) -> dict:
    members = LocalStorage()
    # The graph term is priced per edge against the stay-put move_cost;
    # host_factor is ~zeroed because both "nodes" share this host yet the
    # loopback sockets between them still carry every byte (the shipping
    # 0.5 default is for real multi-host topologies).
    placement = TorchObjectPlacement(
        node_axis_size=4,
        mode="greedy",
        affinity_weight=2.0,
        affinity_host_factor=0.05,
        device=device,
    )
    servers: list[Server] = []
    for _ in range(2):
        s = Server(
            address="127.0.0.1:0",
            registry=Registry().add_type(Front).add_type(Back),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
            # Demo-speed fidelity: sample every dispatch instead of the
            # shipping 1-in-8 stride, so a short run sees every edge.
            affinity_stride=1,
        )
        await s.prepare()
        print(f"[server] node on {await s.bind()}")
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    await asyncio.sleep(0.1)

    node0, node1 = (s.local_address for s in servers)
    for addr in (node0, node1):
        placement.register_node(addr)
    # Load-balanced but pair-split: the worst seating for bytes-over-TCP
    # that a load-only solver would still call perfect.
    for i in range(N_PAIRS):
        await placement.update(
            ObjectPlacementItem(ObjectId(type_id(Front), str(i)), node0 if i % 2 else node1)
        )
        await placement.update(
            ObjectPlacementItem(ObjectId(type_id(Back), str(i)), node1 if i % 2 else node0)
        )

    client = Client(members)
    for s in servers:  # the Fronts' remote-fallback leg
        s.app_data.set(Client(members))

    async def drive(rounds: int) -> None:
        for r in range(rounds):
            for i in range(N_PAIRS):
                await client.send(Front, str(i), Work(seq=r), returns=Ack)

    def tcp_total() -> int:
        return sum(
            s.affinity.tcp_in_bytes + s.affinity.tcp_out_bytes for s in servers
        )

    await drive(4)  # warm: activate every pair on its adversarial seat

    t0 = tcp_total()
    await drive(ROUNDS)
    blind = tcp_total() - t0
    print(f"[blind]    {blind} bytes over TCP ({ROUNDS * N_PAIRS} requests)")

    # Scrape every node's edge graph over the wire and merge — exactly
    # what `python -m rio_tpu_torch.admin edges` renders for an operator.
    from rio_tpu_torch.admin import cluster_edges

    rows = await cluster_edges(client, members)
    actor_rows = [r for r in rows if r[0] != "client"]
    print(f"[edges]    {len(rows)} merged edges; hottest actor-to-actor:")
    for src, dst, bps, cps, lf in actor_rows[:4]:
        print(f"           {src} -> {dst}  {bps:,.0f} B/s  {cps:.1f} call/s  local={lf:.2f}")

    installed = placement.set_edge_graph(rows)
    moves = await placement.rebalance(delta=False)
    print(f"[solve]    {installed} edges installed, {moves} moves, mode={placement.stats.mode}")
    for h in placement._affinity_history:
        print(
            f"           pass {h['pass']}: cut={h['cut']:.4f} "
            f"total={h['total']:.4f} accepted={h['accepted']}"
        )

    pairs_local = 0
    for i in range(N_PAIRS):
        f = await placement.lookup(ObjectId(type_id(Front), str(i)))
        b = await placement.lookup(ObjectId(type_id(Back), str(i)))
        pairs_local += int(f == b)
    print(f"[place]    {pairs_local}/{N_PAIRS} pairs co-located")

    await drive(4)  # settle: activations follow the new directory

    t0 = tcp_total()
    await drive(ROUNDS)
    after = tcp_total() - t0
    ratio = blind / max(after, 1)
    print(f"[affinity] {after} bytes over TCP — {ratio:.1f}x fewer than blind")

    client.close()
    for s in servers:
        s.app_data.get(Client).close()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)

    assert pairs_local == N_PAIRS, f"only {pairs_local}/{N_PAIRS} pairs co-located"
    assert ratio >= 2.0, f"bytes-over-TCP ratio {ratio:.2f} < 2x"
    print("[demo] done")
    return {"blind": blind, "affinity": after, "ratio": ratio, "pairs": pairs_local}


if __name__ == "__main__":
    asyncio.run(main(sys.argv[1] if len(sys.argv) > 1 else None))
