"""ping-pong: the minimal rio-tpu application.

Parity with the reference's ping-pong example
(``rio-rs/examples/ping-pong``): a ``PingService`` actor that
answers ``Ping`` with ``Pong`` and shuts itself down after 3 requests.

Runs a 2-node cluster (real TCP on loopback, shared in-memory membership)
and a cluster-transparent client in one process::

    python -m rio_tpu_torch.examples.ping_pong
"""

import asyncio


from rio_tpu_torch import (
    AppData,
    LocalObjectPlacement,
    LocalStorage,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider


@message
class Ping:
    ping_id: int = 0


@message
class Pong:
    ping_id: int = 0
    served: int = 0
    server: str = ""


class PingService(ServiceObject):
    """Answers pings; self-destructs after 3 (reference services.rs:10-37)."""

    def __init__(self):
        self.served = 0

    @handler
    async def ping(self, msg: Ping, ctx: AppData) -> Pong:
        from rio_tpu_torch import ServerInfo

        self.served += 1
        if self.served >= 3:
            await self.shutdown(ctx)  # deallocate after this response
        return Pong(ping_id=msg.ping_id, served=self.served, server=ctx.get(ServerInfo).address)


def build_registry() -> Registry:
    return Registry().add_type(PingService)


async def main() -> None:
    members = LocalStorage()
    placement = LocalObjectPlacement()

    servers = []
    for _ in range(2):
        s = Server(
            address="127.0.0.1:0",
            registry=build_registry(),
            cluster_provider=LocalClusterProvider(members),
            object_placement_provider=placement,
        )
        await s.prepare()
        addr = await s.bind()
        print(f"[server] listening on {addr}")
        servers.append(s)

    tasks = [asyncio.create_task(s.run()) for s in servers]
    await asyncio.sleep(0.1)

    from rio_tpu_torch import ClientBuilder

    client = ClientBuilder().members_storage(members).build()
    for i in range(7):
        pong = await client.send(PingService, "pingu", Ping(ping_id=i), returns=Pong)
        print(f"[client] ping {i} -> pong served={pong.served} by {pong.server}")

    client.close()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    print("[demo] done")


if __name__ == "__main__":
    asyncio.run(main())
