"""Shared actors for the port's sharded-server cross-process tests.

The port's copy of ``tests/sharded_actors.py``, on ``rio_tpu_torch``.
Imported by BOTH sides of the real-socket runs: each sharded worker
process builds its registry from ``tests.torch_sharded_actors:build_registry``;
the parent test imports this module so the ``@message`` decorators
register the same wire names for the client's codec. Keep it
dependency-light — workers boot with a clean env.
"""

import asyncio

from rio_tpu_torch import AppData, Registry, ServerInfo, ServiceObject, handler, message


@message(name="sh.Bump")
class Bump:
    amount: int = 1


@message(name="sh.Get")
class Get:
    pass


@message(name="sh.Val")
class Val:
    value: int = 0
    address: str = ""
    overlapped: int = 0


class ShardCounter(ServiceObject):
    """Volatile counter with a deliberate read-modify-write window.

    ``bump`` reads, yields the event loop, then writes — so two handlers
    interleaving on the SAME instance lose updates and flip ``overlapped``.
    Under the per-object serialized-execution invariant the final value
    must equal the number of bumps and ``overlapped`` must stay 0, even
    with the requests fanned across a sharded node's worker processes.
    """

    def __init__(self):
        self.value = 0
        self.overlapped = 0
        self._busy = False

    def __migrate_state__(self):
        return {"value": self.value}

    def __restore_state__(self, state):
        self.value = int(state["value"])

    @handler
    async def bump(self, msg: Bump, ctx: AppData) -> Val:
        if self._busy:
            self.overlapped += 1
        self._busy = True
        v = self.value
        await asyncio.sleep(0)  # open the interleave window
        self.value = v + msg.amount
        self._busy = False
        return Val(
            value=self.value,
            address=ctx.get(ServerInfo).address,
            overlapped=self.overlapped,
        )

    @handler
    async def get(self, msg: Get, ctx: AppData) -> Val:
        return Val(
            value=self.value,
            address=ctx.get(ServerInfo).address,
            overlapped=self.overlapped,
        )


def build_registry() -> Registry:
    return Registry().add_type(ShardCounter)
