"""What the benchmark's tests know of the ``directory_churn`` driver: its controls and its faults.

Found by the driver's name (``harness.Registry.driver_tests``). The
directory reports no stage spans.
"""

from rio_bench.reference import directory


def controls(config) -> dict:
    """Two plain directories, each breaking one guarantee: ``keep_all`` the quotas, ``reshuffle`` the moves."""
    max_delta = config["provider"]["max_delta_solves"]
    return {
        "keep_all": lambda: directory.PlainDirectory(keep_all=True, max_delta_solves=max_delta),
        "reshuffle": lambda: directory.PlainDirectory(reshuffle=True, max_delta_solves=max_delta),
    }


class _FaultyDirectory:
    """The program's directory with one fault where its answers are produced."""

    def __init__(self, inner, fault):
        self._inner, self._fault = inner, fault
        self._last: list = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def assign_batch(self, ids):
        self._last = list(ids)
        if self._fault == "half":
            half = len(ids) // 2
            return [*await self._inner.assign_batch(ids[:half]), *[None] * (len(ids) - half)]
        return await self._inner.assign_batch(ids)

    async def rebalance(self, **kw):
        if self._fault == "unchanged":
            return 0
        moved = await self._inner.rebalance(**kw)
        if self._fault == "altered":
            from rio_tpu_torch.object_placement import ObjectPlacementItem

            oid = self._last[0]
            seat = await self._inner.lookup(oid)
            other = next(a for a in self._inner._node_order if a != seat)
            await self._inner.update(ObjectPlacementItem(oid, other))
        return moved


def broken(fault, config):
    """The program's directory with ``fault``: ``unchanged``, ``half`` or ``altered``."""
    from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement

    return lambda: _FaultyDirectory(TorchObjectPlacement(device="cpu", **config["provider"]), fault)


stages = None
