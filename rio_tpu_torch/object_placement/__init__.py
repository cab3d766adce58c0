"""Object placement: the cluster-wide actor directory, for the port.

Copies of the trait surface of ``rio_tpu/object_placement/__init__.py``:
:class:`ObjectPlacementItem`, :func:`sanitize_standby_row`, the
:class:`ObjectPlacement` ABC (a CRUD mapping ``ObjectId -> server_address``
consulted on every request) and :class:`LocalObjectPlacement`, the
in-memory store. The port's provider is
:class:`~rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement`,
:class:`~rio_tpu_torch.object_placement.torch_placement.AffinityTracker`
feeds its hierarchical mode, and
:class:`~rio_tpu_torch.object_placement.persistent.PersistentTorchObjectPlacement`
adds write-behind durability on a backing store; all are exported here.
Its ``update`` reads ``item.object_id`` and ``item.server_address`` by
attribute, so ``rio_tpu``'s items serve as well as these.
"""

from __future__ import annotations

import abc
import dataclasses

from ..registry import ObjectId

__all__ = [
    "AffinityTracker",
    "LocalObjectPlacement",
    "ObjectId",
    "ObjectPlacementItem",
    "ObjectPlacement",
    "PersistentTorchObjectPlacement",
    "TorchObjectPlacement",
    "sanitize_standby_row",
]


@dataclasses.dataclass
class ObjectPlacementItem:
    """One directory row."""

    object_id: ObjectId
    server_address: str | None = None


def sanitize_standby_row(held: object, epoch: object) -> tuple[list[str], int]:
    """Defensive decode of a standby row read back from a backend.

    Replica rows outlive code versions: a directory written by an older
    deployment (or hand-edited, or corrupted) must degrade to "no standbys"
    — a read-capacity loss — never to an exception on the request path. A
    non-integer or negative epoch poisons the fence, so the whole row is
    dropped; individually malformed addresses are filtered while the rest
    of the set survives.
    """
    try:
        ep = int(epoch)  # type: ignore[call-overload]
    except (TypeError, ValueError):
        return [], 0
    if ep < 0:
        return [], 0
    if not isinstance(held, (list, tuple)):
        return [], ep
    addrs: list[str] = []
    for a in held:
        if isinstance(a, bytes):
            try:
                a = a.decode()
            except UnicodeDecodeError:
                continue
        if not isinstance(a, str):
            continue
        host, sep, port = a.rpartition(":")
        if sep and host and port.isdigit():
            addrs.append(a)
    return addrs, ep


class ObjectPlacement(abc.ABC):
    """CRUD directory trait."""

    async def prepare(self) -> None:
        return None

    @abc.abstractmethod
    async def update(self, item: ObjectPlacementItem) -> None:
        """Upsert an object's address (atomic per key)."""

    @abc.abstractmethod
    async def lookup(self, object_id: ObjectId) -> str | None: ...

    @abc.abstractmethod
    async def clean_server(self, address: str) -> None:
        """Bulk-unassign every object placed on ``address`` (dead node)."""

    @abc.abstractmethod
    async def remove(self, object_id: ObjectId) -> None: ...

    # Batch hooks — default to per-item loops; the accelerated provider
    # overrides them with one device solve.
    async def lookup_batch(self, object_ids: list[ObjectId]) -> list[str | None]:
        return [await self.lookup(oid) for oid in object_ids]

    async def update_batch(self, items: list[ObjectPlacementItem]) -> None:
        for item in items:
            await self.update(item)

    async def items(self) -> list[ObjectPlacementItem]:
        """Every directory row (optional trait method): required of a
        provider used as the durable backing store behind a persistent
        directory, whose warm restart reloads the whole directory."""
        raise NotImplementedError(f"{type(self).__name__} cannot enumerate")

    # ------------------------------------------------------------------
    # Replica rows. Every backend stores, next to the primary row, an
    # optional ``(standbys, epoch)`` pair per object. The epoch is the
    # fence: it only ever moves through :meth:`promote_standby`'s
    # compare-and-swap.
    # ------------------------------------------------------------------

    async def set_standbys(self, object_id: ObjectId, addresses: list[str]) -> int:
        """Replace the standby set; the epoch is preserved (created at 0).

        Returns the row's current epoch so the caller can fence its ships.
        """
        raise NotImplementedError(f"{type(self).__name__} stores no standbys")

    async def standbys(self, object_id: ObjectId) -> tuple[list[str], int]:
        """``(standby addresses, epoch)``; ``([], 0)`` when no replica row
        exists (an epoch-0 row and no row are indistinguishable on purpose:
        promotion from either state produces epoch 1)."""
        raise NotImplementedError(f"{type(self).__name__} stores no standbys")

    async def promote_standby(
        self, object_id: ObjectId, address: str, expected_epoch: int
    ) -> int | None:
        """CAS promotion: if ``address`` is a current standby and the row's
        epoch equals ``expected_epoch``, make it the primary (primary row
        flipped, ``address`` removed from the standby set, epoch bumped)
        and return the new epoch. Returns ``None`` when the CAS loses —
        someone else promoted first, or the standby set changed."""
        raise NotImplementedError(f"{type(self).__name__} stores no standbys")


class LocalObjectPlacement(ObjectPlacement):
    """In-memory directory; clones alias the same dict (the keying scheme
    ``"{type}.{id}"`` of every backend)."""

    def __init__(self) -> None:
        self._placements: dict[str, str] = {}
        self._standbys: dict[str, tuple[list[str], int]] = {}

    async def update(self, item: ObjectPlacementItem) -> None:
        key = str(item.object_id)
        if item.server_address is None:
            self._placements.pop(key, None)
        else:
            self._placements[key] = item.server_address

    async def lookup(self, object_id: ObjectId) -> str | None:
        return self._placements.get(str(object_id))

    async def clean_server(self, address: str) -> None:
        stale = [k for k, v in self._placements.items() if v == address]
        for k in stale:
            del self._placements[k]

    async def remove(self, object_id: ObjectId) -> None:
        self._placements.pop(str(object_id), None)
        self._standbys.pop(str(object_id), None)

    async def set_standbys(self, object_id: ObjectId, addresses: list[str]) -> int:
        key = str(object_id)
        _, epoch = self._standbys.get(key, ([], 0))
        if addresses:
            self._standbys[key] = (list(addresses), epoch)
        elif epoch:
            self._standbys[key] = ([], epoch)
        else:
            self._standbys.pop(key, None)
        return epoch

    async def standbys(self, object_id: ObjectId) -> tuple[list[str], int]:
        held, epoch = self._standbys.get(str(object_id), ([], 0))
        return sanitize_standby_row(held, epoch)

    async def promote_standby(
        self, object_id: ObjectId, address: str, expected_epoch: int
    ) -> int | None:
        key = str(object_id)
        held, epoch = self._standbys.get(key, ([], 0))
        if epoch != expected_epoch or address not in held:
            return None
        self._standbys[key] = ([a for a in held if a != address], epoch + 1)
        self._placements[key] = address
        return epoch + 1

    async def items(self) -> list[ObjectPlacementItem]:
        return [
            ObjectPlacementItem(ObjectId(*k.split(".", 1)), v)
            for k, v in self._placements.items()
        ]

    def count(self) -> int:
        return len(self._placements)


# Last: the provider modules import the trait above from this package.
from .torch_placement import AffinityTracker, TorchObjectPlacement  # noqa: E402
from .persistent import PersistentTorchObjectPlacement  # noqa: E402
