"""``ObjectId``: a copy of ``rio_tpu.registry.ObjectId``.

The directory keys every object by ``str(object_id)``, the form
``"{type_name}.{id}"``. The provider accepts any object whose ``str()``
has that form, so the ``ObjectId`` that a ``rio_tpu`` ``Server`` hands it
works as well as this one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObjectId:
    """Cluster-wide actor address ``(type_name, object_id)``."""

    type_name: str
    id: str

    def __str__(self) -> str:  # storage key form used by placement backends
        return f"{self.type_name}.{self.id}"
