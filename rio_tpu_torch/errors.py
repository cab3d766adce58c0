"""Errors of the port: copies of the placement errors of ``rio_tpu/errors.py``.

The port imports no module of ``rio_tpu``, so :class:`RioError` here is
the port's own base, not ``rio_tpu.errors.RioError``. Callers that catch
``ValueError`` catch :class:`NoSchedulableCapacity` from either package.
"""

from __future__ import annotations


class RioError(Exception):
    """Base class for the port's errors."""


class ObjectPlacementError(RioError):
    """Placement directory operation failed."""


class NoSchedulableCapacity(ObjectPlacementError, ValueError):
    """A placement solve ran with zero registered nodes.

    Raised by ``TorchObjectPlacement.assign_batch`` when asked to seat
    objects before any node has registered: typically a bring-up ordering
    bug (placing before ``register_node``/``sync_members``) or a cluster
    that lost every member. Subclasses ``ValueError`` for callers that
    catch the bare error."""
