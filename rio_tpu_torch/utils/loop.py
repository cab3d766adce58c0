"""Optional event-loop acceleration (uvloop).

The committed RPC profile (``PROFILE_RPC.md``) puts ~50% of per-message
CPU in asyncio loop machinery (task creation, callback scheduling, future
wakeups) after the write-corking work — rio-tpu code itself is no longer
the top line. uvloop replaces that machinery wholesale (libuv + Cython),
the same lever the reference gets from tokio's compiled runtime
(rio-rs's ``src/service.rs:370-459``). It is deliberately an
OPTIONAL extra: the framework must keep running on the stock loop (the
bench/CI image has no uvloop, and Windows has no libuv loop at all).

Usage — once, before any server/client is created::

    from rio_tpu_torch.utils.loop import install_uvloop
    install_uvloop()            # no-op False if uvloop is absent
    asyncio.run(main())

or let ``Server.run``'s caller decide; nothing in rio-tpu calls this
implicitly (an event-loop policy swap is process-global, so it belongs to
the application, not the library).
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger(__name__)


def install_uvloop() -> bool:
    """Install uvloop's event-loop policy if available; returns success.

    Must run before the event loop is created (``asyncio.run`` /
    ``new_event_loop``); a policy swap does not touch a loop that is
    already running. Returns False — never raises — when uvloop is not
    installed, so call sites can be unconditional.
    """
    try:
        import uvloop
    except ImportError:
        log.debug("uvloop not installed; keeping the stock asyncio loop")
        return False
    asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
    log.info("uvloop event-loop policy installed")
    return True


def loop_flavor() -> str:
    """Name of the loop implementation the current policy would create
    (``"uvloop"`` or ``"asyncio"``) — surfaced in stats/diagnostics so a
    deployment can verify which data-plane loop it is actually running."""
    policy = asyncio.get_event_loop_policy()
    return "uvloop" if type(policy).__module__.startswith("uvloop") else "asyncio"
