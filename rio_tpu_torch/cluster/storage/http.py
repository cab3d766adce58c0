"""Read-only HTTP membership API.

Reference: ``rio-rs/src/cluster/storage/http.rs`` — the server exposes
``GET /members`` and ``GET /members/{ip}/{port}/`` (``:35-83``, wired at
``server.rs:205-229``), and ``HttpMembershipStorage`` is a client-side
``MembershipStorage`` over that API whose write operations fail with
``MembershipError::ReadOnly`` (``:85-150``). This lets clients join a
cluster without database credentials.
"""

from __future__ import annotations

import asyncio
import json
import logging

from ...errors import MembershipError, MembershipReadOnly
from . import Member, MembershipStorage

log = logging.getLogger("rio_tpu_torch.http_members")


def _member_json(m: Member) -> dict:
    return {
        "ip": m.ip,
        "port": m.port,
        "active": m.active,
        "last_seen": m.last_seen,
        "load": m.load,
        "shard_map": m.shard_map,
    }


async def serve_members_http(address: str, storage: MembershipStorage) -> None:
    """Serve the members API until cancelled (aiohttp, read-only)."""
    from aiohttp import web

    async def list_members(_request):
        members = await storage.members()
        return web.json_response([_member_json(m) for m in members])

    async def get_member(request):
        ip = request.match_info["ip"]
        port = int(request.match_info["port"])
        for m in await storage.members():
            if m.ip == ip and m.port == port:
                return web.json_response(_member_json(m))
        raise web.HTTPNotFound()

    app = web.Application()
    app.router.add_get("/members", list_members)
    app.router.add_get("/members/{ip}/{port}", get_member)
    app.router.add_get("/members/{ip}/{port}/", get_member)

    host, _, port = address.rpartition(":")
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host or "0.0.0.0", int(port))
    await site.start()
    log.info("members API listening on %s", address)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await runner.cleanup()


class HttpMembershipStorage(MembershipStorage):
    """Client-side read-only membership view over the HTTP API."""

    def __init__(self, base_url: str) -> None:
        if not base_url.startswith("http"):
            base_url = f"http://{base_url}"
        self.base_url = base_url.rstrip("/")

    async def _get(self, path: str):
        import aiohttp

        try:
            async with aiohttp.ClientSession() as session:
                async with session.get(self.base_url + path) as resp:
                    if resp.status == 404:
                        return None
                    resp.raise_for_status()
                    return json.loads(await resp.text())
        except aiohttp.ClientError as e:
            raise MembershipError(f"members API unreachable: {e}") from e

    async def members(self) -> list[Member]:
        rows = await self._get("/members") or []
        return [
            Member(ip=r["ip"], port=r["port"], active=r["active"],
                   last_seen=r["last_seen"], load=r.get("load", ""),
                   shard_map=r.get("shard_map", ""))
            for r in rows
        ]

    # -- write surface: read-only by design (reference http.rs:85-150) -------

    async def push(self, member: Member) -> None:
        raise MembershipReadOnly("push")

    async def remove(self, ip: str, port: int) -> None:
        raise MembershipReadOnly("remove")

    async def set_is_active(self, ip: str, port: int, active: bool) -> None:
        raise MembershipReadOnly("set_is_active")

    async def notify_failure(self, ip: str, port: int) -> None:
        raise MembershipReadOnly("notify_failure")

    async def member_failures(self, ip: str, port: int) -> list[float]:
        raise MembershipReadOnly("member_failures")
