"""black-jack: a full game built on rio-tpu actors.

Parity with the reference's black-jack example
(``rio-rs/examples/black-jack``):

* a ``Cassino`` actor spawns per-game ``GameTable`` actors with uuid ids
  (``src/services/mod.rs``);
* each table runs its game engine on a **dedicated OS thread** bridged to
  the actor with thread-safe queues — the reference runs a bevy ECS loop
  on a spawned thread bridged with crossbeam channels
  (``src/services/table.rs:54-99``);
* every state transition is **published** to subscribers via the
  ``MessageRouter`` (``table.rs:72-86``);
* the thread's lifecycle is tied to the actor's ``after_load`` /
  ``before_shutdown`` hooks (``table.rs:104-131``);
* game *rules* are plain, framework-free code, unit-tested directly
  (``tests/game.rs``) — see ``tests/test_black_jack.py``.

Run a demo game::

    python -m rio_tpu_torch.examples.black_jack
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue
import random
import threading
import uuid


from rio_tpu_torch import (
    AppData,
    Client,
    LocalObjectPlacement,
    LocalStorage,
    MessageRouter,
    Registry,
    Server,
    ServiceObject,
    handler,
    message,
    type_id,
)
from rio_tpu_torch.cluster.membership_protocol import LocalClusterProvider

# ---------------------------------------------------------------------------
# Game rules — pure, framework-free (reference examples/black-jack/src/game.rs
# shape; unit-tested in tests/test_black_jack.py like tests/game.rs)
# ---------------------------------------------------------------------------

SUITS = "♠♥♦♣"
RANKS = ["A", "2", "3", "4", "5", "6", "7", "8", "9", "10", "J", "Q", "K"]


def card_value(rank: str) -> int:
    if rank == "A":
        return 11  # soft; hand_value demotes to 1 as needed
    if rank in ("J", "Q", "K"):
        return 10
    return int(rank)


def hand_value(cards: list[str]) -> int:
    """Best blackjack value ≤21 if possible (aces count 11 then demote)."""
    ranks = [c.rstrip("♠♥♦♣") for c in cards]
    total = sum(card_value(r) for r in ranks)
    aces = sum(1 for r in ranks if r == "A")
    while total > 21 and aces:
        total -= 10
        aces -= 1
    return total


def is_blackjack(cards: list[str]) -> bool:
    return len(cards) == 2 and hand_value(cards) == 21


class Deck:
    """Seeded 52-card deck; deterministic for tests."""

    def __init__(self, seed: int | None = None) -> None:
        self.cards = [f"{r}{s}" for s in SUITS for r in RANKS]
        random.Random(seed).shuffle(self.cards)

    def draw(self) -> str:
        return self.cards.pop()


def dealer_should_hit(cards: list[str]) -> bool:
    """House policy: draw to 17 (stand on all 17s)."""
    return hand_value(cards) < 17


def settle(player: list[str], dealer: list[str]) -> str:
    """Outcome from the player's perspective. A natural (two-card 21)
    beats any made 21; natural vs natural pushes."""
    pv, dv = hand_value(player), hand_value(dealer)
    if pv > 21:
        return "player_bust"
    if is_blackjack(player) and not is_blackjack(dealer):
        return "player_blackjack"
    if is_blackjack(dealer) and not is_blackjack(player):
        return "dealer_win"
    if dv > 21:
        return "dealer_bust"
    if pv > dv:
        return "player_win"
    if pv < dv:
        return "dealer_win"
    return "push"


@dataclasses.dataclass
class GameState:
    """One table's full state; snapshots of this are published to subscribers."""

    table_id: str = ""
    phase: str = "waiting"  # waiting -> player_turn -> settled
    player: str = ""
    player_cards: list[str] = dataclasses.field(default_factory=list)
    dealer_cards: list[str] = dataclasses.field(default_factory=list)
    outcome: str = ""

    def visible_dealer(self) -> list[str]:
        """Dealer shows one card until the hand settles."""
        if self.phase == "settled" or len(self.dealer_cards) < 2:
            return list(self.dealer_cards)
        return [self.dealer_cards[0], "??"]


class GameEngine:
    """The rules engine a table thread runs. Synchronous and deterministic."""

    def __init__(self, table_id: str, seed: int | None = None) -> None:
        self.deck = Deck(seed)
        self.state = GameState(table_id=table_id)

    def apply(self, cmd: str, arg: str = "") -> GameState:
        s = self.state
        if cmd == "join" and s.phase == "waiting":
            s.player = arg
            s.player_cards = [self.deck.draw(), self.deck.draw()]
            s.dealer_cards = [self.deck.draw(), self.deck.draw()]
            if is_blackjack(s.player_cards):
                self._dealer_play()
            else:
                s.phase = "player_turn"
        elif cmd == "hit" and s.phase == "player_turn":
            s.player_cards.append(self.deck.draw())
            if hand_value(s.player_cards) > 21:
                s.phase = "settled"
                s.outcome = "player_bust"
        elif cmd == "stand" and s.phase == "player_turn":
            self._dealer_play()
        elif cmd == "snapshot":
            pass
        else:
            raise ValueError(f"command {cmd!r} invalid in phase {s.phase!r}")
        return dataclasses.replace(
            s,
            player_cards=list(s.player_cards),
            dealer_cards=list(s.dealer_cards),
        )

    def _dealer_play(self) -> None:
        s = self.state
        while dealer_should_hit(s.dealer_cards):
            s.dealer_cards.append(self.deck.draw())
        s.phase = "settled"
        s.outcome = settle(s.player_cards, s.dealer_cards)


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@message
class OpenTable:
    seed: int = -1  # -1 → random


@message
class TableOpened:
    table_id: str = ""


@message
class Join:
    player: str = ""


@message
class Hit:
    pass


@message
class Stand:
    pass


@message
class TableView:
    table_id: str = ""
    phase: str = ""
    player: str = ""
    player_cards: list[str] = dataclasses.field(default_factory=list)
    dealer_cards: list[str] = dataclasses.field(default_factory=list)  # visible
    player_value: int = 0
    outcome: str = ""


def view_of(state: GameState) -> TableView:
    return TableView(
        table_id=state.table_id,
        phase=state.phase,
        player=state.player,
        player_cards=list(state.player_cards),
        dealer_cards=state.visible_dealer(),
        player_value=hand_value(state.player_cards),
        outcome=state.outcome,
    )


# ---------------------------------------------------------------------------
# Actors
# ---------------------------------------------------------------------------


class Cassino(ServiceObject):
    """Front desk: opens tables (reference Cassino spawning GameTables)."""

    def __init__(self) -> None:
        super().__init__()
        self.tables_opened = 0

    @handler
    async def open_table(self, msg: OpenTable, ctx: AppData) -> TableOpened:
        table_id = uuid.uuid4().hex
        self.tables_opened += 1
        # Activate the table actor (actor-to-actor send through the server's
        # internal client, reference service_object.rs:52-83) and seed it.
        await ServiceObject.send(
            ctx, GameTable, table_id, SetSeed(seed=msg.seed), returns=SeedAck,
        )
        return TableOpened(table_id=table_id)


@message
class SetSeed:
    seed: int = -1


@message
class SeedAck:
    pass


class _TableThread:
    """Dedicated OS thread driving a GameEngine; queue-bridged.

    Commands go in through a thread-safe queue and each carries its own
    reply slot; every resulting state snapshot is also pushed to an event
    queue that the actor pumps into the MessageRouter (the reference's
    crossbeam in/out channel pair, table.rs:54-99).
    """

    _STOP = object()

    def __init__(self, table_id: str, seed: int | None) -> None:
        self.commands: queue.Queue = queue.Queue()
        self.events: queue.Queue = queue.Queue()
        self.engine = GameEngine(table_id, seed)
        self.thread = threading.Thread(
            target=self._run, name=f"table-{table_id[:8]}", daemon=True
        )
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.commands.get()
            if item is self._STOP:
                self.events.put(self._STOP)
                return
            cmd, arg, reply = item
            try:
                snapshot = self.engine.apply(cmd, arg)
                reply["state"] = snapshot
            except Exception as e:  # noqa: BLE001 — forwarded to the actor
                reply["error"] = e
            finally:
                reply["done"].set()
            if "state" in reply and cmd != "snapshot":
                self.events.put(reply["state"])

    async def ask(self, cmd: str, arg: str = "") -> GameState:
        reply: dict = {"done": threading.Event()}
        self.commands.put((cmd, arg, reply))
        await asyncio.to_thread(reply["done"].wait)
        if "error" in reply:
            raise reply["error"]
        return reply["state"]

    def stop(self) -> None:
        self.commands.put(self._STOP)
        self.thread.join(timeout=5)


class GameTable(ServiceObject):
    """One table == one actor == one engine thread (uuid-addressed)."""

    def __init__(self) -> None:
        super().__init__()
        self._table: _TableThread | None = None
        self._pump: asyncio.Task | None = None
        self._seed: int | None = None

    async def after_load(self, ctx: AppData) -> None:
        self._table = _TableThread(self.id, self._seed)
        self._pump = asyncio.create_task(self._pump_events(ctx))

    async def before_shutdown(self, ctx: AppData) -> None:
        # Reference table.rs:104-131: join the thread on actor shutdown.
        if self._pump is not None:
            self._pump.cancel()
        if self._table is not None:
            await asyncio.to_thread(self._table.stop)
            self._table = None

    async def _pump_events(self, ctx: AppData) -> None:
        """Engine thread → MessageRouter bridge (reference table.rs:72-86).

        Polls with a short timeout rather than blocking forever so that a
        cancelled pump never strands an executor thread in ``queue.get``.
        """
        router = ctx.get(MessageRouter)
        table = self._table
        assert table is not None
        while True:
            try:
                state = await asyncio.to_thread(table.events.get, True, 0.25)
            except queue.Empty:
                continue
            if state is _TableThread._STOP:
                return
            router.publish(type_id(GameTable), self.id, view_of(state))

    @handler
    async def set_seed(self, msg: SetSeed, ctx: AppData) -> SeedAck:
        if self._table is not None and msg.seed >= 0:
            # Re-arm the engine with the requested seed (table was activated
            # with a random deck before the seed arrived).
            await asyncio.to_thread(self._table.stop)
            self._seed = msg.seed
            self._table = _TableThread(self.id, self._seed)
            if self._pump is not None:
                self._pump.cancel()
            self._pump = asyncio.create_task(self._pump_events(ctx))
        return SeedAck()

    @handler
    async def join(self, msg: Join, ctx: AppData) -> TableView:
        assert self._table is not None
        return view_of(await self._table.ask("join", msg.player))

    @handler
    async def hit(self, msg: Hit, ctx: AppData) -> TableView:
        assert self._table is not None
        return view_of(await self._table.ask("hit"))

    @handler
    async def stand(self, msg: Stand, ctx: AppData) -> TableView:
        assert self._table is not None
        return view_of(await self._table.ask("stand"))


def build_registry() -> Registry:
    return Registry().add_type(Cassino).add_type(GameTable)


# ---------------------------------------------------------------------------
# Demo: open a table, subscribe to it, play a hand
# ---------------------------------------------------------------------------


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
        print(f"[server] cassino node on {await s.bind()}")
        servers.append(s)
    tasks = [asyncio.create_task(s.run()) for s in servers]
    await asyncio.sleep(0.1)

    client = Client(members)
    opened = await client.send(Cassino, "main", OpenTable(seed=7), returns=TableOpened)
    tid = opened.table_id
    print(f"[cassino] table {tid[:8]} opened")

    stream = await client.subscribe(GameTable, tid)

    async def watch() -> None:
        async for update in stream:
            print(
                f"[pubsub] phase={update.phase:<12} player={update.player_cards} "
                f"({update.player_value}) dealer={update.dealer_cards} "
                f"{update.outcome or ''}"
            )
            if update.phase == "settled":
                return

    watcher = asyncio.create_task(watch())
    await asyncio.sleep(0.2)

    view = await client.send(GameTable, tid, Join(player="ada"), returns=TableView)
    print(f"[player] dealt {view.player_cards} = {view.player_value}")
    while view.phase == "player_turn" and view.player_value < 17:
        view = await client.send(GameTable, tid, Hit(), returns=TableView)
        print(f"[player] hit -> {view.player_cards} = {view.player_value}")
    if view.phase == "player_turn":
        view = await client.send(GameTable, tid, Stand(), returns=TableView)
    print(f"[result] {view.outcome}: dealer had {view.dealer_cards}")

    try:
        await asyncio.wait_for(watcher, timeout=5)
    except asyncio.TimeoutError:
        watcher.cancel()

    client.close()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    print("[demo] done")


if __name__ == "__main__":
    asyncio.run(main())
