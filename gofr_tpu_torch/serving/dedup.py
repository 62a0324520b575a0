"""Exactly-once client retries: idempotency-keyed dedup and resumable
streams (a copy of ``gofr_tpu/serving/dedup.py``, stdlib only; the port
imports nothing of the JAX package).

Two pieces, both on the replica: the engine, not a router's memory, is the
authority, which lets two routers share one replica fleet without serving
a request twice.

``ReplayStream``
    A bounded per-request ring of emitted frames, fed from the engine's
    one detok worker through ``wrap()``, so every frame carries a dense
    sequence number (tokens ``1..N``, the terminal ``N+1``) in emission
    order. ``attach(last_seq, sub)`` replays the suffix the caller has not
    acknowledged and subscribes it to the live continuation under one
    lock, so a client that re-attaches neither misses a frame nor gets one
    twice. The ring is bounded (``TPU_STREAM_REPLAY_TOKENS``); a caller
    whose ``last_seq`` fell behind the window gets ``ReplayGap``: a
    token-identical resume is impossible, and the engine reports a typed
    error instead of generating again (a request that streamed tokens is
    never re-run). A duplicate submit that hits the gap ``subscribe()``s
    live instead (a truncated stream, the full result through the shared
    future): a keyed retry must dedup, never fail. ``subscribers`` counts
    every live attachment (owner, duplicates, resumes); the orphan
    reaper cancels only when it reaches zero.

``DedupRegistry``
    A bounded, thread-safe ``Idempotency-Key -> entry`` map. Live entries
    are bounded by the requests in flight; terminal entries are an LRU of
    ``TPU_IDEM_CAPACITY``. Only successful terminals are kept for replay:
    an exception terminal forgets the key, so a client's retry runs again.
    ``claim()`` is the atomic check-and-register: one concurrent submit per
    key becomes the owner and dispatches, every other attaches to the
    owner's future. Duplicates never make a request, never touch the
    scheduler and never settle a future, so each key gets one terminal
    mark.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable

# (seq, token_id, piece, done) — the resumable-wire frame shape.
FrameSub = Callable[[int, int, str, bool], None]

DEFAULT_REPLAY_TOKENS = 512
DEFAULT_KEY_CAPACITY = 1024


class ReplayGap(Exception):
    """The frames between the caller's ``last_seq`` and the ring's oldest
    retained frame were evicted by the bound: the acked-but-unseen suffix
    cannot be replayed token-identically."""


class ReplayStream:
    """Bounded, seq-numbered ring of a request's emitted frames.

    Fed from exactly one thread (the engine's single-worker detok
    executor preserves per-request frame order); read from any thread
    via ``attach``. Terminal frames are idempotent: the engine can fire
    the done frame from more than one settlement path, but only the
    first consumes a sequence number.
    """

    def __init__(self, capacity: int = DEFAULT_REPLAY_TOKENS) -> None:
        self._mu = threading.Lock()
        self._frames: collections.deque[tuple[int, int, str]] = collections.deque(
            maxlen=max(int(capacity), 1)
        )
        self._next_seq = 1
        self._done = False
        self._done_seq: int | None = None
        self._subs: list[FrameSub] = []
        self.attaches = 0  # re-attach generation counter (orphan-grace reaper reads it)
        # live attached connections: the owner plus every duplicate/resume
        # attachment. Incremented on wrap/attach/subscribe, decremented by
        # ``release()`` when a transport reports its client gone — the
        # orphan-grace reaper must not cancel while ANY of them remains
        # (one client's disconnect must never kill another client's
        # in-flight generation). Drift can only be upward (an attachment
        # that completes normally never releases), which errs toward
        # not canceling.
        self.subscribers = 0
        # the authoritative record of what the stream actually emitted:
        # every token frame's piece, in seq order (seq i+1 -> pieces[i]).
        # Bounded by the request's own max_new_tokens — the same order of
        # memory as the final text the terminal LRU already retains — so
        # a terminal replay is TEXT-identical to the original stream, not
        # merely token-identical.
        self.pieces: list[str] = []

    def wrap(self, cb: Callable[[int, str, bool], None] | None) -> Callable[[int, str, bool], None]:
        """Return a 3-arg ``stream_cb`` that stamps, stores, and fans out.

        Installed as the request's ``stream_cb`` so ALL engine emission
        paths (detok token frames and every done-frame settlement path)
        flow through the ring; the original client callback, when given,
        still sees the plain ``(token_id, piece, done)`` wire. The owner
        counts as one live subscriber from here (streaming or awaiting
        the future) until its transport ``release()``s it.
        """
        with self._mu:
            self.subscribers += 1

        def fanout(token_id: int, piece: str, done: bool) -> None:
            with self._mu:
                if done:
                    if self._done:  # second settlement path; frame already recorded
                        return
                    self._done = True
                    self._done_seq = self._next_seq
                    seq = self._next_seq
                else:
                    seq = self._next_seq
                    self._frames.append((seq, token_id, piece))
                    self.pieces.append(piece)
                self._next_seq += 1
                subs = list(self._subs)
            for sub in subs:
                try:
                    sub(seq, token_id, piece, done)
                except Exception:  # noqa: BLE001 - a dead subscriber must not hurt the stream
                    pass
            if cb is not None:
                cb(token_id, piece, done)

        return fanout

    def attach(self, last_seq: int, sub: FrameSub) -> None:
        """Replay frames with ``seq > last_seq``, then subscribe live.

        Replay and subscription happen under the ring lock, so no frame
        emitted concurrently can be missed or delivered twice. Raises
        ``ReplayGap`` when the suffix was evicted (or ``last_seq`` claims
        frames this stream never emitted).
        """
        last_seq = int(last_seq)
        with self._mu:
            if last_seq >= self._next_seq:
                raise ReplayGap(
                    f"last_seq {last_seq} is ahead of the stream (next seq {self._next_seq})"
                )
            oldest = self._frames[0][0] if self._frames else self._next_seq
            if last_seq + 1 < oldest and not (
                self._done and self._done_seq is not None and self._done_seq <= last_seq + 1
            ):
                raise ReplayGap(
                    f"frames {last_seq + 1}..{oldest - 1} were evicted from the replay window"
                )
            self.attaches += 1
            self.subscribers += 1
            for seq, token_id, piece in self._frames:
                if seq > last_seq:
                    sub(seq, token_id, piece, False)
            if self._done:
                if self._done_seq is not None and self._done_seq > last_seq:
                    sub(self._done_seq, -1, "", True)
            else:
                self._subs.append(sub)

    def subscribe(self, sub: FrameSub) -> int:
        """Attach live with NO replay: the subscriber accepts a truncated
        stream starting at the next emitted frame.

        The submit-path fallback for a duplicate whose suffix fell out of
        the bounded window (a token-identical replay is impossible, but
        the keyed-submit contract is "dedup safely", never a hard error):
        the caller's future still resolves with the FULL result; only the
        stream is truncated. Returns the seq BEFORE the first frame the
        subscriber will receive, so transports can stamp true ``id:``
        lines. A finished stream delivers just its terminal frame.
        """
        with self._mu:
            self.attaches += 1
            self.subscribers += 1
            if self._done:
                done_seq = self._done_seq if self._done_seq is not None else self._next_seq
                sub(done_seq, -1, "", True)
                return done_seq - 1
            self._subs.append(sub)
            return self._next_seq - 1

    def release(self) -> int:
        """One attached transport's client is gone (disconnect → orphan):
        drop its live-subscriber count. Returns the remaining count the
        orphan-grace reaper gates on. Floored at zero — an unbalanced
        release must not go negative and steal another client's slot."""
        with self._mu:
            self.subscribers = max(0, self.subscribers - 1)
            return self.subscribers

    def detach(self, sub: FrameSub) -> None:
        with self._mu:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    @property
    def last_seq(self) -> int:
        with self._mu:
            return self._next_seq - 1

    @property
    def done(self) -> bool:
        with self._mu:
            return self._done


class DedupEntry:
    """One idempotency key's state: live (owner dispatched, duplicates
    attach to ``future``/``replay``) or terminal (``result`` replayable).

    ``ready`` closes the claim-to-publish window: a duplicate that wins
    the race between the owner's claim and its admission completing
    waits on ``ready`` instead of spinning or double-dispatching.
    """

    __slots__ = ("key", "rid", "future", "replay", "result", "terminal", "ready")

    def __init__(self, key: str) -> None:
        self.key = key
        self.rid: int | None = None
        self.future: Any = None
        self.replay: ReplayStream | None = None
        self.result: Any = None
        self.terminal = False
        self.ready = threading.Event()

    def publish(self, rid: int, future: Any, replay: ReplayStream) -> None:
        self.rid = rid
        self.future = future
        self.replay = replay
        self.ready.set()


class DedupRegistry:
    """Bounded key -> entry map; the replica-side exactly-once authority."""

    def __init__(self, capacity: int = DEFAULT_KEY_CAPACITY) -> None:
        self._mu = threading.Lock()
        self._live: dict[str, DedupEntry] = {}
        self._terminal: collections.OrderedDict[str, DedupEntry] = collections.OrderedDict()
        self.capacity = max(int(capacity), 1)
        self.hits_live = 0
        self.hits_terminal = 0
        self.evicted = 0

    def claim(self, key: str) -> tuple[bool, DedupEntry]:
        """Atomic check-and-register. ``(True, entry)``: caller is the
        owner and must ``publish`` (or the engine's terminal path must
        ``forget``) the entry. ``(False, entry)``: duplicate — attach."""
        with self._mu:
            entry = self._live.get(key)
            if entry is None:
                entry = self._terminal.get(key)
                if entry is not None:
                    self._terminal.move_to_end(key)
            if entry is not None:
                if entry.terminal:
                    self.hits_terminal += 1
                else:
                    self.hits_live += 1
                return False, entry
            entry = DedupEntry(key)
            self._live[key] = entry
            return True, entry

    def lookup(self, key: str) -> DedupEntry | None:
        """Read-only fast path (no claim): the pre-admission duplicate
        check, and the resume wire's registry crossing."""
        with self._mu:
            entry = self._live.get(key)
            if entry is not None:
                self.hits_live += 1
                return entry
            entry = self._terminal.get(key)
            if entry is not None:
                self._terminal.move_to_end(key)
                self.hits_terminal += 1
            return entry

    def settle(self, key: str, result: Any) -> None:
        """Record a *successful* terminal for replay (LRU-bounded)."""
        with self._mu:
            entry = self._live.pop(key, None)
            if entry is None:
                return
            entry.result = result
            entry.terminal = True
            entry.ready.set()
            self._terminal[key] = entry
            self._terminal.move_to_end(key)
            while len(self._terminal) > self.capacity:
                self._terminal.popitem(last=False)
                self.evicted += 1

    def forget(self, key: str) -> None:
        """Drop a key entirely (exception terminal, failed admission):
        the next submit with this key re-runs as a fresh request."""
        with self._mu:
            entry = self._live.pop(key, None)
            self._terminal.pop(key, None)
        if entry is not None:
            entry.ready.set()  # wake waiting duplicates; they see a dead entry

    def stats(self) -> dict[str, int]:
        with self._mu:
            return {
                "live": len(self._live),
                "terminal": len(self._terminal),
                "hits_live": self.hits_live,
                "hits_terminal": self.hits_terminal,
                "evicted": self.evicted,
            }
