"""The port's copy of the HA plane's primitives
(``gofr_tpu_torch/serving/dedup.py``) against the reference's
(``gofr_tpu/serving/dedup.py``): the cases of the reference's
``tests/test_dedup.py``, each run on both modules, then seeded sequences of
``claim``, ``lookup``, ``settle``, ``forget`` on the registry and of
frames, ``attach``, ``subscribe``, ``release`` and ``detach`` on the
replay rings, with every observation compared step by step."""

import types

import numpy as np
import pytest

from gofr_tpu.serving import dedup as jdedup
from gofr_tpu.serving.engine import ServingEngine as JServingEngine
from gofr_tpu_torch.serving import dedup as tdedup
from gofr_tpu_torch.serving.engine import ServingEngine as TServingEngine

MODULES = pytest.mark.parametrize("mod", [jdedup, tdedup], ids=["reference", "port"])
ENGINES = pytest.mark.parametrize("engine_cls", [JServingEngine, TServingEngine],
                                  ids=["reference", "port"])


def _feed(ring, pieces, *, done=False):
    """Drive the owner's wire: token frames (ids 100, 101, ...) and
    optionally the terminal frame."""
    cb = ring.wrap(None)
    for i, piece in enumerate(pieces):
        cb(100 + i, piece, False)
    if done:
        cb(-1, "", True)
    return cb


# -- subscriber leases ---------------------------------------------------------
@MODULES
def test_wrap_counts_the_owner_as_a_live_subscriber(mod):
    ring = mod.ReplayStream(8)
    assert ring.subscribers == 0
    ring.wrap(None)
    assert ring.subscribers == 1


@MODULES
def test_attach_and_subscribe_take_leases_release_drops_them(mod):
    ring = mod.ReplayStream(8)
    _feed(ring, ["a", "b"])
    assert ring.subscribers == 1
    ring.attach(0, lambda *a: None)
    assert ring.subscribers == 2
    ring.subscribe(lambda *a: None)
    assert ring.subscribers == 3
    assert [ring.release() for _ in range(4)] == [2, 1, 0, 0]


@MODULES
def test_duplicate_release_leaves_owner_lease_intact(mod):
    ring = mod.ReplayStream(8)
    _feed(ring, ["a", "b", "c"])
    ring.attach(0, lambda *a: None)
    assert ring.release() == 1 and ring.subscribers == 1


@MODULES
def test_replay_gap_raises_before_taking_a_lease(mod):
    ring = mod.ReplayStream(2)
    _feed(ring, ["a", "b", "c", "d"])
    with pytest.raises(mod.ReplayGap):
        ring.attach(0, lambda *a: None)
    assert ring.subscribers == 1 and ring.attaches == 0


# -- truncated live-subscribe --------------------------------------------------
@MODULES
def test_subscribe_skips_replay_and_reports_true_base_seq(mod):
    ring = mod.ReplayStream(2)
    cb = _feed(ring, ["a", "b", "c", "d"])
    got = []
    base = ring.subscribe(lambda s, t, p, d: got.append((s, t, p, d)))
    assert base == 4 and got == []
    cb(104, "e", False)
    cb(-1, "", True)
    assert got == [(5, 104, "e", False), (6, -1, "", True)]


@MODULES
def test_subscribe_on_finished_stream_delivers_only_the_terminal(mod):
    ring = mod.ReplayStream(4)
    _feed(ring, ["a", "b"], done=True)
    got = []
    base = ring.subscribe(lambda s, t, p, d: got.append((s, t, p, d)))
    assert got == [(3, -1, "", True)] and base == 2


@MODULES
def test_done_frame_is_idempotent_across_settlement_paths(mod):
    ring = mod.ReplayStream(4)
    got = []
    cb = ring.wrap(lambda t, p, d: got.append((t, p, d)))
    cb(100, "a", False)
    cb(-1, "", True)
    cb(-1, "", True)
    assert ring.last_seq == 2
    replayed = []
    ring.attach(0, lambda s, t, p, d: replayed.append((s, t, p, d)))
    assert replayed == [(1, 100, "a", False), (2, -1, "", True)]


@MODULES
def test_ring_retains_every_emitted_piece_beyond_the_window(mod):
    ring = mod.ReplayStream(2)
    _feed(ring, ["th", "e", " cat"], done=True)
    assert ring.pieces == ["th", "e", " cat"]


# -- text-identical terminal replay (the engines' _replay_result) --------------
class _RedecodingTokenizer:
    """A per-token decode that does NOT reproduce the incremental pieces."""

    def decode(self, ids):
        return "<redecoded>"


def _terminal_entry(mod, pieces, token_ids):
    entry = mod.DedupEntry("k")
    entry.rid = 7
    entry.terminal = True
    entry.result = types.SimpleNamespace(token_ids=token_ids)
    if pieces is not None:
        entry.replay = mod.ReplayStream(2)
        _feed(entry.replay, pieces, done=True)
    return entry


@pytest.mark.parametrize("mod,engine_cls", [(jdedup, JServingEngine), (tdedup, TServingEngine)],
                         ids=["reference", "port"])
def test_terminal_replay_is_text_identical_to_the_original_stream(mod, engine_cls):
    entry = _terminal_entry(mod, ["th", "e", " cat"], [100, 101, 102])
    fake = types.SimpleNamespace(tokenizer=_RedecodingTokenizer())
    frames = []
    engine_cls._replay_result(fake, entry, 0, lambda *f: frames.append(f))
    assert frames == [(1, 100, "th", False), (2, 101, "e", False), (3, 102, " cat", False),
                      (4, -1, "", True)]
    tail = []
    engine_cls._replay_result(fake, entry, 2, lambda *f: tail.append(f))
    assert tail == [(3, 102, " cat", False), (4, -1, "", True)]


@pytest.mark.parametrize("mod,engine_cls", [(jdedup, JServingEngine), (tdedup, TServingEngine)],
                         ids=["reference", "port"])
def test_terminal_replay_falls_back_to_decode_without_retained_pieces(mod, engine_cls):
    entry = _terminal_entry(mod, None, [100, 101])
    fake = types.SimpleNamespace(tokenizer=_RedecodingTokenizer())
    frames = []
    engine_cls._replay_result(fake, entry, 0, lambda *f: frames.append(f))
    assert [f[2] for f in frames[:-1]] == ["<redecoded>", "<redecoded>"]
    assert frames[-1] == (3, -1, "", True)


# -- registry claim-window hygiene ---------------------------------------------
@MODULES
def test_forget_wakes_waiting_duplicates_with_a_dead_entry(mod):
    reg = mod.DedupRegistry(4)
    owner, entry = reg.claim("k")
    dup_owner, dup_entry = reg.claim("k")
    assert owner and not dup_owner and dup_entry is entry and not entry.ready.is_set()
    reg.forget("k")
    assert entry.ready.is_set() and entry.future is None and not entry.terminal
    assert reg.stats()["live"] == 0
    fresh_owner, fresh_entry = reg.claim("k")
    assert fresh_owner and fresh_entry is not entry


# -- seeded op sequences, state compared step by step --------------------------
KEYS = [f"k{i}" for i in range(5)]


def _trace(mod, seed: int, steps: int = 120) -> list:
    """Drive one registry (capacity 3) and the replay rings (capacity 4) of
    the keys it hands out with a seeded op sequence; return every
    observation: each op's outcome, the frames each subscriber got, the
    registry's stats and each ring's counters after every step."""
    rng = np.random.default_rng(seed)
    reg = mod.DedupRegistry(3)
    rings: dict[str, tuple] = {}  # key -> (ring, owner wire, [received frames])
    subs: list[tuple[str, list, object]] = []  # (key, frames, callback)
    out = []
    for step in range(steps):
        op = rng.choice(["claim", "claim", "lookup", "frame", "frame", "frame", "done", "settle",
                         "forget", "attach", "subscribe", "release", "detach"])
        key = KEYS[int(rng.integers(len(KEYS)))]
        ring = rings.get(key)
        if op == "claim":
            owner, entry = reg.claim(key)
            res = (owner, entry.terminal, entry.ready.is_set())
            if owner:
                ring = mod.ReplayStream(4)
                got = []
                wire = ring.wrap(lambda t, p, d, _g=got: _g.append((t, p, d)))
                entry.publish(step, None, ring)
                rings[key] = (ring, wire, got)
        elif op == "lookup":
            entry = reg.lookup(key)
            res = None if entry is None else (entry.terminal, entry.rid)
        elif op == "frame" and ring is not None:
            tok = int(rng.integers(1000))
            ring[1](tok, f"p{tok}", False)
            res = ring[0].last_seq
        elif op == "done" and ring is not None:
            ring[1](-1, "", True)
            res = (ring[0].last_seq, ring[0].done)
        elif op == "settle":
            reg.settle(key, ("result", step))
            entry = reg.lookup(key)
            res = None if entry is None else (entry.terminal, entry.result)
        elif op == "forget":
            reg.forget(key)
            rings.pop(key, None)
            res = "forgot"
        elif op == "attach" and ring is not None:
            last = int(rng.integers(ring[0].last_seq + 2))
            frames = []

            def cb(s, t, p, d, _f=frames):
                _f.append((s, t, p, d))

            try:
                ring[0].attach(last, cb)
                subs.append((key, frames, cb))
                res = ("attached", last, list(frames))
            except mod.ReplayGap:
                res = ("gap", last)
        elif op == "subscribe" and ring is not None:
            frames = []

            def cb(s, t, p, d, _f=frames):
                _f.append((s, t, p, d))

            base = ring[0].subscribe(cb)
            subs.append((key, frames, cb))
            res = ("subscribed", base, list(frames))
        elif op == "release" and ring is not None:
            res = ring[0].release()
        elif op == "detach" and subs:
            k, frames, cb = subs.pop(int(rng.integers(len(subs))))
            if k in rings:
                rings[k][0].detach(cb)
            res = ("detached", k)
        else:
            res = "noop"
        out.append((step, str(op), key, res, reg.stats(),
                    {k: (r.last_seq, r.subscribers, r.attaches, r.done, list(r.pieces), list(g))
                     for k, (r, _w, g) in sorted(rings.items())},
                    [(k, list(f)) for k, f, _ in subs]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_seeded_ops_match_reference(seed):
    ref, port = _trace(jdedup, seed), _trace(tdedup, seed)
    for want, got in zip(ref, port):
        assert got == want, want[:3]
    ops = {row[1] for row in ref if row[3] != "noop"}
    assert {"claim", "settle", "forget", "attach", "subscribe", "release"} <= ops
