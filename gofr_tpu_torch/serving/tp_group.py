"""The tensor-parallel engine's group: one leader, its followers, and the
commands between them.

The reference serves a tp-sharded model from one process: its jitted
dispatches compile against the shardings of the param leaves and GSPMD
inserts the collectives. The port is one process a rank
(``parallel/world.py``), so a :class:`~gofr_tpu_torch.serving.engine.ServingEngine`
built with ``mesh=`` runs on the mesh's first rank, the leader, which owns
the scheduler, the loop thread, the detok worker and the app; every other
rank runs :func:`serve_follower`.

For each dispatch the leader broadcasts one command before it launches
its own share: the op, its host ints and the host arrays it uploads (the
prefill's padded tokens and pages, the decode-state admissions, the block
mask and tables, a ragged dispatch's chunk buffers and cursors, a
speculative verify's chunk). A follower replays the same ``serving.batch``
call on its slices, so every rank runs the same collectives in the same
order. Sampling runs on every rank, on logits gathered whole, from
generators seeded alike, so each rank's decode state, K/V writes and
packed output stay equal with no collective of their own; each side keeps
a running hash of the packed blocks (:meth:`TPLeader.digest`, the
follower's result) to show it.

The prefix cache lives on the leader (:class:`PrefixMirror`); each
follower keeps its own slabs of every entry under the leader's key (its
``_PrefixStore``) and changes it only as the leader's commands say: a put
(from the prefill the command carries, or read out of its own KV), a hit
(from host memory it re-uploads), a restore into its KV, a spill to host
memory and an eviction. The leader's cache alone decides, by its own
count of bytes; a follower never evicts by its own. ``restart`` rebuilds
a follower's KV, decode state, generator and store, as the leader's
``warm_restart`` rebuilds its own.

LoRA: the adapter registry stays on the leader, which alone uploads, pins
and evicts; each change of its device tables (``AdapterRegistry.
mirror_tables``) goes to the followers as a post (``lora``) ahead of the
first dispatch that reads the tables it made, and a follower replays it
copy-on-write, as the registry writes its own, so a dispatch already
queued keeps the tables it was given. A decode block's and a ragged
dispatch's delta read each token's whole embedding row out of the
forward's own lookup (``llama.tap_embedding``); a first token sampled on
the leader from a prefix hit, which ran no forward, takes its row from
an ``embed`` command (:func:`embedding_row`), a lookup on every rank.
``restart`` drops a follower's tables and the leader posts the whole
tables again.

KV migration: a cache entry leaves the group whole (``gather``: every
rank's slabs of each key, all-gathered over ``tp`` to the leader in head
order, each KV head once where ranks keep copies) and enters it whole
(:meth:`PrefixMirror.store`: the leader keeps its own KV heads and posts
each follower's ``tp`` index its heads, ``kv_head_slices``). The
engine's thread alone sends, so a fetch from another thread (a peer's
admission, ``/kv/fetch``, a reclaim's harvest) runs on the engine's loop
(``ServingEngine.export_kv``/``import_kv``).

Commands travel over a gloo group of their own (``broadcast_object_list``
of pickled host values), never between a dispatch's tensor collectives.
State updates that launch no collective (:meth:`TPLeader.post`) ride with
the next command. An idle leader sends a keepalive every
:data:`KEEPALIVE_S`, inside the group's timeout.

Failure: a rank that raises in a dispatch destroys its process group, so
every peer's collective fails at once instead of waiting out the timeout.
On the leader that failure, or its own, marks the group broken and raises
:class:`TPGroupError` (a 503): the requests in flight fail, and the engine
takes no more. A follower that raises aborts the same way and
:func:`serve_follower` raises it; no rank waits on a dead peer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from gofr_tpu_torch._device import resolve_device, to_device
from gofr_tpu_torch.errors import ErrorServiceUnavailable
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.parallel.collectives import all_gather
from gofr_tpu_torch.parallel.hostring import abort_all
from gofr_tpu_torch.parallel.mesh import AXIS_ORDER
from gofr_tpu_torch.parallel.sharding import kv_head_slices
from gofr_tpu_torch.serving import batch as batch_ops
from gofr_tpu_torch.serving.kv_cache import PagedKVCache
from gofr_tpu_torch.serving.kv_spill import TieredPrefixCache, _to_device
from gofr_tpu_torch.serving.prefix_cache import _value_bytes

#: seconds an idle leader lets pass before it sends a keepalive
KEEPALIVE_S = 10.0
#: the command group's timeout: a follower waits this long for a command
TIMEOUT_S = 600.0


class TPGroupError(ErrorServiceUnavailable):
    """The tensor-parallel group failed: a rank raised, died or timed out
    in a dispatch. The group is aborted on this rank too (its process
    group destroyed), and the engine serves no more requests."""


def leader_rank(mesh: Any) -> int:
    """The global rank that runs the engine: the mesh's first."""
    return int(mesh.devices.flat[0])


def abort() -> None:
    """Raise the abort flag of this process's host rings and destroy its
    process groups: a peer blocked in a collective with this rank fails at
    once."""
    abort_all()
    if dist.is_initialized():
        with contextlib.suppress(Exception):
            dist.destroy_process_group()


class _Channel:
    """Pickled commands from the leader to every rank of the mesh, over a
    gloo group apart from the model's collectives. Every rank of the
    world constructs it, in the same order (``dist.new_group``)."""

    def __init__(self, mesh: Any, timeout_s: float) -> None:
        ranks = sorted(int(r) for r in mesh.devices.flat)
        self.leader = leader_rank(mesh)
        self.group = dist.new_group(ranks, backend="gloo",
                                    timeout=datetime.timedelta(seconds=timeout_s))

    def send(self, msg: Any) -> None:
        dist.broadcast_object_list([msg], src=self.leader, group=self.group)

    def recv(self) -> Any:
        box = [None]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]


def make_state(host: dict, rng: torch.Generator, device: torch.device) -> batch_ops.DecodeState:
    """A fresh decode state from the leader's host mirrors (the ``state``
    command's ``make``); the leader builds its own through here too."""
    return batch_ops.make_decode_state(
        host["last_token"], host["seq_len"], host["done"], host["budget"], host["stop"],
        host["temperature"], host["top_k"], host["top_p"], rng, host["adapter"], device=device,
    )


def fold_state(state: batch_ops.DecodeState, host: dict,
               device: torch.device) -> batch_ops.DecodeState:
    """Fold prefilled slots into the decode state (the ``state``
    command's ``fold``); the leader folds its own through here too."""

    def up(key: str) -> torch.Tensor:
        return to_device(host[key], device)

    return batch_ops.admit_decode_state(
        state, up("slots"), up("tokens"), up("lens"), up("budgets"), up("stops"), up("temps"),
        up("topks"), up("topps"), up("adapters"),
    )


def embedding_row(cfg: llama.LlamaConfig, params: dict, token: int, mesh: Any,
                  device: torch.device) -> torch.Tensor:
    """The embedding's whole row of ``token`` [D], on every rank of the
    mesh (the ``embed`` command: the vocab-parallel lookup, a sum over
    ``tp``): the LoRA delta's row at a first-token site that ran no
    forward."""
    with llama.tap_embedding() as rows:
        llama._embed(cfg, params, to_device(np.array([token], np.int64), device), mesh)
    return rows[0][0]


def gather_entries(cfg: llama.LlamaConfig, mesh: Any, slabs: list[tuple]) -> list[tuple]:
    """Each entry's (k, v) slabs [L, S, Hkv_local, Dh] of every ``tp`` rank,
    whole [L, S, Hkv, Dh] in head order (the ``gather`` command; every rank
    of the mesh calls it with its own slabs of the same entries, and gets
    them whole). One all-gather over ``tp`` of every entry's K and V side
    by side; where ranks keep copies of a head (fewer KV heads than ``tp``
    ranks) the first rank that keeps it gives it."""
    if not slabs:
        return []
    lens = [k.shape[1] for k, _ in slabs]
    both = torch.stack([torch.cat([k for k, _ in slabs], 1), torch.cat([v for _, v in slabs], 1)])
    got = all_gather(both.contiguous(), mesh, "tp", 3)  # [2, L, sum S, tp * Hkv_local, Dh]
    places = kv_head_slices(cfg.n_heads, cfg.n_kv_heads, mesh.shape["tp"])
    count = places[0][1]
    pick = [next(j * count + h - first for j, (first, n) in enumerate(places)
                 if first <= h < first + n) for h in range(cfg.n_kv_heads)]
    if pick != list(range(got.shape[3])):
        got = got[:, :, :, pick]
    return [(k, v) for k, v in zip(*(part.split(lens, 1) for part in got))]


def slab_digest(k: torch.Tensor, v: torch.Tensor) -> str:
    """A hash of an entry's K and V slabs' bytes (read to the host), to
    hold one rank's slabs of an entry against its heads of the whole."""
    return hashlib.blake2b(b"".join(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()
                                    for t in (k, v)), digest_size=16).hexdigest()


class TPLeader:
    """The leader's end: queues state updates, sends each dispatch's
    command ahead of the leader's own launch, and aborts the group when a
    dispatch fails. The engine thread alone sends, so commands and the
    dispatches' collectives never interleave."""

    def __init__(self, mesh: Any, hello: dict, timeout_s: float = TIMEOUT_S) -> None:
        self.ranks = int(mesh.devices.size)
        self._chan = _Channel(mesh, timeout_s)
        self._queue: list[tuple[str, dict]] = []
        self._last = time.monotonic()
        self._digest = hashlib.blake2b(digest_size=16)
        self.blocks = 0  # packed blocks hashed
        self.broken: BaseException | None = None
        self.closed = False
        self.send("hello", **hello)

    def post(self, op: str, **kw: Any) -> None:
        """Queue a command that launches no collective; it goes out with
        the next :meth:`send`, ahead of that command."""
        self._queue.append((op, kw))

    def send(self, op: str, **kw: Any) -> None:
        if self.broken is not None:
            raise TPGroupError(f"tensor-parallel group lost: {self.broken}",
                               retry_after=1.0) from self.broken
        msgs, self._queue = [*self._queue, (op, kw)], []
        try:
            self._chan.send(msgs)
        except Exception as exc:
            self.fail(exc)
            raise TPGroupError(f"tensor-parallel group lost sending {op}: {exc}",
                               retry_after=1.0) from exc
        self._last = time.monotonic()

    @contextlib.contextmanager
    def step(self, op: str, **kw: Any) -> Any:
        """Send ``op``'s command, then run the leader's share of it: a
        failure inside aborts the group (a peer would otherwise wait in a
        collective this rank never joins) and raises :class:`TPGroupError`."""
        self.send(op, **kw)
        try:
            yield
        except TPGroupError:
            raise
        except Exception as exc:
            self.fail(exc)
            raise TPGroupError(f"tensor-parallel group failed in {op}: {exc}",
                               retry_after=1.0) from exc

    def keepalive(self) -> None:
        """From the idle engine loop: a command within the group's
        timeout, so a follower's wait never expires."""
        if self.broken is None and not self.closed and time.monotonic() - self._last > KEEPALIVE_S:
            self.send("keepalive")

    def record(self, packed: np.ndarray) -> None:
        """Hash a packed block the engine read (in dispatch order)."""
        self._digest.update(np.ascontiguousarray(packed).tobytes())
        self.blocks += 1

    def digest(self) -> str:
        return self._digest.hexdigest()

    def fail(self, exc: BaseException) -> None:
        self.broken = exc
        abort()

    def close(self, unread: list | None = None) -> None:
        """End every follower's loop (once; nothing on a broken group),
        after hashing the packed blocks the engine dispatched and never
        read (``unread``, in dispatch order): the followers hashed them."""
        if self.closed or self.broken is not None:
            return
        self._hash_unread(unread)
        self.closed = True
        with contextlib.suppress(TPGroupError):
            self.send("stop")

    def restart(self, unread: list | None = None) -> None:
        """The leader's ``warm_restart``, once its loop thread joined: hash
        the blocks it never read, drop the updates queued for the state it
        rebuilds, and have every follower rebuild its own (``restart``)."""
        self._hash_unread(unread)
        self._queue = []
        self.send("restart")

    def _hash_unread(self, unread: list | None) -> None:
        for packed in unread or ():
            self.record(packed.cpu().numpy())


def hello_of(cfg: llama.LlamaConfig, conf: Any, seed: int, num_pages: int | None) -> dict:
    """What a follower needs to mirror the leader's engine: the model
    config (checked against its own), the KV layout, the prefix cache's
    and speculative decoding's settings, and the seed."""
    return {"model": repr(cfg), "seed": seed, "num_pages": num_pages,
            "kv": {k: getattr(conf, k) for k in _KV_FIELDS}}


#: the engine settings a follower's own ``engine_config`` must agree on
_KV_FIELDS = ("max_slots", "max_seq_len", "kv_layout", "kv_page_size", "kv_dtype",
              "prefix_cache_entries", "prefix_cache_bytes", "kv_spill_bytes", "spec_tokens")


class PrefixMirror:
    """The leader's prefix cache on a mesh, as its followers hold it: each
    put, hit, spill and eviction of the leader's cache goes to them as a
    post (``prefix``), in the order it happened on the engine thread, and
    a lookup hits only a key the followers hold. The leader's cache alone
    decides, counting each entry at its whole size (this rank's K/V slabs
    times the model's KV heads over this rank's, as the reference counts a
    sharded array), so its
    entries, evictions and stats are the reference's. The host tier evicts
    on its spill worker; those evictions reach the followers once no spill
    is queued (:meth:`_settle`). Entries also leave the group whole
(:meth:`gather`) and enter it whole (:meth:`store`)."""

    def __init__(self, tp: TPLeader, cache: Any, cfg: llama.LlamaConfig, mesh: Any,
                 device: torch.device) -> None:
        self.tp, self.cache, self.cfg, self.mesh, self.device = tp, cache, cfg, mesh, device
        kv_scale = cfg.n_kv_heads // llama.kv_heads(cfg, mesh)
        # the KV heads of each tp index, and the tp indices a follower holds
        self.places = kv_head_slices(cfg.n_heads, cfg.n_kv_heads, mesh.shape["tp"])
        self.follower_tp = {int(i) for i in np.argwhere(mesh.devices != leader_rank(mesh))[
            :, AXIS_ORDER.index("tp")]}
        self.held: dict[Any, str] = {}  # key -> "card" or "host" on the followers

        def whole_bytes(value: Any) -> int:
            logits, k, v = value
            return _value_bytes(logits) + kv_scale * (_value_bytes(k) + _value_bytes(v))

        cache.size_of = whole_bytes
        self.tiered = isinstance(cache, TieredPrefixCache)
        if self.tiered:
            cache.on_spill = self._spilled
        else:
            chained = cache.on_evict

            def evicted(key: Any, value: Any) -> None:
                self._post("evict", key)
                if chained is not None:
                    chained(key, value)

            cache.on_evict = evicted

    def found(self, key: Any, value: Any, tier: str) -> tuple[Any, str]:
        """The leader's lookup of ``key`` came back ``(value, tier)``: a hit
        goes to the followers. An entry they never got (a spill that landed
        after a clear) is evicted here and misses."""
        if value is not None and key not in self.held:
            self.cache.evict(key)
            value, tier = None, "miss"
        if value is not None:
            self.tp.post("prefix", act="hit", key=key)
            self.held[key] = "card"
        self._settle()
        return value, tier

    def put(self, key: Any, value: Any, span: dict | None = None) -> None:
        """The leader's put, after each follower stored its slabs under
        ``key``: from the prefill its command carried, or (``span``: slot,
        start, end and the pages) read out of its own KV by the post sent
        here. An entry the leader did not keep is evicted on the followers."""
        if span is not None:
            self.tp.post("prefix", act="put", key=key, **span)
        if self.cache.put(key, value) is False:
            self._post("evict", key)
        else:
            self.held[key] = "card"
        self._settle()

    def store(self, key: Any, value: tuple) -> tuple:
        """An entry that came in whole (a peer's fetch, a handoff, an
        evacuation's push), on this rank's device: posts each follower's
        ``tp`` index its KV heads of it (``kv_head_slices``), which it keeps
        under ``key`` for the admission's restore or commit, and returns
        the leader's own (its logits whole, its heads' slabs) for the
        engine's put and commit."""
        logits, k, v = value
        self.tp.post("prefix", act="store", key=key, slabs={
            i: tuple(t[:, :, first:first + n].contiguous().cpu() for t in (k, v))
            for i, (first, n) in enumerate(self.places) if i in self.follower_tp})
        first, n = self.places[self.mesh.index("tp")]
        return logits, k[:, :, first:first + n].contiguous(), v[:, :, first:first + n].contiguous()

    def gather(self, keys: list) -> dict:
        """The whole entries of ``keys`` the leader's cache holds and its
        followers hold too (a ``gather`` command): {key: (logits, k, v)},
        each slab [L, S, Hkv, Dh] in head order, the reference's layout.
        Read through ``peek`` where the cache has it (no promotion, no LRU
        touch). Engine thread only: it sends a command."""
        read = getattr(self.cache, "peek", None) or self.cache.get
        found = {}
        for key in keys:
            value = read(key) if key in self.held else None
            if value is not None:
                found[key] = value
        if not found:
            return {}
        with self.tp.step("gather", keys=list(found)):
            whole = gather_entries(self.cfg, self.mesh, [
                _to_device((k, v), self.device) for _, k, v in found.values()])
        return {key: (value[0], k, v) for (key, value), (k, v) in zip(found.items(), whole)}

    def restore(self, slot: int, spans: list) -> None:
        """The chain of cached chunk spans a cursor admitted with, written
        into each follower's KV: ``spans`` of (key, start, pages or None)."""
        self.tp.post("prefix", act="restore", slot=slot, spans=spans)

    def clear(self) -> None:
        self.cache.clear()
        self.held.clear()
        self.tp.post("prefix", act="clear")

    def _post(self, act: str, key: Any) -> None:
        self.held.pop(key, None)
        self.tp.post("prefix", act=act, key=key)

    def _spilled(self, key: Any) -> None:
        """A device-tier eviction on its way to the host tier: the
        followers copy their slabs to host memory too."""
        if key in self.held:
            self.held[key] = "host"
            self.tp.post("prefix", act="spill", key=key)

    def _settle(self) -> None:
        """Once no spill is queued, drop on the followers every host copy
        the leader's tier no longer has (evicted by its byte count, or a
        spill that failed or found the queue full)."""
        if not self.tiered or self.cache.spilling:
            return
        resident = set(self.cache.keys())
        for key in [k for k, tier in self.held.items() if tier == "host" and k not in resident]:
            self._post("evict", key)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A spilled slab in host memory: from the card into pinned memory,
    asynchronously (its re-upload is queued on the same stream after it)."""
    if t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
    return t.to("cpu", copy=True)


class _PrefixStore:
    """A follower's prefix entries: this rank's K/V slabs under the
    leader's cache keys, on the card or spilled to host memory. It holds
    what the leader's commands put there and drops what they name.

    A hit also keeps its slabs in ``taken`` until the admission reads them
    (:meth:`take`): within one chunk walk, a later hit's re-upload can
    spill or evict an entry the walk already hit, before the restore."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.card: dict[Any, tuple] = {}
        self.host: dict[Any, tuple] = {}
        self.taken: dict[Any, tuple] = {}

    def slabs(self, key: Any) -> tuple:
        """An entry's slabs where they are, on the card or in host memory
        (a gather reads them, promoting nothing)."""
        return self.card[key] if key in self.card else self.host[key]

    def take(self, keys: list) -> list[tuple]:
        """The slabs of an admission's hits, as they were at each hit; the
        hits of an admission that read none (a requeue) go with them."""
        slabs = [self.taken[k] for k in keys]
        self.taken.clear()
        return slabs

    def apply(self, act: str, key: Any) -> None:
        if act == "hit":
            if key not in self.card:  # a host-tier hit: the re-upload
                self.card[key] = _to_device(self.host.pop(key), self.device)
            self.taken[key] = self.card[key]
        elif act == "spill":
            slabs = self.card.pop(key, None)
            if slabs is not None:
                self.host[key] = tuple(_host_copy(t) for t in slabs)
        elif act == "evict":
            self.card.pop(key, None)
            self.host.pop(key, None)
        elif act == "clear":
            self.card.clear()
            self.host.clear()
            self.taken.clear()
        else:
            raise ValueError(f"unknown prefix store action {act!r}")


class _Follower:
    """A follower's mirror of the leader's device state: its KV storage
    (this rank's KV heads: the dense cache or the paged pools, the other
    None), the decode state and its generator. Each op dispatches through
    the same ``serving.batch`` function as the leader's engine."""

    def __init__(self, cfg: llama.LlamaConfig, params: dict, mesh: Any, device: torch.device,
                 hello: dict) -> None:
        self.cfg, self.params, self.mesh, self.device = cfg, params, mesh, device
        self.hello = hello
        self.dense: llama.KVCache | None = None
        self.pc: PagedKVCache | None = None
        self.state: batch_ops.DecodeState | None = None
        self._init_state()
        self.digest = hashlib.blake2b(digest_size=16)
        self.blocks = 0
        # a hash of this rank's slabs of each entry that came in whole
        self.imported: dict[Any, str] = {}

    def _init_state(self) -> None:
        """The KV storage, the decode state, its generator and the prefix
        store, as the leader's ``_init_runtime_state`` builds its own: at
        the hello and at each ``restart``. The old KV is released before
        the new is allocated."""
        cfg, device, mesh, hello = self.cfg, self.device, self.mesh, self.hello
        kv = hello["kv"]
        if self.pc is not None:
            self.pc.close()
        self.dense = self.pc = self.state = None
        self.lora: tuple[torch.Tensor, torch.Tensor] | None = None  # the adapter tables
        self.store = _PrefixStore(device)
        if kv["kv_layout"] == "paged":
            self.pc = PagedKVCache(
                cfg, num_pages=hello["num_pages"], page_size=kv["kv_page_size"],
                max_slots=kv["max_slots"], max_seq_len=kv["max_seq_len"], device=device,
                kv_dtype=kv["kv_dtype"], mesh=mesh,
            )
        else:
            self.dense = llama.KVCache.create(cfg, kv["max_slots"], max_len=kv["max_seq_len"],
                                              kv_dtype=kv["kv_dtype"], device=device, mesh=mesh)
        self.rng = torch.Generator(device=device).manual_seed(hello["seed"])

    def up(self, a: Any) -> torch.Tensor | None:
        return None if a is None else to_device(np.asarray(a), self.device)

    def apply(self, op: str, kw: dict) -> None:
        if op == "state":
            if "make" in kw:
                self.state = make_state(kw["make"], self.rng, self.device)
            else:
                self.state = fold_state(self.state, kw["fold"], self.device)
        elif op == "prefill":
            self.prefill(**kw)
        elif op == "prefix":
            self.prefix(**kw)
        elif op == "lora":
            self.lora_change(**kw)
        elif op == "embed":
            embedding_row(self.cfg, self.params, kw["token"], self.mesh, self.device)
        elif op == "gather":
            gather_entries(self.cfg, self.mesh, [
                _to_device(self.store.slabs(key), self.device) for key in kw["keys"]])
        elif op in ("decode", "ragged", "verify"):
            packed = getattr(self, op)(**kw)
            self.digest.update(packed.cpu().numpy().tobytes())
            self.blocks += 1
        elif op == "restart":
            self._init_state()
        elif op != "keepalive":
            raise ValueError(f"unknown tensor-parallel command {op!r}")

    def prefill(self, tokens: np.ndarray | None, length: int, slot: int, pages: Any,
                key: Any = None) -> None:
        """A prompt's slabs into its slot: computed, and stored under the
        leader's cache ``key`` when it has one; or, on the leader's prefix
        hit (no ``tokens``), this rank's own slabs of that entry."""
        if tokens is None:
            [(k_slab, v_slab)] = self.store.take([key])
        else:
            _, k_slab, v_slab = batch_ops.prefill_compute(
                self.cfg, self.params, self.up(tokens), self.up(np.array([length], np.int32)),
                mesh=self.mesh,
            )
            if key is not None:
                self.store.card[key] = (k_slab, v_slab)
        self.dense = batch_ops.commit_prefill(self.dense, self.pc, k_slab, v_slab, slot, pages)

    def lora_change(self, shape: tuple, slot: int | None, a: Any, b: Any) -> None:
        """One change of the leader's adapter tables, replayed
        (``AdapterRegistry._record_locked``): tables of ``shape`` (made, or
        the old ones zero-padded to the grown rank), then ``a``/``b``
        written into ``slot`` (the whole tables when ``slot`` is None). A
        change builds new tensors: a dispatch queued before it keeps the
        tables it was given."""
        n, d, r, v = shape
        tabs = self.lora
        if tabs is None or tuple(tabs[0].shape) != (n, d, r):
            a_tab = torch.zeros((n, d, r), dtype=torch.float32, device=self.device)
            b_tab = torch.zeros((n, r, v), dtype=torch.float32, device=self.device)
            if tabs is not None:
                a_tab[:, :, :tabs[0].shape[2]] = tabs[0]
                b_tab[:, :tabs[1].shape[1]] = tabs[1]
            tabs = (a_tab, b_tab)
        if a is not None:
            if slot is None:
                tabs = (self.up(a), self.up(b))
            else:
                tabs = (tabs[0].clone(), tabs[1].clone())
                tabs[0][slot] = self.up(a)
                tabs[1][slot] = self.up(b)
        self.lora = tabs

    def prefix(self, act: str, key: Any = None, slot: int = 0, start: int = 0, end: int = 0,
               pages: Any = None, spans: list | None = None, slabs: dict | None = None) -> None:
        """The leader's prefix cache, on this rank's slabs: ``put`` reads
        tokens [start, end) of ``slot`` out of this rank's KV (``pages``
        on the paged layout) under ``key``; ``store`` keeps this rank's
        heads of an entry that came in whole (``slabs`` by ``tp`` index)
        under ``key``, for the admission that reads it; ``restore`` writes
        each of ``spans`` (key, start, pages) into ``slot``; the rest are
        the store's own (:class:`_PrefixStore`)."""
        if act == "store":
            k_slab, v_slab = slabs[self.mesh.index("tp")]
            self.imported[key] = slab_digest(k_slab, v_slab)
            self.store.card[key] = self.store.taken[key] = _to_device((k_slab, v_slab),
                                                                      self.device)
        elif act == "put":
            if self.pc is not None:
                slabs = self.pc.read_pages(pages, end - start)
            else:
                slabs = (self.dense.k[:, slot, start:end].clone(),
                         self.dense.v[:, slot, start:end].clone())
            self.store.card[key] = slabs
        elif act == "restore":
            slabs = self.store.take([span_key for span_key, _, _ in spans])
            for (_, span_start, span_pages), (k_slab, v_slab) in zip(spans, slabs):
                if self.pc is not None:
                    self.pc.write_pages(span_pages, k_slab, v_slab)
                else:
                    self.dense.k, self.dense.v = batch_ops.insert_chunk(
                        self.dense.k, self.dense.v, k_slab, v_slab, slot, span_start)
        else:
            self.store.apply(act, key)

    def verify(self, tables: Any, chunk: np.ndarray, start: np.ndarray, mask: Any, cap: Any,
               temps: np.ndarray, topks: np.ndarray, topps: np.ndarray) -> torch.Tensor:
        up = self.up
        packed, dense = batch_ops.dispatch_verify(
            self.cfg, self.params, self.dense, self.pc, up(tables), up(chunk), up(start), up(mask),
            up(cap), up(temps), up(topks), up(topps), self.rng, mesh=self.mesh)
        if dense is not None:
            self.dense = dense
        return packed

    def decode(self, mask: np.ndarray, tables: Any, steps: int, lora: bool) -> torch.Tensor:
        packed, self.dense, self.state = batch_ops.dispatch_decode(
            self.cfg, self.params, self.dense, self.pc, self.state, self.up(tables),
            self.up(mask), steps, self.lora if lora else None, mesh=self.mesh)
        return packed

    def ragged(self, tables: Any, chunk: np.ndarray, start: np.ndarray, rows: np.ndarray,
               kvcap: Any, finish: np.ndarray, new_len: np.ndarray, budgets: np.ndarray,
               stops: np.ndarray, temps: np.ndarray, topks: np.ndarray, topps: np.ndarray,
               seeds: list, mask: np.ndarray, steps: int, adapters: Any) -> torch.Tensor:
        """``adapters`` (the chunk rows' adapter slots) comes with the
        leader's tables only: None for a dispatch that read none."""
        up = self.up
        packed, _, self.dense, self.state = batch_ops.dispatch_ragged(
            self.cfg, self.params, self.dense, self.pc, self.state, up(tables), up(chunk),
            up(start), up(rows), up(kvcap), up(finish), up(new_len), up(budgets), up(stops),
            up(temps), up(topks), up(topps), seeds, up(mask), steps, up(adapters),
            None if adapters is None else self.lora, mesh=self.mesh)
        return packed


@dataclasses.dataclass
class FollowerResult:
    """What :func:`serve_follower` returns: the packed blocks it ran, their
    running hash (equal to the leader's :meth:`TPLeader.digest` when no
    dispatch failed), the commands it took and the keys its prefix store
    held at the end, on the card and in host memory, and a hash of this
    rank's slabs of each entry that came in whole (``store``), by key, and
    with ``digests=True`` of each entry its store holds at the end."""

    rank: int
    blocks: int
    digest: str
    commands: int
    prefix_card: list = dataclasses.field(default_factory=list)
    prefix_host: list = dataclasses.field(default_factory=list)
    imported: dict = dataclasses.field(default_factory=dict)
    slabs: dict = dataclasses.field(default_factory=dict)


def serve_follower(
    cfg: llama.LlamaConfig,
    params: dict,
    engine_config: Any = None,
    *,
    mesh: Any,
    device: str | torch.device | None = None,
    timeout_s: float = TIMEOUT_S,
    digests: bool = False,
) -> FollowerResult:
    """Serve this rank's share of the tensor-parallel engine that the
    mesh's leader runs (``ServingEngine(..., mesh=mesh)``), until that
    engine stops. ``params`` is this rank's slice (``shard_params``,
    ``init_params(mesh=)``, ``restore(sharding=)``). The KV layout, the
    prefix cache's and speculative decoding's settings and the seed come
    from the leader; an ``engine_config`` given here must agree with the
    leader's on them. Every rank of the world calls it (or builds
    the leader's engine) at the same point: the command group is made
    collectively. A command that raises here aborts the group, so the
    leader's dispatch fails instead of hanging, and raises
    :class:`TPGroupError` from it."""
    dev = resolve_device(device)
    me = dist.get_rank()
    if me == leader_rank(mesh):
        raise ValueError("the mesh's first rank runs the engine (ServingEngine(..., mesh=)), "
                         "not serve_follower")
    chan = _Channel(mesh, timeout_s)
    follower: _Follower | None = None
    commands = 0
    try:
        while True:
            msgs = chan.recv()
            for op, kw in msgs:
                commands += 1
                if op == "stop":
                    store = follower.store
                    held = ({k: slab_digest(*store.slabs(k)) for k in (*store.card, *store.host)}
                            if digests else {})
                    return FollowerResult(me, follower.blocks, follower.digest.hexdigest(),
                                          commands, sorted(store.card), sorted(store.host),
                                          follower.imported, held)
                if op == "hello":
                    _check_hello(cfg, engine_config, kw)
                    follower = _Follower(cfg, params, mesh, dev, kw)
                else:
                    follower.apply(op, kw)
    except Exception as exc:
        abort()  # first: the leader's dispatch fails now, not at its timeout
        raise TPGroupError(f"tensor-parallel follower rank {me} failed: {exc}") from exc


def _check_hello(cfg: llama.LlamaConfig, engine_config: Any, hello: dict) -> None:
    if hello["model"] != repr(cfg):
        raise ValueError(f"the leader serves {hello['model']}, this rank holds {cfg!r}")
    if engine_config is not None:
        mine = {k: getattr(engine_config, k) for k in _KV_FIELDS}
        if mine != hello["kv"]:
            raise ValueError(f"the leader's engine settings {hello['kv']} are not this rank's "
                             f"{mine}")
