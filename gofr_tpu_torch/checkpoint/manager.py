"""CheckpointManager: versioned, transactional checkpoints of tensor trees
(port of ``gofr_tpu/checkpoint/manager.py``, npz backend).

Layout, the reference's::

    <dir>/MANIFEST.json            {"steps": [{"step", "ts", "backend",
                                    "metadata"}...]}
    <dir>/step_000000042/          weights.npz + tree.json

``weights.npz`` holds ``leaf_{i}`` in ``jax.tree``'s leaf order (a dict's
keys sorted); ``tree.json`` holds the structure string ``jax.tree``
prints, the leaf count and each leaf's dtype name. A bf16 leaf is stored
as ``uint16`` words under ``"bfloat16"`` and read back by a bit view, so
neither side needs ``ml_dtypes``. Both directions stream one leaf at a
time: the host holds one leaf's bytes, never the whole tree.

Deliberate differences (ROADMAP Queue C): no orbax backend
(``backend="orbax"`` is refused, and a manifest step the reference wrote
with orbax raises :class:`CheckpointError` naming it); ``restore`` places
the tree on ``device`` (the card unless the caller passes ``"cpu"``).
``restore(sharding=)`` takes the port's placements (``parallel.sharding``):
each leaf comes back as this rank's slice, read from the stored array
alone (the archive's members are stored, so a slice is a few positioned
reads of the file, not a read of the whole leaf).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import struct
import time
import zipfile
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch import tree as tree_util
from gofr_tpu_torch._device import resolve_device

MANIFEST = "MANIFEST.json"

# dtype names as numpy (and the reference's tree.json) spell them
_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


class CheckpointError(RuntimeError):
    pass


def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        try:
            return _NAMES[dtype]
        except KeyError:
            raise CheckpointError(f"dtype {dtype} has no checkpoint name") from None
    return np.dtype(dtype).name


def _host_array(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array as stored, the true dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


@dataclasses.dataclass(frozen=True)
class _StoredArray:
    """A stored (uncompressed) C-order ``.npy`` member of the archive at
    ``path``: where its data starts, its shape and dtype. Indexing it with
    a tuple of slices reads that slice alone, one ``preadv`` for each
    contiguous run of it, so the host holds the slice's bytes and no more
    (a memory map would count the pages around each row it touches)."""

    path: str
    offset: int
    shape: tuple[int, ...]
    dtype: np.dtype

    def __getitem__(self, index: tuple[slice, ...]) -> np.ndarray:
        ranges = [range(*s.indices(n)) for s, n in zip(index, self.shape)]
        ranges += [range(n) for n in self.shape[len(ranges):]]
        out = np.empty([len(r) for r in ranges], self.dtype)
        if out.size == 0:
            return out
        split = [d for d, r in enumerate(ranges) if len(r) != self.shape[d]]
        k = split[-1] if split else 0  # the dims after it are read whole
        strides = [math.prod(self.shape[d + 1:]) * self.dtype.itemsize
                   for d in range(len(self.shape))]
        runs = out.reshape(-1).view(np.uint8).reshape(-1, len(ranges[k]) * strides[k])
        starts = np.int64(self.offset + ranges[k].start * strides[k])
        for d in range(k):  # each run's file offset, in the runs' (C) order
            starts = np.add.outer(starts, np.asarray(ranges[d], np.int64) * strides[d])
        fd = os.open(self.path, os.O_RDONLY)
        try:
            for run, at in zip(runs, np.ravel(starts).tolist()):
                got = 0
                while got < len(run):
                    n = os.preadv(fd, [run[got:]], at + got)
                    if not n:
                        raise CheckpointError(f"{self.path}: a stored array ends early")
                    got += n
        finally:
            os.close(fd)
        return out


def _stored_array(path: str, info: zipfile.ZipInfo) -> _StoredArray | None:
    """The member ``info`` of the archive at ``path`` as a
    :class:`_StoredArray`; None for a compressed member, a Fortran-order
    or object array, a scalar, or a header version this does not parse
    (the caller reads the member whole)."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)  # the local file header; its name and extra fields follow
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            return None
        offset = f.tell()
    if fortran or dtype.hasobject or not shape:
        return None
    return _StoredArray(path, offset, tuple(shape), dtype)


class CheckpointManager:
    """Save/restore trees of tensors under ``directory`` with the
    manifest bookkeeping of the package docstring."""

    def __init__(
        self,
        directory: str,
        *,
        backend: str = "auto",  # "auto" | "npz"
        keep: int = 3,
        logger: Any = None,
        metrics: Any = None,
    ) -> None:
        if backend not in ("auto", "npz"):
            raise ValueError(
                f"backend={backend!r}: the port writes npz only (orbax is a JAX library)"
            )
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._logger = logger
        self._metrics = metrics
        os.makedirs(self.directory, exist_ok=True)
        if metrics is not None and metrics.get("app_checkpoint_save_seconds") is None:
            # the reference registers it here, not in its container (listed
            # in serving/metrics_catalog.py's SELF_REGISTERED_METRICS)
            metrics.new_histogram("app_checkpoint_save_seconds", "Checkpoint save latency")
        self.backend = "npz"

    # ------------------------------------------------------------- manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _read_manifest(self) -> dict:
        path = self._manifest_path()
        if not os.path.exists(path):
            return {"steps": []}
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError) as exc:
            raise CheckpointError(f"corrupt manifest at {path}: {exc}") from exc

    def _commit_manifest(self, manifest: dict) -> None:
        """tmp + atomic rename: the transactional commit point."""
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        """Write ``tree`` as ``step``. Saving a step at or below the newest
        committed one is an error: resume never silently rewinds."""
        manifest = self._read_manifest()
        steps = [e["step"] for e in manifest["steps"]]
        last = max(steps) if steps else None
        if last is not None and step <= last:
            raise CheckpointError(
                f"step {step} is not past the last committed step {last}"
            )
        start = time.perf_counter()
        step_dir = self._step_dir(step)
        if os.path.exists(step_dir):  # uncommitted debris from a crash
            shutil.rmtree(step_dir)
        self._save_npz(step_dir, tree)

        manifest["steps"].append(
            {"step": step, "ts": time.time(), "backend": self.backend,
             "metadata": metadata or {}}
        )
        # the prune folded into the single commit: one fsync+rename a save
        all_steps = sorted(e["step"] for e in manifest["steps"])
        excess = all_steps[: -self.keep] if self.keep > 0 else []
        if excess:
            manifest["steps"] = [e for e in manifest["steps"] if e["step"] not in excess]
        self._commit_manifest(manifest)  # the step becomes visible HERE
        for old in excess:  # files only after the manifest stopped naming them
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        elapsed = time.perf_counter() - start
        if self._logger:
            self._logger.info(f"checkpoint step {step} saved in {elapsed:.2f}s")
        if self._metrics:
            self._metrics.record_histogram("app_checkpoint_save_seconds", elapsed)

    def _save_npz(self, step_dir: str, tree: Any) -> None:
        """``np.savez``'s archive (stored ``leaf_{i}.npy`` members),
        written one leaf at a time: each is read to the host, written and
        dropped before the next."""
        os.makedirs(step_dir, exist_ok=True)
        leaves, treedef = tree_util.flatten(tree)
        dtypes = []
        path = os.path.join(step_dir, "weights.npz")
        with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
            for i, leaf in enumerate(leaves):
                arr, name = _host_array(leaf)
                dtypes.append(name)
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
        with open(os.path.join(step_dir, "tree.json"), "w") as f:
            json.dump({"treedef": str(treedef), "n_leaves": len(leaves), "dtypes": dtypes}, f)

    # ------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = [entry["step"] for entry in self._read_manifest()["steps"]]
        return max(steps) if steps else None

    def all_steps(self) -> list[int]:
        return sorted(entry["step"] for entry in self._read_manifest()["steps"])

    def metadata(self, step: int) -> dict:
        for entry in self._read_manifest()["steps"]:
            if entry["step"] == step:
                return entry["metadata"]
        raise CheckpointError(f"step {step} not in manifest")

    def restore(
        self,
        abstract_tree: Any,
        step: int | None = None,
        *,
        sharding: Any = None,
        device: str | torch.device | None = None,
    ) -> Any:
        """Restore a committed step (the newest when ``step`` is None) onto
        ``device`` (the card unless the caller passes ``"cpu"``).
        ``abstract_tree`` gives the structure and each leaf's shape and
        dtype: a tree of tensors, which may be meta or fake tensors (the
        port's ``jax.eval_shape``). ``sharding=`` is one
        ``parallel.sharding.NamedSharding`` for every leaf or a tree of them
        (``rules.tree_shardings(mesh, abstract_tree)``): each leaf is then
        this rank's slice of the stored one, and a replicated placement
        (``P()``) the whole leaf, as the reference's ``P()`` does."""
        slots = None
        if sharding is not None:
            from gofr_tpu_torch.parallel.sharding import placements

            slots = tree_util.leaves(placements(sharding, abstract_tree))
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise CheckpointError(f"no committed checkpoints in {self.directory}")
        entries = {e["step"]: e for e in self._read_manifest()["steps"]}
        if step not in entries:
            raise CheckpointError(
                f"step {step} is not committed (have {sorted(entries)})"
            )
        backend = entries[step].get("backend", "npz")
        if backend != "npz":
            raise CheckpointError(
                f"step {step} was written by the {backend!r} backend, which the port cannot "
                "read (it reads the npz layout only)"
            )
        tree = self._restore_npz(self._step_dir(step), abstract_tree, dev, slots)
        if self._logger:
            self._logger.info(f"restored checkpoint step {step}")
        return tree

    def _restore_npz(self, step_dir: str, abstract_tree: Any, dev: torch.device,
                     slots: list | None = None) -> Any:
        path = os.path.join(step_dir, "weights.npz")
        if not os.path.exists(path):
            raise CheckpointError(f"missing weights at {path}")
        leaves, treedef = tree_util.flatten(abstract_tree)
        with np.load(path, allow_pickle=False) as data:
            if len(leaves) != len(data.files):
                raise CheckpointError(
                    f"leaf count mismatch: tree has {len(leaves)}, "
                    f"checkpoint has {len(data.files)}"
                )
            # structure check: the same leaf count and shapes under a
            # DIFFERENT nesting would silently permute weights
            tree_json = os.path.join(step_dir, "tree.json")
            saved: dict = {}
            if os.path.exists(tree_json):
                with open(tree_json) as f:
                    saved = json.load(f)
                if saved.get("treedef") != str(treedef):
                    raise CheckpointError(
                        "pytree structure mismatch between checkpoint and "
                        f"restore target:\n  saved:  {saved.get('treedef')}\n"
                        f"  target: {treedef}"
                    )
            saved_dtypes = saved.get("dtypes")
            restored = []
            for i, leaf in enumerate(leaves):
                arr = _stored_array(path, data.zip.getinfo(f"leaf_{i}.npy")) if slots else None
                if arr is None:
                    arr = data[f"leaf_{i}"]
                name = saved_dtypes[i] if saved_dtypes is not None else arr.dtype.name
                if tuple(leaf.shape) != arr.shape:
                    raise CheckpointError(
                        f"leaf {i} shape mismatch: expected {tuple(leaf.shape)}, got {arr.shape}"
                    )
                want = _dtype_name(leaf.dtype)
                if want != name:
                    raise CheckpointError(
                        f"leaf {i} dtype mismatch: expected {want}, got {name}"
                    )
                if slots:
                    from gofr_tpu_torch.parallel.sharding import local_index

                    index = local_index(arr.shape, slots[i].spec, slots[i].mesh)
                    arr = arr[index] if isinstance(arr, _StoredArray) else np.array(arr[index])
                t = torch.from_numpy(arr)
                if name == "bfloat16":  # stored as its 16-bit words
                    t = t.view(torch.bfloat16)
                restored.append(t.to(dev))
                del arr, t
        return treedef.unflatten(restored)

    def health_check(self) -> dict[str, Any]:
        try:
            steps = self.all_steps()
            return {
                "status": "UP",
                "details": {
                    "directory": self.directory,
                    "backend": self.backend,
                    "steps": steps[-self.keep:],
                    "latest": steps[-1] if steps else None,
                },
            }
        except CheckpointError as exc:
            return {"status": "DEGRADED", "details": {"error": str(exc)}}
