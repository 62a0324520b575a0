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
the tree on ``device`` (the card unless the caller passes ``"cpu"``) and
refuses ``sharding=`` until the parallel plane is ported.
"""

from __future__ import annotations

import json
import os
import shutil
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
        port's ``jax.eval_shape``). ``sharding=`` is refused until the
        parallel plane is ported (ROADMAP Queue A item 9)."""
        if sharding is not None:
            raise NotImplementedError(
                "sharding= needs the parallel plane (ROADMAP Queue A item 9); "
                "the port restores onto one device"
            )
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
        tree = self._restore_npz(self._step_dir(step), abstract_tree, dev)
        if self._logger:
            self._logger.info(f"restored checkpoint step {step}")
        return tree

    def _restore_npz(self, step_dir: str, abstract_tree: Any, dev: torch.device) -> Any:
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
