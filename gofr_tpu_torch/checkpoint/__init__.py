"""Checkpoint / resume (port of ``gofr_tpu/checkpoint``).

The reference's semantics, carried from its migration bookkeeping to
model weights: every save is a monotonically numbered **step** recorded in
a ``MANIFEST.json`` written with tmp-file + atomic rename (the
transactional commit), so a crash mid-save leaves the previous manifest
intact and the half-written step invisible; restore defaults to the
newest committed step (resume); old steps are pruned to ``keep``.

The port writes the reference's npz layout (``weights.npz`` + ``tree.json``
with ``jax.tree``'s structure string and each leaf's dtype; bf16 stored as
its 16-bit words), so a step saved by either package restores in the
other. It has no orbax backend: ``backend="auto"`` means npz here, and a
step the reference wrote with orbax raises :class:`CheckpointError`.
"""

from gofr_tpu_torch.checkpoint.manager import CheckpointError, CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager"]
