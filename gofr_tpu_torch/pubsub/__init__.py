"""The port's pubsub: the in-memory broker the membership heartbeats ride
(copies of ``gofr_tpu/datasource/pubsub/memory.py`` and ``message.py``;
no networked broker is ported)."""

from gofr_tpu_torch.pubsub.memory import InMemoryBroker
from gofr_tpu_torch.pubsub.message import Message

__all__ = ["InMemoryBroker", "Message"]
