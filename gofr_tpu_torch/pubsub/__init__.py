"""The port's pubsub: the in-memory broker that the membership heartbeats
and the app's subscribers (``subscriber.py``) ride, and the delivery
policy with its dead-letter topics (copies of
``gofr_tpu/datasource/pubsub/memory.py``, ``message.py`` and
``delivery.py``; no networked broker is ported)."""

from gofr_tpu_torch.pubsub.memory import InMemoryBroker
from gofr_tpu_torch.pubsub.message import Message

__all__ = ["InMemoryBroker", "Message"]
