"""serve.queue_wait_ms.online: see ``readers.queue_wait_ms``."""
from readers import queue_wait_ms as read

__all__ = ["read"]
