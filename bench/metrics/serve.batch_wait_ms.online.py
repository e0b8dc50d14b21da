"""serve.batch_wait_ms.online: see ``phases.batch_wait_ms``."""
from phases import batch_wait_ms as read

__all__ = ["read"]
