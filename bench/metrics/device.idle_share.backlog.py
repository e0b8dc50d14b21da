"""device.idle_share.backlog: see ``readers.idle_share``."""
from readers import idle_share as read

__all__ = ["read"]
