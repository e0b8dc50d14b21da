"""serve.pad_share.online: see ``readers.pad_share``."""
from readers import pad_share as read

__all__ = ["read"]
