"""kernel.rowsplit_roofline.backlog: see ``readers.rowsplit_roofline``."""
from readers import rowsplit_roofline as read

__all__ = ["read"]
