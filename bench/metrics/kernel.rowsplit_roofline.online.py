"""kernel.rowsplit_roofline.online: see ``readers.rowsplit_roofline``."""
from readers import rowsplit_roofline as read

__all__ = ["read"]
