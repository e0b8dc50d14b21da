"""step.mfu.online: see ``readers.step_mfu_busy``."""
from readers import step_mfu_busy as read

__all__ = ["read"]
