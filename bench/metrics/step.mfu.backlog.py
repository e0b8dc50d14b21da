"""step.mfu.backlog: see ``readers.step_mfu``."""
from readers import step_mfu as read

__all__ = ["read"]
