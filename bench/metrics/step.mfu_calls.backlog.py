"""step.mfu_calls.backlog: see ``phases.step_mfu_calls``."""
from phases import step_mfu_calls as read

__all__ = ["read"]
