"""step.mfu_calls.online: see ``phases.step_mfu_calls``."""
from phases import step_mfu_calls as read

__all__ = ["read"]
