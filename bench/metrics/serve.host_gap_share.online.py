"""serve.host_gap_share.online: see ``phases.host_gap_share``."""
from phases import host_gap_share as read

__all__ = ["read"]
