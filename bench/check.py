"""The comparison that decides ``correct``: served logits against the
reference's, request by request.

Two numbers, each the worst over every position of every request
compared:

* ``logit_err``: ‖served − reference‖ / ‖reference‖ of one position's
  logits (L2 over the vocabulary);
* ``top1_gap``: how far below the reference's best logit the reference
  puts the token that the served logits rank first, in units of the
  standard deviation of that position's reference logits.

A request that was never answered, or failed in execution, makes the run
not correct whatever the numbers read.
"""
from __future__ import annotations

import torch

NAMES = ("logit_err", "top1_gap")


class Worst:
    """The worst of each number so far, over positions and requests."""

    def __init__(self):
        self.value = dict.fromkeys(NAMES, 0.0)
        self.positions = 0

    def add(self, served: torch.Tensor, ref: torch.Tensor) -> None:
        """``served`` and ``ref``: (s, V) float32 logits of one request."""
        if served.shape != ref.shape:
            self.value["logit_err"] = float("inf")
            return
        served = served.to(ref.device, torch.float32)
        err = (served - ref).norm(dim=-1) / ref.norm(dim=-1)
        pick = served.argmax(-1, keepdim=True)
        gap = (ref.amax(-1) - ref.gather(-1, pick)[:, 0]) / ref.std(-1)
        for name, x in (("logit_err", err), ("top1_gap", gap)):
            w = float(x.max()) if x.numel() else 0.0
            if w != w:          # NaN compares as the worst
                w = float("inf")
            self.value[name] = max(self.value[name], w)
        self.positions += served.shape[0]


def verdict(worst: Worst, limits: dict, missing: int) -> tuple[bool, dict]:
    """``correct`` and the numbers beside their limits, in print order."""
    compared = {name: {"value": worst.value[name], "limit": limits[name]}
                for name in NAMES}
    compared["unanswered"] = {"value": missing, "limit": 0}
    ok = missing == 0 and all(worst.value[n] <= limits[n] for n in NAMES)
    return ok, compared
