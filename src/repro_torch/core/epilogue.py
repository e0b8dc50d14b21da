"""Fused epilogue spec: what happens to C between accumulator and memory.

    y = act(C + bias) * scale + residual

with each stage optional.  The spec carries only flags and constants; the
operand tensors (``bias (m,)``, ``residual (..., m, n)``) travel as call
arguments.  :func:`apply_epilogue` is the single implementation of the
math for the plain versions; the CUDA kernels apply the same formula at
their output write (``csrc/spmm_common.cuh``).
:func:`activation_grad` is its derivative for the backward of the
differentiable SpMM.  gelu is the tanh
approximation everywhere, as ``jax.nn.gelu``'s default in the reference.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_ACTIVATIONS = ("none", "relu", "gelu")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """A fused C-tail: ``y = act(C + bias) * scale + residual``.

    ``bias``/``residual`` are *flags* — the tensors ride as call arguments
    and must be present exactly when the flag is set.  ``activation`` is
    one of ``"none"`` | ``"relu"`` | ``"gelu"``; ``scale`` is a float
    (``None`` = 1).  Frozen and hashable.
    """

    bias: bool = False
    activation: str = "none"
    residual: bool = False
    scale: float | None = None

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(
                f"Epilogue.activation must be one of {_ACTIVATIONS}, got "
                f"{self.activation!r}")
        if self.scale is not None:
            object.__setattr__(self, "scale", float(self.scale))

    def is_identity(self) -> bool:
        """True iff this epilogue changes nothing (drop it entirely)."""
        return (not self.bias and self.activation == "none"
                and not self.residual and self.scale is None)


def activation_fn(name: str):
    """The activation callable (``gelu`` is the tanh approximation)."""
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown epilogue activation {name!r}")


def activation_grad(name: str, pre: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """``g · act'(pre)``: the cotangent through the activation at ``pre``.

    relu passes ``g`` where ``pre > 0`` (0 at 0, as ``jax.nn.relu``);
    gelu is the derivative of the tanh form, in closed form:
    ``0.5 (1 + t) + 0.5 x (1 - t²) √(2/π) (1 + 3·0.044715 x²)`` with
    ``t = tanh(√(2/π) (x + 0.044715 x³))``.
    """
    if name == "relu":
        return torch.where(pre > 0, g, 0)
    if name == "gelu":
        k = 0.7978845608028654                      # sqrt(2 / pi)
        x2 = pre * pre
        t = torch.tanh(k * (pre + 0.044715 * x2 * pre))
        d = 0.5 * (1 + t) + 0.5 * pre * (1 - t * t) * k * (
            1 + 3 * 0.044715 * x2)
        return g * d
    raise ValueError(f"unknown epilogue activation {name!r}")


def apply_epilogue(c: torch.Tensor, ep: Epilogue | None, bias=None,
                   residual=None) -> torch.Tensor:
    """Apply ``ep`` to an accumulator tensor *in its dtype*.

    ``bias``/``residual`` must already broadcast against ``c`` (callers
    reshape ``(m,)`` → ``(m, 1)``).  Operands are cast to ``c``'s dtype, so
    calling on the f32 accumulator applies the whole tail in accumulation
    precision before the single cast to the output dtype.
    """
    if ep is None:
        return c
    if ep.bias:
        c = c + bias.to(c.dtype)
    if ep.activation != "none":
        c = activation_fn(ep.activation)(c)
    if ep.scale is not None:
        c = c * ep.scale
    if ep.residual:
        c = c + residual.to(c.dtype)
    return c
