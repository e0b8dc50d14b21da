"""CUDA launch models: each kernel module describes its own launches.

The counterpart of the reference's ``repro.kernels.introspect`` (its
``KernelBlock``/``KernelLaunch`` model of a ``pallas_call``).  A Pallas
launch is a grid walked in order with BlockSpecs cutting the operands; a
CUDA launch is what a C entry in ``csrc/`` hands ``<<<...>>>``, so a
:class:`KernelLaunch` here holds

* the kernel ``symbol`` as the profiler and a demangler name it
  (``repro::rowsplit_kernel<1, float, float, float>``);
* ``grid`` (x, y, z) and ``block`` threads;
* dynamic and static shared memory (the ``__shared__`` arrays);
* ``min_blocks``, the ``__launch_bounds__`` minimum blocks an SM (0 where
  the kernel names none);
* the ``body`` the C entry picks (``spmm_common.cuh`` ``pick_body``, the
  grouped GEMM's and flash attention's bodies);
* one :class:`OperandAccess` per operand: dtype, full shape, the bytes the
  launch *requests* from global memory, counted the way its body issues
  its loads and stores, and one warp's lane-to-byte-address map of each
  load or store instruction (:class:`WarpAccess`);
* ``writers``: the stores of every output group (K040's single writer),
  ``walks``: the nonzero streams the warps walk (T120), and ``indices``:
  every gather index the launch issues, over the real plan arrays (K030).

Each kernel module exports ``launch_models(...)`` built from these, beside
the host code it mirrors; the SpMM methods reach it through
``MethodSpec.traffic``, the other kernels through
``repro_torch.analysis.access.EXTRA_KERNELS``.  The kernel audit
(``repro_torch.analysis.kernel_audit``), the coalescing proof
(``.access``) and the bytes-moved analyzer (``.traffic``) all read these
models, and ``chip_smoke.py``'s ``analysis`` phase holds their grid,
block and shared memory against the profiler's record of each launch.

A :class:`KernelLaunch` whose ``symbol`` is None is a PyTorch operation
between kernel launches (rowgroup's un-grouping gather): it counts in the
bytes, and no resource check applies to it.

The SM count and the card's limits are a :class:`Card`: on a CUDA device
from ``torch.cuda.get_device_properties`` (:func:`card_of`), elsewhere the
committed table :data:`H100_SXM`.  Bytes are plain integers from the
dtype sizes of :data:`DTYPE_BYTES`.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

#: bytes of an element, by dtype name (the operands' types in the kernels)
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int32": 4, "uint8": 1,
               "int64": 8}
#: the C++ type of a dtype name in a kernel's template arguments
CXX_TYPES = {"float32": "float", "bfloat16": "__nv_bfloat16"}
#: bytes of one global-memory sector
SECTOR = 32


def dtype_name(dt) -> str:
    """``"float32"`` for ``torch.float32`` or ``"float32"``."""
    return str(dt).removeprefix("torch.")


def nbytes(dt) -> int:
    return DTYPE_BYTES[dtype_name(dt)]


@dataclasses.dataclass(frozen=True)
class Card:
    """The limits a launch is held to (``kernel_audit`` K020)."""

    name: str
    sms: int
    smem_block_optin: int        # bytes a block may opt in to
    smem_sm: int                 # bytes of shared memory an SM
    smem_reserved_block: int     # bytes the runtime keeps a block
    regs_sm: int
    threads_sm: int
    threads_block: int = 1024
    grid_x: int = 2 ** 31 - 1
    grid_yz: int = 65535
    blocks_sm: int = 32

    def resident(self, block: int, smem: int) -> int:
        """Blocks of ``block`` threads and ``smem`` bytes of shared memory
        an SM holds by shared memory, threads and the hardware's block
        limit (registers are the card's to report: ptxas, the
        profiler)."""
        per = [self.blocks_sm, self.threads_sm // max(block, 1)]
        if smem:
            per.append(self.smem_sm // (smem + self.smem_reserved_block))
        return max(min(per), 0)


#: NVIDIA H100 SXM (data sheet and the CUDA occupancy tables for sm_90):
#: 132 SMs, 227 KB opt-in shared memory a block, 228 KB an SM, 1 KB of it
#: reserved a block, 65,536 registers and 2,048 threads an SM.
H100_SXM = Card("NVIDIA H100 SXM (committed table)", sms=132,
                smem_block_optin=232_448, smem_sm=233_472,
                smem_reserved_block=1024, regs_sm=65_536, threads_sm=2048)


def card_of(device=None) -> Card:
    """The card's limits: from ``torch.cuda.get_device_properties`` on a
    CUDA device, else the committed :data:`H100_SXM` table."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return H100_SXM
    p = torch.cuda.get_device_properties(device)
    return Card(p.name, sms=p.multi_processor_count,
                smem_block_optin=p.shared_memory_per_block_optin,
                smem_sm=p.shared_memory_per_multiprocessor,
                smem_reserved_block=H100_SXM.smem_reserved_block,
                regs_sm=p.regs_per_multiprocessor,
                threads_sm=p.max_threads_per_multi_processor)


@dataclasses.dataclass(frozen=True)
class WarpAccess:
    """One load or store instruction of one warp.

    ``runs`` groups the active lanes' ``(byte address, bytes)`` segments
    into the pieces that belong together: one run a B row for a body that
    takes two rows at once, one run for a plain coalesced access.
    """

    label: str
    runs: tuple                  # ((addr, nbytes), ...), ...

    def sectors(self) -> int:
        """32-byte sectors the instruction touches."""
        touched = set()
        for run in self.runs:
            for addr, nb in run:
                touched.update(range(addr // SECTOR,
                                     (addr + nb - 1) // SECTOR + 1))
        return len(touched)

    def min_sectors(self) -> int:
        """The fewest sectors that could hold the same bytes: each run's
        bytes (those no earlier run holds) laid contiguously from its
        lowest address."""
        total, seen = 0, set()
        for run in self.runs:
            distinct = set()
            for addr, nb in run:
                distinct.update(range(addr, addr + nb))
            distinct -= seen
            seen |= distinct
            if distinct:
                total += -(-(min(distinct) % SECTOR + len(distinct))
                           // SECTOR)
        return total


def lanes(base: int, stride: int, width: int, active=range(32)) -> tuple:
    """One run of ``(base + lane * stride, width)`` over the active lanes."""
    return tuple((base + lane * stride, width) for lane in active)


@dataclasses.dataclass(frozen=True)
class OperandAccess:
    """One operand of a launch and the global-memory bytes it moves."""

    name: str
    dtype: str
    shape: tuple
    kind: str                    # "in" | "out" | "scratch"
    read_bytes: int = 0
    write_bytes: int = 0
    warp: tuple = ()             # WarpAccess, ... of one warp


@dataclasses.dataclass(frozen=True)
class IndexStream:
    """Gather indices a launch issues: each value in ``[0, bound)``
    (``bound`` an int or an array of the values' shape)."""

    name: str
    values: np.ndarray
    bound: object


@dataclasses.dataclass(frozen=True)
class Walk:
    """The nonzero stream the warps walk: ``positions`` in walk order,
    ``warps`` the walker of each; within a warp each step must move
    forward (``strict``) or hold."""

    name: str
    warps: np.ndarray
    positions: np.ndarray
    strict: bool = True


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """A statically checkable model of one CUDA launch (or, with
    ``symbol`` None, of a PyTorch operation between launches)."""

    label: str
    symbol: str | None
    source: str | None           # csrc file of the kernel
    grid: tuple                  # (x, y, z)
    block: int
    dynamic_smem: int
    static_smem: int
    min_blocks: int              # __launch_bounds__ minimum (0: none)
    body: str
    operands: tuple              # OperandAccess, ...
    in_dtypes: tuple = ()        # dtypes multiplied (K050)
    acc_dtype: str = "float32"
    launched: bool = True        # False: the C entry returns before it
    writers: Callable | None = None  # () -> stores of each output group
    walks: Callable | None = None    # () -> [Walk]
    indices: Callable | None = None  # () -> [IndexStream]

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    @property
    def smem(self) -> int:
        return self.dynamic_smem + self.static_smem

    def read_bytes(self) -> int:
        return sum(o.read_bytes for o in self.operands)

    def write_bytes(self) -> int:
        return sum(o.write_bytes for o in self.operands)

    def requested_bytes(self) -> int:
        """Bytes the launch requests from global memory, loads and stores
        (0 for a launch its C entry skips)."""
        if not self.launched:
            return 0
        return self.read_bytes() + self.write_bytes()


def static_smem(*nbytes: int) -> int:
    """A kernel's static shared memory as ptxas reports it: its
    ``__shared__`` arrays' bytes, rounded up to 16 (the alignment of the
    dynamic area that follows)."""
    return -(-sum(nbytes) // 16) * 16


def template(name: str, *args) -> str:
    """``repro::name<a, b>`` as a demangler prints it."""
    if not args:
        return f"repro::{name}"
    return f"repro::{name}<{', '.join(str(a) for a in args)}>"


def normalize_symbol(s: str) -> str:
    """A kernel name without spaces or the parameter list, for matching
    a model's symbol against a profiler's or demangler's name."""
    s = s.replace(" ", "")
    s = s.removeprefix("void")
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return s[:i]
    return s


def host(t) -> np.ndarray:
    """A plan array as int64 numpy on the host."""
    if isinstance(t, np.ndarray):
        return t.astype(np.int64, copy=False)
    return t.detach().to("cpu", torch.int64).numpy()


# ------------------------------------------------- the SpMM bodies' lanes ---

#: spmm_common.cuh enum SpmmBody, the template argument of the SpMM kernels
SPMM_BODY_CODES = {"scalar": 0, "f32x4": 1, "bf16x8": 2, "staged": 3}


def spmm_layout(body: str) -> tuple[int, int, int]:
    """(kPer, kStride, kSlots) of ``Layout<kBody>`` in spmm_common.cuh:
    the columns a lane owns, their stride, the rows a warp takes at once."""
    if body == "bf16x8":
        return 8, 1, 2
    if body == "f32x4":
        return 4, 1, 1
    return 4, 32, 1


def row_loads(label: str, rows: tuple, n: int, itemsize: int, body: str,
              slice_: int = 0) -> tuple:
    """One warp's loads of a 128-column slice of row-major rows starting
    at the byte addresses ``rows`` (one a slot; the bf16x8 body takes two,
    one a half-warp), as ``BRaw::load`` issues them: one 16-byte load a
    lane in the vector bodies, four 4-byte rounds in the scalar one."""
    per, stride, slots = spmm_layout(body)
    if stride == 1:
        runs = []
        for h, row in enumerate(rows[:slots]):
            c0s = [slice_ * 128 + lane * per for lane in range(32 // slots)]
            runs.append(tuple((row + c * itemsize, per * itemsize)
                              for c in c0s if c < n))
        return (WarpAccess(label, tuple(runs)),)
    return tuple(
        WarpAccess(f"{label} round {q}", (tuple(
            (rows[0] + c * itemsize, itemsize) for c in
            (slice_ * 128 + lane + 32 * q for lane in range(32)) if c < n),))
        for q in range(4))


def row_steps(label: str, base: int, n: int, itemsize: int, body: str,
              slice_: int = 0) -> tuple:
    """One warp's accesses of a row slice at byte address ``base`` in the
    epilogue's 4-value steps: ``store_vec``'s stores of C (16 bytes a lane
    in f32, 8 in bf16) and ``apply_epilogue_vec``'s float4 reads of the
    residual, by the lanes of the first half-warp slot; or the scalar
    body's four rounds."""
    per, stride, slots = spmm_layout(body)
    if stride == 1:
        out = []
        for q in range(0, per, 4):
            c0s = [slice_ * 128 + lane * per for lane in range(32 // slots)]
            out.append(WarpAccess(f"{label} step {q // 4}", (tuple(
                (base + (c + q) * itemsize, 4 * itemsize)
                for c in c0s if c < n),)))
        return tuple(out)
    return row_loads(label, (base,), n, itemsize, body, slice_)
