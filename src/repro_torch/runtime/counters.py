"""What one rank's program does, counted as it runs: the dry run's
counters (``launch.dryrun``), alike on ``"meta"`` tensors and real ones.

A :class:`Counts` (:func:`counting`) gathers, while it is open:

* ``ops``: the operations of the aten ops the program dispatches, by the
  formulas of ``torch.utils.flop_counter`` (the counter of
  ``FlopCounterMode``: 2 a multiply-add of a matmul, a convolution or an
  attention; 0 for every other op), plus each hand-written kernel's own
  count (:func:`kernel`: 2*M*N*K for a GEMM);
* ``bytes``: each aten op's inputs plus its outputs, every tensor at its
  full size -- unfused, as eager PyTorch runs the ops, where XLA's "bytes
  accessed" counts a fused region's operands once -- views and
  allocations excluded (they move nothing); plus each kernel's inputs
  read once and its output written once;
* ``kernels``: the calls of each kernel wrapper (its ``META_CALLS``,
  ``LAUNCHES`` or ``PLAIN_CALLS`` say which branch ran);
* ``collectives``: one ``(kind, dtype, shape)`` a call of a
  ``runtime.collectives`` primitive, the shape of its result buffer;
* ``peak_bytes``: the most bytes of storage the program held at once
  beyond the storages it was given (:class:`_Tracker`; a storage counts
  from the op that made it until it is freed, so on the card the same
  program peaks at what ``torch.cuda.max_memory_allocated`` shows above
  its inputs, give or take the allocator's rounding).

Inside a kernel wrapper or a collective primitive the aten ops are
*opaque* (:func:`opaque`): a kernel's plain version on CPU tensors or a
gloo collective's host staging counts as the kernel or the collective it
stands for, so a CPU run and a meta run of one program count the same.
Storages made there are tracked all the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the open counts; a collective primitive checks this before counting
ACTIVE: list = []
_OPAQUE = [0]

_ALLOCATIONS = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default})


@dataclasses.dataclass
class Counts:
    ops: int = 0
    bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)     # name -> calls
    collectives: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def opaque():
    """Aten ops inside are not counted (a kernel's or a collective's own)."""
    _OPAQUE[0] += 1
    try:
        yield
    finally:
        _OPAQUE[0] -= 1


@contextlib.contextmanager
def kernel(name: str, ops: int, nbytes: int):
    """One call of the kernel ``name`` doing ``ops`` operations over
    ``nbytes`` bytes; the aten ops inside (its plain version) are opaque."""
    for c in ACTIVE:
        c.kernels[name] = c.kernels.get(name, 0) + 1
        c.ops += ops
        c.bytes += nbytes
    with opaque():
        yield


def gemm(name: str, x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype, *scales):
    """:func:`kernel` for a GEMM kernel ``name`` of x (M, K) @ w (K, N) ->
    (M, N) ``out_dtype``: 2*M*N*K operations, its operands and ``scales``
    read once and its output written once."""
    (m, k), n = x.shape, w.shape[1]
    nbytes = sum(_nbytes(t) for t in (x, w, *scales)) + m * n * out_dtype.itemsize
    return kernel(name, 2 * m * n * k, nbytes)


def check_meta(name: str, *tensors) -> None:
    """A kernel's meta branch takes ``"meta"`` tensors only."""
    if any(t.device.type != "meta" for t in tensors):
        raise ValueError(f"{name}: operands on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")


def collective(kind: str, dtype: torch.dtype, shape) -> None:
    """One collective whose result buffer is ``shape`` of ``dtype``."""
    for c in ACTIVE:
        c.collectives.append((kind, dtype, tuple(shape)))


def storages(tree):
    """The storages of ``tree``'s tensor leaves (a storage once a view)."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            yield t.untyped_storage()


class _Tracker(TorchDispatchMode):
    """Counts every aten op (see the module docstring) and tracks the
    storages that the ops make, by weak references: the bytes alive now
    and at most, beyond the storages of ``given``."""

    def __init__(self, counts: Counts, given):
        super().__init__()
        self.counts = counts
        self.given = {id(s): s for s in storages(given)}
        self.live = {}                     # id(storage) -> (weakref, nbytes)
        self.now = 0

    def _freed(self, key, _ref):
        _, n = self.live.pop(key)
        self.now -= n

    def _track(self, out):
        for st in storages(out):
            key = id(st)
            if key in self.given or key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = (weakref.ref(st, lambda r, k=key: self._freed(k, r)), n)
            self.now += n
        self.counts.peak_bytes = max(self.counts.peak_bytes, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _OPAQUE[0] and func not in _ALLOCATIONS:
            c = self.counts
            packet = func._overloadpacket
            if packet in flop_registry:
                c.ops += int(flop_registry[packet](*args, **kwargs, out_val=out))
            if not any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns):
                c.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
                               if isinstance(t, torch.Tensor))
        self._track(out)
        return out


@contextlib.contextmanager
def counting(given=()):
    """Count what runs inside into a new :class:`Counts` (yielded).
    ``given``: the program's inputs, whose storages are not its own."""
    counts = Counts()
    ACTIVE.append(counts)
    try:
        with _Tracker(counts, given):
            yield counts
    finally:
        ACTIVE.remove(counts)


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors."""
    seen = {}
    for st in storages(tree):
        seen[id(st)] = st.nbytes()
    return sum(seen.values())
