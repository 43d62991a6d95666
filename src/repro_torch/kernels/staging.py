"""staging — host slots for the staged route of the two speculative kernels.

On the codegen path one epoch's request is a round trip: indices on the
host, values back on the host.  The staged route makes that one host call
and one PCIe crossing each way.  A :class:`Ring` holds a few
:class:`Slot` s, each an index buffer, a value buffer and an output
buffer of int32 (the drivers' table holds int32 rows of one element).  On
a CUDA device the buffers are page-locked host memory that the kernels
read and write directly through their mapped device address
(``csrc/spec_gather.cu``, ``csrc/spec_scatter.cu``); the host fills and
reads them through numpy views, with no copy and no device tensor per
call.

A staged gather waits for its stream before it returns, so its slot is
free again at once.  A staged scatter returns without waiting and records
the slot's event, and the ring hands that slot out again only after the
event has completed, so a later request never overwrites indices or
values that a kernel still reads.  Page-locked allocation takes
milliseconds, so a ring is made once per driver and only grows, by
doubling, when a request is larger than a slot.  Before a ring's memory
is released its pending events are waited for.

On a CPU device the buffers are plain memory and there are no events
(``event`` may pass a stand-in, for tests), so the CPU tests reach all of
the ring's logic.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Callable, List, Optional

import torch

from .build import check, load

#: slots in a ring: two scatters in a row use two slots, so a third
#: request waits only for the oldest of three
SLOTS = 4
#: indices a new slot holds (a multiple of 4: the kernels read 16 bytes
#: of indices a thread)
CAPACITY = 1024


class Slot:
    """One request's int32 buffers as numpy views of ``capacity``
    elements — ``idx``, ``val`` (a scatter's values) and ``out`` (a
    gather's rows) — with their device addresses (``*_ptr``, None on the
    CPU), the ring's device (``where``; ``device`` is its CUDA index) and
    stream, and the slot's event."""

    __slots__ = ("idx", "val", "out", "capacity", "idx_ptr", "val_ptr",
                 "out_ptr", "where", "stream", "device", "event",
                 "event_ptr", "pending", "_buffers")

    def launched(self) -> None:
        """Mark a launch that reads the slot after the call returns (a
        scatter): the ring waits for the slot's event before it hands the
        slot out again."""
        if self.event is not None:
            self.pending = True


def device_ptr(host: int) -> int:
    """The address a kernel uses for page-locked host address ``host``;
    raises for memory that is not page-locked or is write-combined."""
    out = ctypes.c_void_p()
    check(load("spec_gather").spec_staging_device_ptr(
        host, ctypes.addressof(out)),
        "staging buffer (page-locked, not write-combined)")
    return out.value


def _drain(slots: List[Slot]) -> None:
    for slot in slots:
        if slot.pending:
            slot.event.synchronize()
            slot.pending = False


class Ring:
    """A ring of ``slots`` slots of ``capacity`` indices on ``device``.

    On CUDA the buffers are page-locked and mapped, each slot has a CUDA
    event, and the kernels run on the device's current stream at the time
    the ring is made.  ``event`` makes a slot's event (default: a
    :class:`torch.cuda.Event` on CUDA, none on the CPU).
    """

    def __init__(self, device, slots: int = SLOTS, capacity: int = CAPACITY,
                 event: Optional[Callable[[], object]] = None):
        device = torch.device(device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"no staged kernels for device {device}")
        if slots < 1 or capacity < 4 or capacity % 4:
            raise ValueError("a ring needs a slot and a capacity that is a "
                             "positive multiple of 4")
        self.cuda = device.type == "cuda"
        stream = index = None
        if self.cuda:
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            device = torch.device("cuda", index)
            stream = torch.cuda.current_stream(device)
            event = event or torch.cuda.Event
        self.device = device
        self._slots: List[Slot] = []
        for _ in range(slots):
            slot = Slot()
            slot.where, slot.device, slot.pending = device, index, False
            slot.stream = stream.cuda_stream if stream is not None else None
            slot.event = event() if event is not None else None
            slot.event_ptr = None
            if self.cuda:
                with torch.cuda.device(device):
                    slot.event.record(stream)  # create the CUDA event now
                slot.event_ptr = slot.event.cuda_event
            self._fill(slot, capacity)
            self._slots.append(slot)
        self._next = 0
        done = weakref.finalize(self, _drain, self._slots)
        done.atexit = False

    def _buffer(self, capacity: int):
        if not self.cuda:
            t = torch.empty(capacity, dtype=torch.int32)
            return t, t.numpy(), None
        with torch.cuda.device(self.device):
            t = torch.empty(capacity, dtype=torch.int32, pin_memory=True)
            return t, t.numpy(), device_ptr(t.data_ptr())

    def _fill(self, slot: Slot, capacity: int) -> None:
        """Give ``slot`` new buffers of ``capacity`` elements."""
        idx, slot.idx, slot.idx_ptr = self._buffer(capacity)
        val, slot.val, slot.val_ptr = self._buffer(capacity)
        out, slot.out, slot.out_ptr = self._buffer(capacity)
        slot._buffers = (idx, val, out)
        slot.capacity = capacity

    @property
    def slots(self) -> List[Slot]:
        """The ring's slots, in the order :meth:`acquire` hands them out."""
        return list(self._slots)

    def acquire(self, n: int) -> Slot:
        """The next slot in turn, free and holding at least ``n`` indices.

        Waits for the slot's last scatter if it is still pending; grows
        the slot's buffers by doubling when ``n`` is larger than them.
        """
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.pending:
            slot.event.synchronize()
            slot.pending = False
        if n > slot.capacity:
            capacity = slot.capacity
            while capacity < n:
                capacity *= 2
            self._fill(slot, capacity)
        return slot

    def drain(self) -> None:
        """Wait for every pending launch that reads a slot."""
        _drain(self._slots)


def check_staged(table: torch.Tensor, slot: Slot, n: int) -> None:
    """Checks of a staged call on ``table`` — the drivers' contiguous
    ``(rows, 1)`` int32 table — with the first ``n`` indices (and values)
    of ``slot``."""
    if table.device != slot.where:
        raise ValueError(f"table on {table.device}, staging slot on "
                         f"{slot.where}")
    if table.dtype != torch.int32:
        raise TypeError(f"staged table dtype {table.dtype} (int32 only)")
    shape = table.shape
    if len(shape) != 2 or shape[1] != 1 or not table.is_contiguous():
        raise ValueError(f"staged table must be a contiguous (rows, 1) "
                         f"tensor, got {tuple(shape)}")
    if not 0 <= n <= slot.capacity:
        raise ValueError(f"{n} requests do not fit a slot of "
                         f"{slot.capacity}")
    if n and shape[0] == 0:
        raise ValueError("cannot index a table with no rows")
