"""The host <-> device moves of ``api.diag``, staged so that they overlap
with the steps.

A call's time-varying inputs go up one step ahead of the step that reads
them, through a ring of host slots, and each step's ``sb_con`` comes back
as soon as its step has run, while the device runs the later steps.  On a
CUDA device the slots are pinned, the copies to and from the card run on
the stager's own stream, and CUDA events order them with the compute
stream: a step's kernels wait, on the card, for the event of its inputs'
copy; a read-back waits for an event recorded after the step that wrote
the plane.  The host's copies run on two worker threads, each a single
NumPy copy that releases the interpreter lock (no thread pool of its own
beside the caller's): one fills an input slot once its last copy to the
card has completed and enqueues that copy; the other copies each output
slot into the caller's array once its plane has arrived.  So the thread
enqueueing the steps makes no copy, and waits only where it needs a slot
or an event that is not ready.  On the CPU the same slots are plain
memory and every copy is complete where it is issued.

Host memory is :data:`SLOTS` input slots (one step's planes each, grown to
the widest step a call has asked for) and :data:`SLOTS` output slots (one
plane each), whatever the number of calls.  The arrays a call returns are
its own, never a view of a slot.

Every move adds its float32 bytes to the tracer's counter ``staged_bytes``
and every upload also to ``h2d_bytes``, as ``models.pipeline._f32`` counts
its moves.  Where the enqueueing thread blocks it is a ``wait:<site>``
span: ``staging_slot`` (a copy to the card not yet enqueued),
``output_readback`` or ``state_readback`` (an output slot not yet copied
out).
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .utils.tracing import tracer

#: Slots in each ring: an input slot is refilled, or an output slot
#: reused, only once the move ``SLOTS`` moves back through it has
#: completed.
SLOTS = 3


def _copy_out(arrived, buf, dest):
    """On the read-back worker: once the event ``arrived`` has completed,
    the plane in the host tensor ``buf`` into the caller's array."""
    arrived.synchronize()
    np.copyto(dest, buf[:dest.size].numpy().reshape(dest.shape))


def _result(job, site):
    """A worker's result (or a value computed in place), the wait for an
    unfinished one under the span ``wait:<site>``."""
    if not isinstance(job, Future):
        return job
    if not job.done():
        with tracer.hook(f"wait:{site}"):
            return job.result()
    return job.result()


class _Slot:
    """A flat float32 host buffer and what last used it: for an input slot
    the event of its copy to the card, for an output slot the future of
    its copy into the caller's array and that read-back's wait site (None:
    free)."""

    __slots__ = ("buf", "busy")

    def __init__(self, buf):
        self.buf, self.busy = buf, None


class Stager:
    """The staging slots, copy stream and copy workers of one grid on one
    device.

    ``plane`` — (nlat, nlon), the size of an output slot.
    """

    def __init__(self, device, plane):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = self._up = self._down = None
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._up = ThreadPoolExecutor(1, "staging-up")
            self._down = ThreadPoolExecutor(1, "staging-down")
        n = int(np.prod(plane))
        self._in: list[_Slot] = []
        self._next_in = self._next_out = 0
        self._out = [_Slot(self._host(n)) for _ in range(SLOTS)]

    def _host(self, n):
        return torch.empty(n, dtype=torch.float32, pin_memory=self.cuda)

    @property
    def host_bytes(self) -> int:
        """Bytes of the slots' host memory (pinned on a CUDA device)."""
        return 4 * sum(s.buf.numel() for s in self._in + self._out)

    def _put(self, arrays, dst):
        """Host ``arrays``, back to back, into the contiguous device tensor
        ``dst`` of their total size, through the next input slot (each
        array cast to float32 in the host copy), once the slot's last copy
        to the card has completed.  Returns the copy's event (None on the
        CPU).  On the card it runs on the upload worker alone."""
        n = sum(a.size for a in arrays)
        if not self._in or self._in[0].buf.numel() < n:
            for slot in self._in:
                if slot.busy is not None:
                    slot.busy.synchronize()
            self._in = [_Slot(self._host(n)) for _ in range(SLOTS)]
        slot = self._in[self._next_in]
        self._next_in = (self._next_in + 1) % SLOTS
        if slot.busy is not None:
            slot.busy.synchronize()
        flat, at = slot.buf.numpy(), 0
        for a in arrays:
            np.copyto(flat[at:at + a.size].reshape(a.shape), a,
                      casting="unsafe")
            at += a.size
        src = slot.buf[:n].view(dst.shape)
        if not self.cuda:
            dst.copy_(src)
            return None
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
        slot.busy = torch.cuda.Event()
        slot.busy.record(self.stream)
        return slot.busy

    def _stage(self, arrays, dst):
        """:meth:`_put`, on the upload worker on the card (its future);
        counted here."""
        n = 4 * sum(a.size for a in arrays)
        tracer.count("h2d_bytes", n)
        tracer.count("staged_bytes", n)
        if not self.cuda:
            return self._put(arrays, dst)
        return self._up.submit(self._put, arrays, dst)

    def _claim(self, dst):
        """Order the copy stream after the compute stream's work so far, so
        that it writes ``dst`` (newly allocated there, perhaps in memory
        that queued work still uses) after that work; and keep ``dst``'s
        memory from reuse until the copy stream's work on it is done."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            dst.record_stream(self.stream)

    def _compute_waits(self, job):
        """The compute stream's later work waits for a staged copy."""
        event = _result(job, "staging_slot")
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def upload(self, a):
        """A host array as a new float32 tensor on the device, which the
        compute stream's later work reads after the copy."""
        a = np.asarray(a)
        dst = torch.empty(a.shape, dtype=torch.float32, device=self.device)
        self._claim(dst)
        self._compute_waits(self._stage([a], dst))
        return dst

    def get(self, t, dest, site):
        """Read the device plane ``t`` back into the host float32 array
        ``dest`` through the next output slot, once the compute stream's
        work so far is done.  On the card the read-back worker writes
        ``dest``; :meth:`finish` waits for it."""
        slot = self._out[self._next_out]
        self._next_out = (self._next_out + 1) % SLOTS
        if slot.busy is not None:
            _result(*slot.busy)
            slot.busy = None
        buf = slot.buf[:t.numel()].view(t.shape)
        tracer.count("staged_bytes", 4 * t.numel())
        if not self.cuda:
            buf.copy_(t)
            np.copyto(dest, buf.numpy())
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            buf.copy_(t, non_blocking=True)
        t.record_stream(self.stream)
        arrived = torch.cuda.Event()
        arrived.record(self.stream)
        slot.busy = (self._down.submit(_copy_out, arrived, slot.buf, dest),
                     site)

    def finish(self):
        """Wait until every read-back has been written to its host array,
        oldest first."""
        for i in range(SLOTS):
            slot = self._out[(self._next_out + i) % SLOTS]
            if slot.busy is not None:
                _result(*slot.busy)
                slot.busy = None

    def steps(self, sources, dst, sb_con):
        """The per-step moves of one run, for ``TriggerPipeline.run``'s
        ``feed``: step t's host arrays ``sources(t)`` into ``dst[t]`` (a
        contiguous (T, ...) device stack), each step's ``sb_con`` plane
        into ``sb_con[t]`` (a (T, nlat, nlon) host array)."""
        self._claim(dst)
        return _Steps(self, sources, dst, sb_con)


class _Steps:
    """One run's staged steps: :meth:`ready` before step t, :meth:`done`
    after it."""

    def __init__(self, stager, sources, dst, sb_con):
        self.stager, self.sources, self.dst = stager, sources, dst
        self.sb_con = sb_con
        self._staged = {}

    def _stage(self, t):
        self._staged[t] = self.stager._stage(self.sources(t), self.dst[t])

    def ready(self, t):
        """Stage step t + 1 (and step 0 first), then make the compute
        stream wait for step t's inputs."""
        if t == 0:
            self._stage(0)
        if t + 1 < len(self.dst):
            self._stage(t + 1)
        self.stager._compute_waits(self._staged.pop(t))

    def done(self, t, sb_con_t):
        """Step t has been enqueued: read its ``sb_con`` plane back."""
        self.stager.get(sb_con_t, self.sb_con[t], "output_readback")
