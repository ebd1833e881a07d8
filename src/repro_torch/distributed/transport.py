"""The data transports under a :class:`~repro_torch.core.grid.ProcessGrid`.

Every payload a grid moves across processes goes through one
:meth:`Transport.exchange`: ``sends[j]``'s bytes go to process ``j`` and
``recvs[j]`` (contiguous bytes, where the caller wants them) fill from
process ``j``, every peer at once. Both sides know every size, so an empty
payload is not sent, and every process makes its calls in the same order
(the grid's collectives are SPMD). A payload travels as its contiguous
byte view (:func:`as_bytes`): no transport sees a dtype, so fp8 wire forms,
unsigned and bool tensors pass bit for bit. With telemetry on, each
exchange is one ``transport/<what>`` span tagged with the transport's name
and its bytes. ``exchange`` returns the payload bytes it moved through host
memory, which the grid counts as ``host_bytes``.

Two transports:

  * :class:`GlooTransport` (``"gloo"``): one ``dist.batch_isend_irecv``
    over the process group. gloo sends host memory, so on the card each
    outgoing payload is copied to the host and each incoming one back.
  * :class:`ShmTransport` (``"shm"``): the paper's PiP exchange for
    processes that share one host and, on the card, one card. A sender
    copies into a slot it owns and its receiver copies straight out of it
    into place: slots in POSIX shared memory for CPU ranks, device memory
    shared through CUDA IPC on the card (``kernels/csrc/ipc.cu``), where a
    payload never touches host memory. Counters in one shared control block
    order the two sides; there is no system call on the way and no copy
    beyond the one into the slot.

A grid handed no transport takes :func:`choose`'s, from what the process
group shows: ``ShmTransport`` when its processes share this card, gloo
otherwise. gloo stays the control plane either way: the process group, the
barriers, the calibration merge, and the collective steps that choose the
transport and set up a ``ShmTransport``'s control block.
"""
from __future__ import annotations

import atexit
import ctypes
import os
import socket
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import telemetry as _tm
from repro_torch.distributed import backend as _backend

#: bytes a ``ShmTransport`` slot holds (each sender owns two a receiver);
#: a larger payload goes in chunks of this size
SLOT_BYTES = 4 << 20

#: a host wait polls this many times, then yields its core between polls
#: for ``YIELD_S`` seconds, then sleeps ``SLEEP_S`` between polls
SPIN_POLLS, YIELD_S, SLEEP_S = 256, 0.05, 1e-4

#: seconds a closing process waits for its peers to unmap its slots
CLOSE_GRACE_S = 30.0

#: bytes of a CUDA IPC memory or event handle
HANDLE_BYTES = 64


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous bytes on its device."""
    flat = t.contiguous().reshape(-1)
    if flat.numel() == 1 and flat.stride(0) != 1:
        # a one-element view may keep any stride
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat.view(torch.uint8)


def _byte_views(sends: Dict[int, torch.Tensor], host: bool = False
                ) -> Dict[int, torch.Tensor]:
    """The non-empty sends as bytes (copied to host memory with ``host``),
    a tensor sent to several peers made once."""
    made: Dict[int, torch.Tensor] = {}
    out = {}
    for j, t in sends.items():
        if t.numel():
            if id(t) not in made:
                made[id(t)] = as_bytes(t).cpu() if host else as_bytes(t)
            out[j] = made[id(t)]
    return out


class Transport:
    """Moves a grid's payloads between processes; see the module
    docstring."""

    name = ""
    #: the device whose tensors it moves (None: any)
    device: Optional[torch.device] = None

    def exchange(self, what: str, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, torch.Tensor]) -> int:
        """Send ``sends[j]``'s bytes to process ``j`` and fill ``recvs[j]``
        (a contiguous ``uint8`` tensor) from process ``j``; returns the
        payload bytes moved through host memory."""
        raise NotImplementedError


class GlooTransport(Transport):
    """One ``dist.batch_isend_irecv`` over the gloo process group, through
    host memory."""

    name = "gloo"

    def exchange(self, what, sends, recvs):
        host = _byte_views(sends, host=True)
        bufs = {j: d if d.device.type == "cpu"
                else torch.empty(d.numel(), dtype=torch.uint8)
                for j, d in recvs.items() if d.numel()}
        if not host and not bufs:
            return 0
        nbytes = sum(b.numel() for b in host.values())
        received = sum(b.numel() for b in bufs.values())
        ops = [dist.P2POp(dist.isend, b, j) for j, b in host.items()]
        ops += [dist.P2POp(dist.irecv, b, j) for j, b in bufs.items()]
        with _tm.span(f"transport/{what}", cat="transport",
                      transport=self.name, bytes_sent=nbytes,
                      bytes_received=received):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for j, b in bufs.items():
            if b is not recvs[j]:
                recvs[j].copy_(b)
        return nbytes + received


# ---------------------------------------------------------------------------
# the shm transport
# ---------------------------------------------------------------------------


def _host_id() -> str:
    """This host: its name and its kernel's boot id."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}/{boot}"


def _card_id(device: torch.device) -> str:
    """The card's UUID (one card has one, whatever a process calls it)."""
    return str(torch.cuda.get_device_properties(device).uuid)


def _shm_free() -> Optional[int]:
    """The bytes free under ``/dev/shm``, where POSIX shared memory lives
    (None where there is no such directory)."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


def _attach(name: str) -> shared_memory.SharedMemory:
    """Map a segment another process created; only its creator unlinks it
    (Python 3.12's tracker would also unlink it at this process's exit)."""
    shm = shared_memory.SharedMemory(name=name)
    resource_tracker.unregister(shm._name, "shared_memory")
    return shm


class _Block:
    """The control block of ``n`` processes in shared memory: per ordered
    pair ``(s, d)`` the chunks ``s`` has posted to ``d`` and ``d`` has
    consumed (aligned int64 stores), per process whether it is done, and
    per pair the CUDA handles: the slots' memory, the sender's two slot
    events and the receiver's two."""

    def __init__(self, shm: shared_memory.SharedMemory, n: int):
        self.shm, self.n = shm, n
        words = np.ndarray((2 * n * n + n,), np.int64, shm.buf)
        self.posted = words[:n * n].reshape(n, n)
        self.consumed = words[n * n:2 * n * n].reshape(n, n)
        self.done = words[2 * n * n:]
        self.handles = np.ndarray((n, n, 5, HANDLE_BYTES), np.uint8, shm.buf,
                                  offset=words.nbytes)

    @staticmethod
    def size(n: int) -> int:
        return (2 * n * n + n) * 8 + n * n * 5 * HANDLE_BYTES

    def release(self) -> None:
        """Drop the views so the mapping can close."""
        self.posted = self.consumed = self.done = None
        self.handles = None


def _ipc():
    from repro_torch.kernels import _build
    return _build.load("ipc")


def _ipc_call(lib, fn: str, *args) -> None:
    err = getattr(lib, fn)(*args)
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.ipc_error_string(err).decode()})")


class _Mapped:
    """``n`` bytes of device memory at ``ptr``, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


class _Pair:
    """One direction of one pair of processes: the sender's two slots (made
    by the sender, mapped by the receiver) and, on the card, the sender's
    and the receiver's interprocess event for each slot (``mine``: this
    process's, ``theirs``: the peer's, opened at first use)."""

    def __init__(self):
        self.slots: List[torch.Tensor] = []
        self.mine: List[torch.cuda.Event] = []
        self.theirs: List[torch.cuda.Event] = []
        self.shm: Optional[shared_memory.SharedMemory] = None
        self.ptr = 0


class ShmTransport(Transport):
    """The PiP exchange between processes of one host (on the card: of one
    card) on ``device``. Built by :func:`choose` at the first grid on the
    card of a process group whose processes share it, or directly and
    handed to the grids that use it; every process of the group must build
    it, in the same order, since it takes one collective step over gloo:
    process 0 creates the control block and every process sends its host,
    its card, its slot capacity and, on CPU ranks, the free bytes of
    ``/dev/shm``. A process on another host or, on ``cuda``, another card
    raises ``ValueError`` on every process, as do CPU slots that
    ``/dev/shm`` cannot hold (every pair's, ``n (n - 1) 2 capacity``
    bytes, which would otherwise end a process by ``SIGBUS`` at its first
    write past the limit).

    The protocol, one for both devices. Sender ``s`` owns two slots of
    ``capacity`` bytes for each receiver ``d``, made at the pair's first
    exchange (its handles go into the block, so no collective step is
    needed); chunk ``c`` of the pair goes into slot ``c % 2``.

      * Sender: once ``consumed[s, d] >= c - 1`` (chunk ``c - 2`` read)
        and, on the card, behind the receiver's event of that slot, it
        copies the chunk into the slot on its current stream, records its
        own event of the slot, and only then stores ``posted[s, d] = c +
        1``.
      * Receiver: once ``posted[s, d] >= c + 1`` it waits on the sender's
        event of the slot (a stream wait: ``cudaStreamWaitEvent`` waits for
        the last record issued before it, which the order of the host's
        stores makes chunk ``c``'s), copies the slot straight into place on
        its stream, records its own event of the slot and stores
        ``consumed[s, d] = c + 1``.

    Every exchange advances all its peers' chunks together, so two
    processes sending each other more than two chunks never wait on each
    other. A host wait spins, then yields, then sleeps between polls
    (``SPIN_POLLS``, ``YIELD_S``, ``SLEEP_S``), and raises
    ``RuntimeError`` naming the peer, the pair and the chunk after
    ``timeout_s`` (``backend.TIMEOUT_S``): a lost peer fails, it does not
    hang. The counters rely on the host's stores becoming visible in
    order (x86).

    CPU ranks keep their slots in POSIX shared memory; on the card the
    slots come from ``cudaMalloc`` (``kernels/csrc/ipc.cu``), are exported
    by ``cudaIpcGetMemHandle`` and mapped by the receiver, and become
    tensors through ``__cuda_array_interface__``. ``slot_bytes`` is what
    this process allocated for them (PyTorch's allocator does not see it).
    :meth:`close` (also at exit) unmaps the peers' slots, marks this
    process done, waits up to ``CLOSE_GRACE_S`` for every peer to do the
    same, then frees its own: a handle is closed before its owner frees
    it, and an exit does not hang on a lost peer."""

    name = "shm"

    def __init__(self, device: Union[str, torch.device],
                 capacity: int = SLOT_BYTES,
                 timeout_s: Optional[float] = None):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the shm transport runs on cpu or cuda, not "
                             f"{self.device}")
        if int(capacity) < 1:
            raise ValueError(f"slot capacity {capacity} < 1 byte")
        self.capacity = int(capacity)
        self.timeout_s = (_backend.TIMEOUT_S if timeout_s is None
                          else float(timeout_s))
        be = _backend.current_backend()
        self.rank, self.n = be.process_index, be.process_count
        self.slot_bytes = 0
        self._out: Dict[int, _Pair] = {}
        self._in: Dict[int, _Pair] = {}
        self._sent = [0] * self.n
        self._taken = [0] * self.n
        self._block: Optional[_Block] = None
        self._closed = False
        if self.n > 1:
            self._join()
            atexit.register(self.close)

    def __repr__(self) -> str:
        return (f"ShmTransport({self.device}, capacity={self.capacity}, "
                f"rank={self.rank} of {self.n})")

    # -- set-up and teardown --------------------------------------------------

    def _join(self) -> None:
        """The one collective step: process 0 creates the block; every
        process sends its host, card, capacity and free ``/dev/shm`` bytes
        over gloo; a process that does not fit raises on every process; the
        others map the block."""
        mine = shared_memory.SharedMemory(
            create=True, size=_Block.size(self.n)) if self.rank == 0 \
            else None
        cuda = self.device.type == "cuda"
        info = {"host": _host_id(), "capacity": self.capacity,
                "card": _card_id(self.device) if cuda else None,
                "shm_free": None if cuda else _shm_free(),
                "block": mine.name if mine else None}
        every: List[dict] = [None] * self.n
        try:
            dist.all_gather_object(every, info)
            self._check(every)
            shm = mine or _attach(every[0]["block"])
        except BaseException:
            if mine is not None:
                mine.close()
                mine.unlink()
            raise
        self._block = _Block(shm, self.n)

    def _check(self, every: List[dict]) -> None:
        for what, label in (("host", "host"), ("card", "card")):
            seen = [e[what] for e in every]
            if len(set(seen)) > 1:
                raise ValueError(
                    f"a 'shm' transport needs every process on one {label}: "
                    f"processes {list(range(self.n))} report {seen}. "
                    f"Processes on several hosts or cards exchange over "
                    f"NCCL with one process a card, ROADMAP queue 1 item "
                    f"5b; until then a grid handed no transport uses gloo "
                    f"there")
        caps = [e["capacity"] for e in every]
        if len(set(caps)) > 1:
            raise ValueError(f"'shm' slot capacities differ across "
                             f"processes: {caps}")
        free = [e["shm_free"] for e in every if e["shm_free"] is not None]
        need = self.n * (self.n - 1) * 2 * self.capacity
        if free and min(free) < need:
            raise ValueError(
                f"'shm' slots of {self.n} CPU processes need {need} bytes "
                f"of /dev/shm ({self.n * (self.n - 1)} pairs of two "
                f"{self.capacity}-byte slots) and it has {min(free)} free: "
                f"{need - min(free)} short. Give a smaller capacity or use "
                f"GlooTransport()")

    def close(self) -> None:
        """Unmap the peers' slots, mark this process done, wait (bounded)
        for every peer to be done, free this process's slots, and unmap the
        block (process 0 unlinks it). Idempotent."""
        if self._closed or self._block is None:
            self._closed = True
            return
        self._closed = True
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        for pair in self._in.values():
            pair.slots = []
            pair.theirs = pair.mine = []
            if cuda:
                _ipc_call(_ipc(), "ipc_close", self.device.index or 0,
                          pair.ptr)
            else:
                pair.shm.close()
        block = self._block
        block.done[self.rank] = 1
        t0 = time.monotonic()
        while not block.done.all() and \
                time.monotonic() - t0 < CLOSE_GRACE_S:
            time.sleep(SLEEP_S)
        for pair in self._out.values():
            pair.slots = []
            pair.theirs = pair.mine = []
            if cuda:
                _ipc_call(_ipc(), "ipc_free", self.device.index or 0,
                          pair.ptr)
            else:
                pair.shm.close()
                pair.shm.unlink()
        self._out, self._in = {}, {}
        block.release()
        block.shm.close()
        if self.rank == 0:
            block.shm.unlink()
        self._block = None

    # -- the pairs' slots -----------------------------------------------------

    def _segment(self, s: int, d: int) -> str:
        return f"{self._block.shm.name}_{s}_{d}"

    def _slots_at(self, ptr: int) -> List[torch.Tensor]:
        return [torch.as_tensor(_Mapped(ptr + k * self.capacity,
                                        self.capacity), device=self.device)
                for k in (0, 1)]

    def _events(self) -> List[torch.cuda.Event]:
        return [torch.cuda.Event(interprocess=True) for _ in (0, 1)]

    def _out_pair(self, d: int) -> _Pair:
        """This process's slots for receiver ``d``, made and published at
        the pair's first chunk."""
        pair = self._out.get(d)
        if pair is not None:
            return pair
        pair = _Pair()
        size = 2 * self.capacity
        if self.device.type == "cuda":
            ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(
                HANDLE_BYTES)
            _ipc_call(_ipc(), "ipc_alloc", self.device.index or 0, size,
                      ctypes.byref(ptr), handle)
            pair.ptr = ptr.value
            pair.slots = self._slots_at(pair.ptr)
            pair.mine = self._events()
            row = self._block.handles[self.rank, d]
            row[0] = np.frombuffer(handle.raw, np.uint8)
            for k, ev in enumerate(pair.mine):
                row[1 + k] = np.frombuffer(ev.ipc_handle(), np.uint8)
        else:
            pair.shm = shared_memory.SharedMemory(
                create=True, size=size, name=self._segment(self.rank, d))
            pair.slots = [torch.frombuffer(pair.shm.buf, dtype=torch.uint8,
                                           count=self.capacity,
                                           offset=k * self.capacity)
                          for k in (0, 1)]
        self.slot_bytes += size
        self._out[d] = pair
        return pair

    def _in_pair(self, s: int) -> _Pair:
        """Sender ``s``'s slots for this process, mapped at the pair's
        first chunk (its handles are in the block by then); on the card
        this process's events for them are published before the first
        ``consumed`` store, which is when the sender first needs them."""
        pair = self._in.get(s)
        if pair is not None:
            return pair
        pair = _Pair()
        if self.device.type == "cuda":
            row = self._block.handles[s, self.rank]
            ptr = ctypes.c_void_p()
            _ipc_call(_ipc(), "ipc_open", self.device.index or 0,
                      row[0].tobytes(), ctypes.byref(ptr))
            pair.ptr = ptr.value
            pair.slots = self._slots_at(pair.ptr)
            pair.theirs = [torch.cuda.Event.from_ipc_handle(
                self.device, row[1 + k].tobytes()) for k in (0, 1)]
            pair.mine = self._events()
            for k, ev in enumerate(pair.mine):
                row[3 + k] = np.frombuffer(ev.ipc_handle(), np.uint8)
        else:
            pair.shm = _attach(self._segment(s, self.rank))
            pair.slots = [torch.frombuffer(pair.shm.buf, dtype=torch.uint8,
                                           count=self.capacity,
                                           offset=k * self.capacity)
                          for k in (0, 1)]
        self._in[s] = pair
        return pair

    # -- one chunk each way ---------------------------------------------------

    def _post(self, d: int, src: torch.Tensor, off: int) -> int:
        """Chunk ``self._sent[d]`` of ``src`` from byte ``off`` into its
        slot, if the slot is free; the bytes posted (0: not yet)."""
        c = self._sent[d]
        if c >= 2 and self._block.consumed[self.rank, d] < c - 1:
            return 0
        pair = self._out_pair(d)
        k, n = c % 2, min(self.capacity, src.numel() - off)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if c >= 2:
                if not pair.theirs:
                    row = self._block.handles[self.rank, d]
                    pair.theirs = [torch.cuda.Event.from_ipc_handle(
                        self.device, row[3 + j].tobytes()) for j in (0, 1)]
                stream.wait_event(pair.theirs[k])
            pair.slots[k][:n].copy_(src[off:off + n])
            pair.mine[k].record(stream)
        else:
            pair.slots[k][:n].copy_(src[off:off + n])
        self._block.posted[self.rank, d] = c + 1
        self._sent[d] = c + 1
        return n

    def _take(self, s: int, dst: torch.Tensor, off: int) -> int:
        """Chunk ``self._taken[s]`` from sender ``s`` into ``dst`` at byte
        ``off``, if it was posted; the bytes taken (0: not yet)."""
        c = self._taken[s]
        if self._block.posted[s, self.rank] < c + 1:
            return 0
        pair = self._in_pair(s)
        k, n = c % 2, min(self.capacity, dst.numel() - off)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pair.theirs[k])
            dst[off:off + n].copy_(pair.slots[k][:n])
            pair.mine[k].record(stream)
        else:
            dst[off:off + n].copy_(pair.slots[k][:n])
        self._block.consumed[s, self.rank] = c + 1
        self._taken[s] = c + 1
        return n

    def _stuck(self, what, sends, recvs, waited) -> RuntimeError:
        me = self.rank
        if recvs:
            j = next(iter(recvs))
            pair, seq, verb = f"{j}->{me}", self._taken[j], "post"
        else:
            j = next(iter(sends))
            pair, seq, verb = f"{me}->{j}", self._sent[j] - 2, "consume"
        return RuntimeError(
            f"shm transport ({what}): process {me} waited {waited:.1f} s "
            f"for process {j} to {verb} chunk {seq} of pair {pair} "
            f"(timeout {self.timeout_s} s): the peer is lost or out of step")

    # -- the exchange ---------------------------------------------------------

    def exchange(self, what, sends, recvs):
        if self._closed:
            raise RuntimeError("exchange on a closed shm transport")
        out = {j: [b, 0] for j, b in _byte_views(sends).items()}
        inn = {j: [d, 0] for j, d in recvs.items() if d.numel()}
        if not out and not inn:
            return 0
        nbytes = sum(b.numel() for b, _ in out.values())
        received = sum(d.numel() for d, _ in inn.values())
        if self.device.type == "cpu":
            host = nbytes + received
        else:
            host = sum(b.numel() for b, _ in (*out.values(), *inn.values())
                       if b.device.type == "cpu")
        with _tm.span(f"transport/{what}", cat="transport",
                      transport=self.name, bytes_sent=nbytes,
                      bytes_received=received):
            self._run(what, out, inn)
        return host

    def _run(self, what, out, inn) -> None:
        """Advance every peer's chunks until all are posted and taken."""
        idle, t0 = 0, 0.0
        while out or inn:
            moved = False
            for peers, step in ((out, self._post), (inn, self._take)):
                for j in list(peers):
                    buf, off = peers[j]
                    n = step(j, buf, off)
                    if n:
                        moved = True
                        if off + n == buf.numel():
                            del peers[j]
                        else:
                            peers[j][1] = off + n
            if moved:
                idle = 0
                continue
            idle += 1
            if idle <= SPIN_POLLS:
                continue
            now = time.monotonic()
            if idle == SPIN_POLLS + 1:
                t0 = now
            elif now - t0 > self.timeout_s:
                raise self._stuck(what, out, inn, now - t0)
            if now - t0 < YIELD_S:
                os.sched_yield()
            else:
                time.sleep(SLEEP_S)


#: this process's chosen transport per (process group, device): the
#: choice's collective step and a ShmTransport's control block are made
#: once per process group
_CHOSEN: Dict[tuple, Transport] = {}


def choose(device: Union[str, torch.device]) -> Transport:
    """The transport of a grid on ``device`` that is handed none, from what
    the process group shows: on the card, :class:`ShmTransport` when every
    process of the group is on this host and this card (device UUIDs, one
    collective step over gloo at the group's first such grid, on every
    process), and gloo when they are not (other hosts or cards exchange
    over NCCL, ROADMAP queue 1 item 5b, not there yet). CPU ranks, ``meta``
    and a group of one process take gloo with no collective step: CPU
    slots would hold ``n (n - 1) 2 SLOT_BYTES`` of the host's ``/dev/shm``,
    which other processes share, so a CPU ``ShmTransport`` is made only
    when it is asked for. The card's processes share one
    ``ShmTransport``."""
    device = torch.device(device)
    be = _backend.current_backend()
    if device.type != "cuda" or be.process_count == 1:
        return GlooTransport()
    key = (be.process_count, be.process_index, be.coordinator, str(device))
    hit = _CHOSEN.get(key)
    if hit is None or getattr(hit, "_closed", False):
        every: List[tuple] = [None] * be.process_count
        dist.all_gather_object(every, (_host_id(), _card_id(device)))
        hit = _CHOSEN[key] = ShmTransport(device) \
            if len(set(every)) == 1 else GlooTransport()
    return hit


__all__ = ["SLOT_BYTES", "GlooTransport", "ShmTransport", "Transport",
           "as_bytes", "choose"]
