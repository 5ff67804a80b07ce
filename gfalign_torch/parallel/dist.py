"""Multi-process distribution on torch.distributed.

The port of gfalign_tpu/parallel/dist.py.  A distributed run is N processes
launched as torchrun launches them (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT and, optionally, LOCAL_RANK / LOCAL_WORLD_SIZE in the
environment) with GFALIGN_TORCH_DISTRIBUTED set:

  * `init_if_requested` joins the gloo process group (a no-op otherwise,
    and for one process);
  * each process loads its shard of the records (`shard_records`, or the
    qname shard of AlignmentSet.load) and scores on its own device;
  * integer tallies are summed with `allreduce_stats` and byte blobs
    gathered with `allgather_bytes`.

Ranks that share a host (two ranks on one H100, say) cannot form an NCCL
communicator on one card, and what they exchange is host integers and
bytes anyway, so nothing here touches NCCL.  `allreduce_stats` runs over a
/dev/shm exchange (`_ShmExchange`) when every rank can map it, else over a
gloo all_reduce; the ranks agree on one transport through the process
group's store the first time it is needed, and keep it for the run.  The
native search driver exchanges its tallies over a second /dev/shm mapping,
`_ShmRing`, whose protocol lives in native/gfalign_host.cpp (RingX).

Every wait is bounded by `wait_seconds()` (GFALIGN_TORCH_DIST_TIMEOUT,
default 300 s), the gloo collectives and store reads included: a dead or
missing peer raises RuntimeError naming the rank that was waited for,
instead of holding the others forever.  The gathers that end a run
(`allgather_bytes`) wait for the slowest shard, however long its work
takes, and are bounded by the peers' liveness instead: each process beats
a heartbeat into the rendezvous store (`_live`), and `wait_for_peers`
raises only when a peer it waits for has not beaten for wait_seconds().

Single-process runs degrade to identity (process_count == 1), so every
engine can call these unconditionally.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Iterable, Iterator, List, Tuple, TypeVar

import numpy as np

from ..utils.log import lg

T = TypeVar("T")

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def wait_seconds() -> float:
    """The bound on every wait for a peer: GFALIGN_TORCH_DIST_TIMEOUT
    seconds, default 300."""
    return float(os.environ.get("GFALIGN_TORCH_DIST_TIMEOUT", "300"))


def init_if_requested() -> None:
    """Join the gloo process group when GFALIGN_TORCH_DISTRIBUTED is set and
    the torchrun environment names more than one process; otherwise (and
    when already joined) do nothing."""
    if not os.environ.get("GFALIGN_TORCH_DISTRIBUTED"):
        return
    if not all(os.environ.get(k) for k in _ENV) or int(os.environ["WORLD_SIZE"]) <= 1:
        return
    import torch.distributed as td

    if td.is_initialized():
        return
    td.init_process_group("gloo", init_method="env://",
                          timeout=timedelta(seconds=wait_seconds()))
    _live()


def process_info() -> Tuple[int, int]:
    """(process_index, process_count): (0, 1) when not distributed."""
    import torch.distributed as td

    if td.is_available() and td.is_initialized():
        return td.get_rank(), td.get_world_size()
    return 0, 1


def rank_device(device):
    """The device this rank scores on: for CUDA, card LOCAL_RANK modulo the
    card count (every rank of a one-card box shares cuda:0), made current;
    any other device as given."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("this rank scores on CUDA and no CUDA device is "
                           "available")
    index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _store():
    import torch.distributed.distributed_c10d as c10d

    return c10d._get_default_store()


def _store_get(store, key: str, rank: int) -> str:
    """The value rank `rank` set under `key`, waiting at most
    wait_seconds()."""
    try:
        store.wait([key], timedelta(seconds=wait_seconds()))
    except RuntimeError as exc:
        raise RuntimeError(f"rank {process_info()[0]}: rank {rank} did not set "
                           f"{key!r} within {wait_seconds():g} s") from exc
    return store.get(key).decode()


def _tag() -> str:
    """The run's name in /dev/shm file names and store keys: the rendezvous
    address, so runs on different ports never share a file."""
    addr = f"{os.environ.get('MASTER_ADDR', 'na')}:{os.environ.get('MASTER_PORT', '0')}"
    return "".join(ch if ch.isalnum() else "_" for ch in addr)


_LOCAL_COUNT = [0]


def local_process_count() -> int:
    """Number of job processes running on THIS host (>= 1): LOCAL_WORLD_SIZE
    when torchrun sets it, else a one-time hostname census through the
    process group's store.  Divides host cores among co-located processes
    (the distributed align caps each process's native thread pool at
    cores / local_process_count)."""
    if _LOCAL_COUNT[0]:
        return _LOCAL_COUNT[0]
    pid, count = process_info()
    if count == 1:
        _LOCAL_COUNT[0] = 1
    elif os.environ.get("LOCAL_WORLD_SIZE"):
        _LOCAL_COUNT[0] = max(1, int(os.environ["LOCAL_WORLD_SIZE"]))
    else:
        import socket

        store = _store()
        host = socket.gethostname()
        store.set(f"gfalign/host/{pid}", host)
        _LOCAL_COUNT[0] = max(1, sum(_store_get(store, f"gfalign/host/{p}", p) == host
                                     for p in range(count)))
    return _LOCAL_COUNT[0]


def shard_records(records: Iterable[T],
                  process_index: int | None = None,
                  process_count: int | None = None) -> Iterator[T]:
    """Yield this host's shard: records with index % count == index."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    for i, rec in enumerate(records):
        if i % process_count == process_index:
            yield rec


class _ShmFile:
    """A /dev/shm mapping shared by the ranks of one host.  Rank 0 creates
    it with O_TRUNC (a file left by a crashed run with the same tag must
    not leak stale sequence cells into this one), writes a random token at
    word 0 and publishes the token through the store; every other rank
    maps the file and requires the same token, so two containers that
    merely share a path fail here instead of exchanging nothing."""

    def __init__(self, kind: str, n_words: int, pid: int, tag: str):
        import mmap

        store = _store()
        self._path = f"/dev/shm/gfalign_torch_{kind}_{tag}"
        key = f"gfalign/{kind}/{tag}/token"
        size = n_words * 8
        if pid == 0:
            try:
                fd = os.open(self._path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
                try:
                    os.ftruncate(fd, size)
                    self._mm = mmap.mmap(fd, size)
                finally:
                    os.close(fd)
            except OSError:
                store.set(key, "none")               # tell the peers at once
                raise
            self.arr = np.frombuffer(self._mm, dtype=np.int64)
            token = int.from_bytes(os.urandom(7), "little")
            self.arr[0] = token
            store.set(key, str(token))
            import atexit

            atexit.register(self.unlink)
        else:
            want = _store_get(store, key, 0)
            if want == "none":
                raise RuntimeError(f"rank 0 could not create {self._path}")
            fd = os.open(self._path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self.arr = np.frombuffer(self._mm, dtype=np.int64)
            if int(self.arr[0]) != int(want):
                raise RuntimeError(f"{self._path}: token mismatch (not the same host?)")

    def unlink(self) -> None:
        try:
            os.unlink(self._path)
        except OSError:
            pass


def _spin_until(cell: np.ndarray, index: int, want: int, pid: int, peer: int,
                what: str) -> None:
    """Wait until cell[index] >= want, yielding and then sleeping between
    reads; RuntimeError after wait_seconds()."""
    spins = 0
    deadline = None
    while cell[index] < want:
        spins += 1
        if spins > 2000:
            if deadline is None:
                deadline = time.monotonic() + wait_seconds()
            elif time.monotonic() > deadline:
                raise RuntimeError(f"rank {pid}: no word from rank {peer} within "
                                   f"{wait_seconds():g} s ({what} {want})")
            time.sleep(0.0002)
        else:
            time.sleep(0)


class _ShmExchange:
    """Same-host cross-process int64 allreduce over a /dev/shm mapping.

    Per-frontier tally merges are small (a few KB) and latency-bound: a
    shared-memory exchange costs microseconds where a gloo all_reduce
    costs a socket round trip per peer.  Layout: the token, then per
    process two parity buffers (double buffering: a peer can be one
    sequence ahead, never two, because advancing requires reading every
    peer's current buffer) of [seq, len, data[WIDTH]] int64.  x86 TSO keeps
    the data-then-seq store order; the seq store is one aligned int64
    write.  Vectors longer than WIDTH go through in WIDTH-long rounds."""

    WIDTH = 4096

    def __init__(self, pid: int, count: int, tag: str):
        self.pid, self.count = pid, count
        self._slot = 2 + self.WIDTH
        self._file = _ShmFile("ar", 1 + count * 2 * self._slot, pid, tag)
        self._arr = self._file.arr
        self._seq = 0

    def _buf(self, pid: int, parity: int) -> np.ndarray:
        base = 1 + (pid * 2 + parity) * self._slot
        return self._arr[base:base + self._slot]

    def _round(self, vec: np.ndarray) -> np.ndarray:
        self._seq += 1
        s = self._seq
        n = vec.shape[0]
        mine = self._buf(self.pid, s % 2)
        mine[2:2 + n] = vec
        mine[1] = n
        mine[0] = s                            # release: data before seq
        acc = vec.copy()
        for peer in range(self.count):
            if peer == self.pid:
                continue
            pb = self._buf(peer, s % 2)
            _spin_until(pb, 0, s, self.pid, peer, "allreduce")
            if pb[1] != n:
                raise RuntimeError(f"rank {self.pid}: rank {peer} sent {pb[1]} "
                                   f"values to allreduce {s}, this rank {n}")
            acc += pb[2:2 + n]
        return acc

    def allreduce(self, totals) -> List[int]:
        vec = np.asarray(totals, dtype=np.int64).reshape(-1)
        if vec.shape[0] == 0:
            return []
        return [int(v) for lo in range(0, vec.shape[0], self.WIDTH)
                for v in self._round(vec[lo:lo + self.WIDTH])]


class _ShmRing:
    """Pipelined tally ring for the native search driver (the C++ side of
    the protocol is native/gfalign_host.cpp RingX; see there for the
    ordering argument).  Python only creates, maps and resets the buffer;
    publication and draining happen in native code.

    Layout (int64): [token][drained counter x count][count x SLOTS slots
    of [seq, len, data[WIDTH]]]."""

    WIDTH = 16384
    SLOTS = 8

    def __init__(self, pid: int, count: int, tag: str):
        self.pid, self.count = pid, count
        self._slot = 2 + self.WIDTH
        self._file = _ShmFile("ring", 1 + count + count * self.SLOTS * self._slot,
                              pid, tag)
        self._arr = self._file.arr

    def reset_local(self) -> None:
        """Zero this process's drained counter and slot seq cells so a new
        search starts from batch 0 (each process resets only cells it
        owns; callers barrier afterwards)."""
        self._arr[1 + self.pid] = 0
        base = 1 + self.count + self.pid * self.SLOTS * self._slot
        for s in range(self.SLOTS):
            self._arr[base + s * self._slot] = 0

    @property
    def address(self) -> int:
        return int(self._arr.ctypes.data)


_SHM: list = [None]   # None = not agreed yet, False = gloo, else the exchange
_RING: list = [None]


def _agree(kind: str, make):
    """Build a same-host mapping on every rank, or on none: each rank
    reports through the store whether it mapped the file, and the mapping
    is used only when every rank did.  Returns the object or False, the
    same answer on every rank."""
    pid, count = process_info()
    store = _store()
    tag = _tag()
    try:
        got = make(pid, count, tag)
    except (OSError, RuntimeError, ValueError) as exc:
        lg.verbose(f"rank {pid}: no /dev/shm {kind}: {exc}")
        got = None
    store.set(f"gfalign/{kind}/{tag}/ok/{pid}", "1" if got is not None else "0")
    every = all(_store_get(store, f"gfalign/{kind}/{tag}/ok/{p}", p) == "1"
                for p in range(count))
    if every:
        return got
    if got is not None and pid == 0:
        got._file.unlink()
    return False


def _shm_exchange():
    """The agreed allreduce transport of this run, settled once: the
    /dev/shm exchange, or False for gloo.  Logged once, by rank 0."""
    if _SHM[0] is None:
        _SHM[0] = _agree("ar", _ShmExchange)
        pid, count = process_info()
        if pid == 0:
            lg.info(f"{count} processes: allreduce over "
                    f"{'/dev/shm' if _SHM[0] else 'gloo'}")
    return _SHM[0]


def _shm_ring():
    """The native driver's /dev/shm tally ring, or False; agreed by every
    rank as `_shm_exchange` is."""
    if _RING[0] is None:
        _RING[0] = _agree("ring", _ShmRing)
    return _RING[0]


def allreduce_stats(totals: List[int]) -> List[int]:
    """Sum int totals across all processes: over /dev/shm when every rank
    maps it, else one gloo all_reduce of an int64 tensor.  With one
    process this is the identity.  Exact: int64 addition is associative."""
    _, count = process_info()
    if count == 1:
        return list(totals)
    ex = _shm_exchange()
    if ex:
        return ex.allreduce(totals)
    import torch
    import torch.distributed as td

    t = torch.tensor(np.asarray(totals, dtype=np.int64).reshape(-1))
    if t.numel():
        td.all_reduce(t)
    return [int(v) for v in t.tolist()]


_HEART: list = [None]    # (store client, its lock) once the heartbeat runs
_ARRIVALS = [0]


def _live():
    """This process's own client of the rendezvous store (MASTER_ADDR,
    MASTER_PORT) and its lock, with the heartbeat started on first use: a
    daemon thread that counts up the key gfalign/<tag>/beat/<rank> every
    wait_seconds() / 8 (at most 1 s) until the process exits.  A second
    client, so that neither the heartbeat nor `wait_for_peers` ever waits
    behind a blocking read of the process group's store."""
    if _HEART[0] is None:
        import atexit
        import threading

        import torch.distributed as td

        store = td.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                            is_master=False, timeout=timedelta(seconds=wait_seconds()))
        lock = threading.Lock()
        stop = threading.Event()
        key = f"gfalign/{_tag()}/beat/{process_info()[0]}"
        period = min(1.0, wait_seconds() / 8)

        def beat():
            n = 0
            while not stop.is_set():
                n += 1
                try:
                    with lock:
                        store.set(key, str(n))
                except RuntimeError:      # the store's host has exited
                    return
                stop.wait(period)

        thread = threading.Thread(target=beat, name="gfalign-heartbeat", daemon=True)
        thread.start()

        def halt():
            stop.set()
            thread.join(timeout=5)

        atexit.register(halt)
        _HEART[0] = (store, lock)
    return _HEART[0]


def wait_for_peers(what: str) -> None:
    """Return once every process has made its matching call (the n-th call
    of each, all for `what`), however long that takes while the peers
    still beat; RuntimeError naming the peer when one has not beaten for
    wait_seconds(), or when a peer's n-th call was for something else.
    For the waits that end a run, whose length is the slowest shard's
    work and not a property of the exchange."""
    pid, count = process_info()
    if count == 1:
        return
    store, lock = _live()
    tag = _tag()
    _ARRIVALS[0] += 1
    base = f"gfalign/{tag}/arrived/{_ARRIVALS[0]}/"
    with lock:
        store.set(base + str(pid), what)
    last = {}                      # peer -> (beat seen, when it changed)
    waiting = [p for p in range(count) if p != pid]
    pause = 0.001
    while waiting:
        now = time.monotonic()
        still = []
        for p in waiting:
            beat_key = f"gfalign/{tag}/beat/{p}"
            with lock:
                arrived = store.check([base + str(p)])
                got = store.get(base + str(p)).decode() if arrived else None
                beat = store.get(beat_key) if not arrived and store.check([beat_key]) \
                    else None
            if arrived:
                if got != what:
                    raise RuntimeError(f"rank {pid}: rank {p} reached {got!r} where "
                                       f"this rank reached {what!r}")
                continue
            seen = last.get(p)
            if seen is None or seen[0] != beat:
                last[p] = (beat, now)
            elif now - seen[1] > wait_seconds():
                raise RuntimeError(f"rank {pid}: rank {p} has not beaten for "
                                   f"{wait_seconds():g} s and has not reached {what!r}")
            still.append(p)
        waiting = still
        if waiting:
            time.sleep(pause)
            pause = min(2 * pause, 0.05)


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Gather one bytes blob from every process, in process order: an
    all_gather of sizes, then one padded uint8 all_gather over gloo, once
    every process has arrived (`wait_for_peers`: the gathers that end a
    run wait for the slowest shard while its process lives).
    Single-process runs degrade to [payload]."""
    _, count = process_info()
    if count == 1:
        return [payload]
    wait_for_peers("allgather_bytes")
    import torch
    import torch.distributed as td

    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(count)]
    td.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    width = max(max(sizes), 1)
    buf = torch.zeros(width, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    parts = [torch.zeros(width, dtype=torch.uint8) for _ in range(count)]
    td.all_gather(parts, buf)
    return [parts[i][:sizes[i]].numpy().tobytes() for i in range(count)]


def launch_local(argv, nproc: int, timeout: float, logs, env=None,
                 cwd=None) -> List[Tuple[int, str, str]]:
    """Run `nproc` processes of `python argv...` on this host as torchrun
    launches them (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE,
    MASTER_ADDR 127.0.0.1 and a free MASTER_PORT, GLOO_SOCKET_IFNAME lo,
    GFALIGN_TORCH_DISTRIBUTED=1, then `env`) and wait for all of them;
    their output goes through files named by rank under the directory
    `logs`.  Returns [(returncode, stdout, stderr)] by rank.  When
    `timeout` seconds pass first, every rank is killed and RuntimeError
    raised with the tails of their stderr."""
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    logs = pathlib.Path(logs)
    procs, files = [], []
    try:
        for rank in range(nproc):
            files.append((open(logs / f"rank{rank}_{port}.out", "w+"),
                          open(logs / f"rank{rank}_{port}.err", "w+")))
            procs.append(subprocess.Popen(
                [sys.executable, *map(str, argv)], cwd=cwd,
                stdout=files[-1][0], stderr=files[-1][1],
                env={**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
                     "WORLD_SIZE": str(nproc), "LOCAL_WORLD_SIZE": str(nproc),
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                     "GLOO_SOCKET_IFNAME": "lo", "GFALIGN_TORCH_DISTRIBUTED": "1",
                     **(env or {})}))
        deadline = time.monotonic() + timeout
        expired = False
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                expired = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    if expired:
        raise RuntimeError(f"{nproc} ranks still running after {timeout:g} s, all "
                           f"killed; stderr tails {[t[1][-1500:] for t in texts]}")
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, texts)]


def barrier() -> None:
    """Wait for every process (a one-element allreduce on the agreed
    transport)."""
    allreduce_stats([0])
