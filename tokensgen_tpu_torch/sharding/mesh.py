"""Process groups of the port: the FIFO's ``queue`` axis over several GPUs
(port of the queue axis of `tokensgen_tpu/sharding/mesh.py`).

The JAX package lays the lookahead rank windows of a FIFO iteration on the
devices of a mesh's ``queue`` axis and merges them with a `psum`, all inside
one SPMD program. Here every device is a process of its own in a
`torch.distributed` group: NCCL on the card, one card a rank, and Gloo on
the host. Rank 0 runs everything outside the FIFO and sends the other ranks
what they need; every rank runs its block of windows, and one sum
all-reduce a FIFO iteration merges them.

* `MeshSpec`: the mesh's axes; only ``queue`` may be above 1 (the ``data``
  and ``model`` axes are ROADMAP A12).
* `QueueGroup`: one process's place in the group: its rank, the group's
  size, its device, the collectives (sum all-reduce, a check that a value
  agrees on every rank) and `send` / `receive`, which move a nested
  structure of tensors from rank 0 to the others: its skeleton through the
  rendezvous store, its tensors in one broadcast.
* `launch(fn, n)` spawns ``n`` workers (``torch.multiprocessing``, start
  method ``spawn``); rank ``r`` calls ``fn(group, *args)`` and rank 0's
  return value comes back. `start_followers(fn, n)` makes the caller rank
  0 and spawns ranks 1 to n - 1 (the server's layout).

The rendezvous is a ``FileStore`` in a fresh temporary directory, so two
groups on one machine never collide on a port. Every collective runs under
the group's timeout; a worker that dies ends the launch at once, and the
others are stopped (``join``). Asking for more NCCL ranks than cards raises;
Gloo on the card (several ranks sharing one card) only when the caller asks
for it by name.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 600.0
_RESULT = "result.pt"
_ALIGN = 16  # byte alignment of each tensor in a broadcast buffer


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    queue: int = 1
    model: int = 1

    def __post_init__(self):
        if self.data > 1 or self.model > 1:
            raise NotImplementedError(
                f"{self}: only the queue axis is ported; data parallelism and the model axis "
                "(sequence / tensor parallelism) are not (ROADMAP A12)")
        if self.queue < 1:
            raise ValueError(f"{self}: the queue axis needs at least one device")

    @property
    def num_devices(self) -> int:
        return self.data * self.queue * self.model


def check_ranks(n: int, device, backend: Optional[str] = None) -> str:
    """The backend of an ``n``-rank group on ``device``'s type: NCCL on the
    card (one card a rank: more ranks than visible cards raise), Gloo on the
    host. ``backend="gloo"`` on the card lets ranks share cards. Raises
    before anything is spawned."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"a group needs at least one rank, not {n}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the queue axis runs on 'nccl' or 'gloo'")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError("ranks on the host run Gloo")
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise ValueError("no CUDA device is visible")
        if backend == "nccl" and n > count:
            raise ValueError(f"{n} queue ranks under NCCL need {n} cards (one a rank); "
                             f"{count} visible")
    return backend


class QueueGroup:
    """This process's rank in a group of ``size`` on the queue axis."""

    def __init__(self, rank: int, size: int, device: torch.device, store, timeout_s: float):
        self.rank, self.size, self.device = rank, size, torch.device(device)
        self.timeout_s = timeout_s
        self._store, self._seq, self._ppid = store, 0, os.getppid()
        # with ``timed``, each all-reduce synchronises the device around itself
        # and records its seconds and bytes here
        self.timed = False
        self.stats = {"all_reduce_s": [], "all_reduce_bytes": 0}

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place."""
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        if self.timed:
            self._sync()
            self.stats["all_reduce_s"].append(time.perf_counter() - t0)
            self.stats["all_reduce_bytes"] += t.numel() * t.element_size()
        return t

    def check_agree(self, what: str, value: torch.Tensor) -> None:
        """Raises on every rank unless ``value`` is bit-equal to rank 0's."""
        ref = value.detach().to(self.device).clone()
        dist.broadcast(ref, 0)
        bad = torch.tensor([0.0 if torch.equal(ref, value.to(self.device)) else 1.0],
                           device=self.device)
        if self.all_reduce_(bad).item():
            raise RuntimeError(f"{what} differ between the ranks of the queue group")

    def send(self, obj: Any) -> None:
        """Rank 0: hands ``obj`` (tensors, possibly nested in tuples, lists,
        dicts and named tuples, and anything picklable) to every other rank's
        next `receive`: its skeleton through the store, its tensors packed
        in one broadcast from this rank's device."""
        tensors: list = []
        skeleton = _strip(obj, tensors)
        metas = [(tuple(t.shape), t.dtype) for t in tensors]
        self._store.set(f"tg/msg/{self._seq}", pickle.dumps((skeleton, metas)))
        self._seq += 1
        if tensors:
            dist.broadcast(_pack(tensors, self.device), 0)

    def receive(self) -> Any:
        """Ranks > 0: the next object rank 0 `send`s, its tensors on this
        rank's device. Waits as long as the process that started this one
        lives (a server's followers wait here between requests)."""
        key = f"tg/msg/{self._seq}"
        self._seq += 1
        pause = 0.001
        while not self._store.check([key]):
            if os.getppid() != self._ppid:
                raise RuntimeError("the process that started this queue rank is gone")
            time.sleep(pause)
            pause = min(2 * pause, 0.05)
        skeleton, metas = pickle.loads(self._store.get(key))
        tensors = []
        if metas:
            buf = torch.empty(_packed_size(metas), dtype=torch.uint8, device=self.device)
            dist.broadcast(buf, 0)
            tensors = _unpack(buf, metas)
        return _fill(skeleton, tensors)


class _Slot(tuple):
    """A tensor's place in a skeleton: its index in the packed list."""


def _strip(obj, tensors: list):
    if isinstance(obj, torch.Tensor):
        tensors.append(obj.detach())
        return _Slot((len(tensors) - 1,))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_strip(x, tensors) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_strip(x, tensors) for x in obj)
    if isinstance(obj, dict):
        return {k: _strip(v, tensors) for k, v in obj.items()}
    return obj


def _fill(obj, tensors: list):
    if isinstance(obj, _Slot):
        return tensors[obj[0]]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_fill(x, tensors) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill(x, tensors) for x in obj)
    if isinstance(obj, dict):
        return {k: _fill(v, tensors) for k, v in obj.items()}
    return obj


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty(0, dtype=dtype).element_size()


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _packed_size(metas) -> int:
    return sum(_padded(_nbytes(*m)) for m in metas)


def _pack(tensors, device) -> torch.Tensor:
    """The tensors' bytes, each from a 16-byte boundary, in one uint8 buffer."""
    buf = torch.zeros(_packed_size([(t.shape, t.dtype) for t in tensors]), dtype=torch.uint8,
                      device=device)
    off = 0
    for t in tensors:
        nb = _nbytes(t.shape, t.dtype)
        if nb:
            buf[off:off + nb].copy_(t.reshape(-1).view(torch.uint8))
        off += _padded(nb)
    return buf


def _unpack(buf: torch.Tensor, metas) -> list:
    """Each tensor of a `_pack` buffer, copied out into storage of its own
    (some consumers, a generator's ``set_state``, read a storage from its
    start)."""
    out, off = [], 0
    for shape, dtype in metas:
        nb = _nbytes(shape, dtype)
        out.append(buf[off:off + nb].view(dtype).reshape(shape).clone() if nb
                   else torch.empty(shape, dtype=dtype, device=buf.device))
        off += _padded(nb)
    return out


# ------------------------------------------------------------------ launching


def _rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _join_group(rank: int, n: int, device_type: str, backend: str, timeout_s: float,
                rendezvous: str, threads: int) -> QueueGroup:
    torch.set_num_threads(threads)
    dev = _rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # one host: the loopback interface carries Gloo's pairs and NCCL's bootstrap
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = dist.FileStore(os.path.join(rendezvous, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return QueueGroup(rank, n, dev, store, timeout_s)


def _worker(index: int, rank0: int, fn: Callable, args: tuple, n: int, device_type: str,
            backend: str, timeout_s: float, rendezvous: str, threads: int) -> None:
    rank = rank0 + index
    group = _join_group(rank, n, device_type, backend, timeout_s, rendezvous, threads)
    try:
        out = fn(group, *args)
        if rank == 0:
            tmp = os.path.join(rendezvous, _RESULT + ".tmp")
            torch.save(out, tmp)
            os.replace(tmp, os.path.join(rendezvous, _RESULT))
    finally:
        dist.destroy_process_group()


def _kill(ctx) -> None:
    """Stops every worker still running (none, after a clean join)."""
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
    for p in ctx.processes:
        p.join()


def _join(ctx, timeout_s: float, now: bool = False) -> None:
    """Waits for every worker. One that fails stops the others at once
    (``join`` raises); once one has ended (or, with ``now``, from the
    start), the rest must end within ``timeout_s`` or are stopped."""
    deadline = time.monotonic() + timeout_s if now else None
    while not ctx.join(timeout=0.2):
        if deadline is None and any(not p.is_alive() for p in ctx.processes):
            deadline = time.monotonic() + timeout_s
        if deadline is not None and time.monotonic() > deadline:
            _kill(ctx)
            raise TimeoutError(f"queue ranks still running {timeout_s:.0f} s after another ended")


def launch(fn: Callable, n: int, args: Sequence = (), *, device, backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """Runs ``fn(group, *args)`` on ``n`` spawned ranks, rank ``r`` on
    ``cuda:r`` (Gloo on the card: ``cuda:r % count``) or the host, and
    returns rank 0's return value, its tensors on the host. ``fn`` and
    ``args`` must pickle (``fn`` a module-level function). The workers
    use this process's count of host threads."""
    backend = check_ranks(n, device, backend)
    rendezvous = tempfile.mkdtemp(prefix="tg_queue_")
    ctx = None
    try:
        ctx = mp.start_processes(
            _worker, args=(0, fn, tuple(args), n, torch.device(device).type, backend, timeout_s,
                           rendezvous, torch.get_num_threads()),
            nprocs=n, join=False, start_method="spawn")
        _join(ctx, timeout_s)
        return torch.load(os.path.join(rendezvous, _RESULT), map_location="cpu",
                          weights_only=False)
    finally:
        if ctx is not None:
            _kill(ctx)
        shutil.rmtree(rendezvous, ignore_errors=True)


class Followers:
    """Ranks 1 to n - 1, spawned by `start_followers`; ``group`` is the
    caller's own rank 0."""

    def __init__(self, group: QueueGroup, ctx, rendezvous: str):
        self.group, self._ctx, self._rendezvous = group, ctx, rendezvous

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Waits for the followers to end (after rank 0 has told them to
        stop), stopping those still running after ``timeout_s``."""
        try:
            _join(self._ctx, self.group.timeout_s if timeout_s is None else timeout_s, now=True)
        finally:
            _kill(self._ctx)
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._rendezvous, ignore_errors=True)


def start_followers(fn: Callable, n: int, args: Sequence = (), *, device,
                    backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Followers:
    """Spawns ranks 1 to ``n - 1`` running ``fn(group, *args)`` and joins
    the group as its rank 0 (on ``cuda:0`` or the host)."""
    backend = check_ranks(n, device, backend)
    device_type = torch.device(device).type
    rendezvous = tempfile.mkdtemp(prefix="tg_queue_")
    ctx = mp.start_processes(
        _worker, args=(1, fn, tuple(args), n, device_type, backend, timeout_s, rendezvous,
                       torch.get_num_threads()),
        nprocs=n - 1, join=False, start_method="spawn")
    try:
        group = _join_group(0, n, device_type, backend, timeout_s, rendezvous,
                            torch.get_num_threads())
    except BaseException:
        _kill(ctx)
        shutil.rmtree(rendezvous, ignore_errors=True)
        raise
    return Followers(group, ctx, rendezvous)
