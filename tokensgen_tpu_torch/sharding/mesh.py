"""Process groups of the port: the FIFO's ``queue`` axis and the trainers'
``data`` axis over several GPUs (port of `tokensgen_tpu/sharding/mesh.py`).

The JAX package lays the lookahead rank windows of a FIFO iteration on the
devices of a mesh's ``queue`` axis and merges them with a `psum`, all inside
one SPMD program. Here every device is a process of its own in a
`torch.distributed` group: NCCL on the card, one card a rank, and Gloo on
the host. Rank 0 runs everything outside the FIFO and sends the other ranks
what they need; every rank runs its block of windows, and one sum
all-reduce a FIFO iteration merges them.

* `MeshSpec`: the mesh's axes; ``queue`` and ``data`` may be above 1 (the
  ``model`` axis, tensor and sequence parallelism, is ROADMAP A12).
* `QueueGroup`: one process's place in the group: its rank, the group's
  size, its device, the collectives (sum all-reduce, a check that a value
  agrees on every rank) and `send` / `receive`, which move a nested
  structure of tensors from rank 0 to the others: its skeleton through the
  rendezvous store, its tensors in one broadcast.
* `DataGroup`: a `QueueGroup` with what a data-parallel trainer needs: a
  mean all-reduce of f32 tensors in flat buckets, an all-gather of each
  rank's flat part of a tensor, a scalar sum, a barrier, and the host
  layout (``hosts``, ``host``, ``local_rank``, ``local_size``) that splits
  the data (`process_batch_shard`). It keeps the seconds and bytes of its
  all-reduces and all-gathers in ``stats``.
* `launch(fn, n)` spawns ``n`` workers (``torch.multiprocessing``, start
  method ``spawn``); rank ``r`` calls ``fn(group, *args)`` and rank 0's
  return value comes back. `start_followers(fn, n)` makes the caller rank
  0 and spawns ranks 1 to n - 1 (the server's layout).
* `join_env_group` (port of `initialize_multihost`): a process started by
  ``torchrun`` (or anything that sets ``WORLD_SIZE``, ``RANK`` and
  ``MASTER_ADDR``) joins its ``env://`` group, one rank a card, across
  hosts.

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
        if self.model > 1:
            raise NotImplementedError(
                f"{self}: the queue and data axes are ported; the model axis (sequence / "
                "tensor parallelism) is not (ROADMAP A12)")
        if self.queue < 1 or self.data < 1:
            raise ValueError(f"{self}: each axis needs at least one device")

    @property
    def num_devices(self) -> int:
        return self.data * self.queue * self.model


def check_ranks(n: int, device, backend: Optional[str] = None,
                group_cls: Optional[type] = None) -> str:
    """The backend of an ``n``-rank group (a ``group_cls``, by default
    `QueueGroup`) on ``device``'s type: NCCL on the card (one card a rank:
    more ranks than visible cards raise), Gloo on the host.
    ``backend="gloo"`` on the card lets ranks share cards. Raises before
    anything is spawned."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"a group needs at least one rank, not {n}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: a group runs on 'nccl' or 'gloo'")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError("ranks on the host run Gloo")
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise ValueError("no CUDA device is visible")
        if backend == "nccl" and n > count:
            raise ValueError(f"{n} {(group_cls or QueueGroup).axis} ranks under NCCL need {n} "
                             f"cards (one a rank); {count} visible")
    return backend


class QueueGroup:
    """This process's rank in a group of ``size`` on the queue axis."""

    axis = "queue"

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


BUCKET_BYTES = 64 << 20  # bytes of one all-reduce or all-gather bucket


class DataGroup(QueueGroup):
    """This process's rank in a data-parallel group of ``size`` ranks,
    ``local_size`` on each of ``hosts`` hosts (ranks numbered host by host:
    rank = ``host * local_size + local_rank``). ``comm`` holds the seconds
    (device synchronised around each call) and bytes of the all-reduces and
    all-gathers since the last `take_comm`."""

    axis = "data"

    def __init__(self, rank: int, size: int, device: torch.device, store, timeout_s: float,
                 local_size: Optional[int] = None):
        super().__init__(rank, size, device, store, timeout_s)
        self.local_size = size if local_size is None else local_size
        if size % self.local_size:
            raise ValueError(f"{size} ranks do not split into hosts of {self.local_size}")
        self.hosts = size // self.local_size
        self.host, self.local_rank = divmod(rank, self.local_size)
        self.comm = _no_comm()

    def take_comm(self) -> dict:
        """The collectives' seconds and bytes since the last call."""
        out, self.comm = self.comm, _no_comm()
        return out

    def _timed(self, kind: str, nbytes: int, t0: float) -> None:
        self._sync()
        self.comm[f"{kind}_s"] += time.perf_counter() - t0
        self.comm[f"{kind}_bytes"] += nbytes

    def barrier(self) -> None:
        dist.all_reduce(torch.zeros(1, device=self.device))

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of a (small) tensor over the ranks, in place (untimed)."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def mean_all_reduce_(self, tensors: Sequence[torch.Tensor],
                         divisor: Optional[float] = None) -> None:
        """Each tensor replaced, in place, by its sum over the ranks divided
        by ``divisor`` (the group's size by default): tensors taken in
        order into flat buckets of at most `BUCKET_BYTES`, one all-reduce a
        bucket (a larger tensor is reduced where it lies)."""
        divisor = float(self.size if divisor is None else divisor)
        self._sync()
        t0 = time.perf_counter()
        nbytes = 0
        for bucket in _buckets(tensors, lambda t: t.numel() * t.element_size()):
            if len(bucket) == 1:
                flat = bucket[0]
            else:
                flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat.div_(divisor)
            nbytes += flat.numel() * flat.element_size()
            if len(bucket) > 1:
                off = 0
                for t in bucket:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()
        self._timed("all_reduce", nbytes, t0)

    def all_gather_parts_(self, items: Sequence[tuple]) -> None:
        """Each item ``(flat, chunk)``: a 1-D tensor of which rank ``r``
        owns ``flat[r * chunk:(r + 1) * chunk]`` (cut at its end; parts may
        be empty). Every rank's part is written into every rank's ``flat``:
        the parts of a bucket of items packed in one buffer, one all-gather
        a bucket."""
        self._sync()
        t0 = time.perf_counter()
        nbytes = 0
        for bucket in _buckets(items, lambda it: it[1] * self.size * it[0].element_size()):
            width = sum(c for _, c in bucket)
            send = torch.zeros(width, dtype=bucket[0][0].dtype, device=self.device)
            off = 0
            for flat, c in bucket:
                part = flat[self.rank * c:(self.rank + 1) * c]
                send[off:off + part.numel()].copy_(part)
                off += c
            # Gloo gathers host tensors: ranks sharing a card stage through the host
            staged = self.device.type == "cuda" and dist.get_backend() == "gloo"
            if staged:
                send = send.cpu()
            recv = torch.empty(self.size, width, dtype=send.dtype, device=send.device)
            dist.all_gather(list(recv.unbind(0)), send)
            if staged:
                recv = recv.to(self.device)
            nbytes += recv.numel() * recv.element_size()
            off = 0
            for flat, c in bucket:
                flat.copy_(recv[:, off:off + c].reshape(-1)[:flat.numel()])
                off += c
        self._timed("all_gather", nbytes, t0)


def _no_comm() -> dict:
    return {"all_reduce_s": 0.0, "all_reduce_bytes": 0, "all_gather_s": 0.0,
            "all_gather_bytes": 0}


def _buckets(items, nbytes: Callable, cap: int = BUCKET_BYTES):
    """``items`` in order, in runs of one dtype whose ``nbytes`` sum to at
    most ``cap`` (an item larger than ``cap`` alone)."""
    bucket, size = [], 0
    for it in items:
        n = nbytes(it)
        dtype = (it[0] if isinstance(it, tuple) else it).dtype
        if bucket and (size + n > cap or dtype != bucket_dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(it)
        bucket_dtype = dtype
        size += n
    if bucket:
        yield bucket


def process_batch_shard(global_batch_size: int, group: Optional[DataGroup] = None) -> tuple:
    """(local batch size, shard index, shard count) of this host's share
    of a global batch (`batch_iterator(num_shards=, shard_index=)`):
    the hosts of ``group`` (one without a group)."""
    hosts, host = (group.hosts, group.host) if group is not None else (1, 0)
    if global_batch_size % hosts:
        raise ValueError(f"global batch {global_batch_size} not divisible by {hosts} hosts")
    return global_batch_size // hosts, host, hosts


def batch_shard_kwargs(group: Optional[DataGroup], batch_size: int) -> dict:
    """`data.mira.batch_iterator`'s arguments for this rank's
    ``batch_size`` rows of each global batch: its host's strided share
    (`process_batch_shard`), then its positions among the host's ranks."""
    if group is None:
        return {}
    _, index, shards = process_batch_shard(batch_size * group.size, group)
    return dict(num_shards=shards, shard_index=index, slot=group.local_rank,
                slots=group.local_size)


ENV_KEYS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def env_launched() -> bool:
    """Whether this process was started as a rank of an ``env://`` group
    (``torchrun`` sets ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``)."""
    return all(os.environ.get(k) for k in ENV_KEYS)


def join_env_group(device, backend: Optional[str] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> DataGroup:
    """Port of `initialize_multihost`: joins the ``env://`` group that
    ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` describe
    (``LOCAL_WORLD_SIZE`` ranks a host, this one ``LOCAL_RANK``, as
    ``torchrun`` sets them), on ``cuda:LOCAL_RANK`` under NCCL or on the host
    under Gloo. `leave_group` ends it."""
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_size))
    if local_rank != rank % local_size:
        raise ValueError(f"rank {rank} is local rank {local_rank} of {local_size}: ranks must be "
                         "numbered host by host")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = check_ranks(local_size, device, backend, DataGroup)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    from torch.distributed.distributed_c10d import _get_default_store

    return DataGroup(rank, world, device, _get_default_store(), timeout_s, local_size=local_size)


def leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


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
                rendezvous: str, threads: int, group_cls: type = QueueGroup) -> QueueGroup:
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
    return group_cls(rank, n, dev, store, timeout_s)


def _worker(index: int, rank0: int, fn: Callable, args: tuple, n: int, device_type: str,
            backend: str, timeout_s: float, rendezvous: str, threads: int,
            group_cls: type = QueueGroup) -> None:
    rank = rank0 + index
    group = _join_group(rank, n, device_type, backend, timeout_s, rendezvous, threads, group_cls)
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
           timeout_s: float = DEFAULT_TIMEOUT_S, group_cls: type = QueueGroup):
    """Runs ``fn(group, *args)`` on ``n`` spawned ranks, rank ``r`` on
    ``cuda:r`` (Gloo on the card: ``cuda:r % count``) or the host, and
    returns rank 0's return value, its tensors on the host. ``fn`` and
    ``args`` must pickle (``fn`` a module-level function). The workers
    use this process's count of host threads; ``group`` is a
    ``group_cls`` (`QueueGroup`, or `DataGroup` for a trainer)."""
    backend = check_ranks(n, device, backend, group_cls)
    rendezvous = tempfile.mkdtemp(prefix="tg_queue_")
    ctx = None
    try:
        ctx = mp.start_processes(
            _worker, args=(0, fn, tuple(args), n, torch.device(device).type, backend, timeout_s,
                           rendezvous, torch.get_num_threads(), group_cls),
            nprocs=n, join=False, start_method="spawn")
        _join(ctx, timeout_s)
        return torch.load(os.path.join(rendezvous, _RESULT), map_location="cpu",
                          weights_only=False)
    finally:
        if ctx is not None:
            _kill(ctx)
        shutil.rmtree(rendezvous, ignore_errors=True)


def data_axis(cfg, device) -> int:
    """A trainer config's data-parallel ranks: ``dp_devices`` where set,
    else 0 (the group's size) in a process ``torchrun`` started, else the
    visible cards on the card and 1 on the host. ``tp_devices`` and
    ``sp_devices`` above 1 raise (the model axis, ROADMAP A12)."""
    for key in ("tp_devices", "sp_devices"):
        if int(cfg.get(key) or 1) > 1:
            raise NotImplementedError(f"`{key}` > 1: tensor / sequence parallelism is not ported "
                                      "yet (ROADMAP A12); the data axis (`dp_devices`, `zero1`) is")
    dp = int(cfg.get("dp_devices") or 0)
    if dp or env_launched():
        return dp
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def build_kernels_for_ranks(dp: int, device) -> None:
    """With ``dp`` > 1 ranks to spawn on the card: builds the kernel library
    once here, so that the ranks load it instead of each compiling it."""
    if dp > 1 and torch.device(device).type == "cuda" and not env_launched():
        from tokensgen_tpu_torch.kernels.attention import build_kernels

        build_kernels()


TRAIN_TIMEOUT_S = 3600.0  # a rank may wait out another's validation render


def run_data_parallel(fn: Callable, dp: int, args: Sequence = (), *, device,
                      backend: Optional[str] = None, timeout_s: float = TRAIN_TIMEOUT_S):
    """A trainer's entry: ``fn(group, *args)`` on this process's ``env://``
    group where it was started as one of its ranks (`env_launched`, all of
    its hosts' ranks together making the data axis), else on ``dp`` spawned
    ranks of a `DataGroup` (rank 0's return value comes back), else (``dp``
    1) ``fn(None, *args)`` here."""
    if env_launched():
        group = join_env_group(device, backend, timeout_s)
        if dp not in (0, group.size):
            leave_group()
            raise ValueError(f"dp_devices {dp}: the env:// group has {group.size} ranks")
        try:
            return fn(group, *args)
        finally:
            leave_group()
    if dp > 1:
        return launch(fn, dp, args, device=device, backend=backend, timeout_s=timeout_s,
                      group_cls=DataGroup)
    return fn(None, *args)


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
