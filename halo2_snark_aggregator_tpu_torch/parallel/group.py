"""Process groups for the sharded paths, on torch.distributed.

The port's counterpart of the reference's meshes (parallel/msm_shard.py
`make_mesh`, parallel/multihost.py `init_distributed` / `make_host_mesh`):
a sharded path runs one process a rank, and its collectives are
torch.distributed calls on a process group.

The backend is the caller's explicit choice, and nothing switches it:

  * "nccl" when each rank has a card of its own (rank r on cuda:r, or on
    cuda:LOCAL_RANK under torchrun); NCCL refuses two ranks on one card;
  * "gloo" for ranks that share a card (every rank on cuda:0) or run on
    the CPU. gloo's collectives take CPU tensors only, so `all_gather` and
    `all_to_all` move a CUDA payload to the host and back under gloo; under
    NCCL the CUDA tensors go directly.

`spawn` runs one world in fresh processes (the spawn start method: CUDA
cannot be used after a fork), rendezvousing through a `file://` path, and
returns each rank's result, kernel launch counts and any JAX module it
imported. Every group gets a short timeout, the world a deadline, and the
first rank that raises makes `spawn` raise.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .. import device as dv

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT = 60.0


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """What a rank of a world knows of itself: its index, the world's size,
    its device and the world's backend (the default process group)."""

    rank: int
    world: int
    device: torch.device
    backend: str


@dataclasses.dataclass(frozen=True)
class RankOutcome:
    """One rank's return value, its kernel launch counts and the modules of
    jax or of the JAX package it found in its own `sys.modules`."""

    result: object
    launches: dict
    forbidden: list


def forbidden_modules() -> list[str]:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m.split(".")[0] == "halo2_snark_aggregator_tpu")


def rank_device(backend: str, device, rank: int) -> torch.device:
    """A rank's device: the CPU; under gloo every rank on the one named card
    (cuda:0 by default); under NCCL rank r on cuda:r, which must exist."""
    dev = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl needs a CUDA device a rank")
        return dev
    if backend == "gloo":
        return dv.resolve(dev)
    return dv.cuda_device(rank if dev.index is None else dev.index)


def init_group(backend: str, device, timeout: float = DEFAULT_TIMEOUT,
               init_method: str | None = None, rank: int | None = None,
               world: int | None = None) -> RankInfo:
    """Join the default process group. Without `init_method`, rank, world
    and rendezvous come from the environment torchrun sets (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with it (a `file://` path or a
    `tcp://` address), `rank` and `world` are given. `device` is the rank's
    own (`rank_device`). Collectives that wait longer than `timeout`
    seconds raise. A failed NCCL init raises; nothing retries over gloo."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no rendezvous: {missing} unset and no "
                               "init_method given")
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    elif rank is None or world is None:
        raise ValueError("an init_method needs rank and world")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl needs a CUDA device a rank")
        torch.cuda.set_device(dev)
    elif dev.type == "cuda":
        torch.cuda.set_device(dev)
    # NCCL is bound to the rank's card at init (its communicator is made
    # there, not inside the first collective)
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout),
                            **extra)
    return RankInfo(rank, world, dev, backend)


def host_groups(n_hosts: int, chips_per_host: int,
                timeout: float = DEFAULT_TIMEOUT):
    """The (host, chip) grid over the world, rank = host * chips_per_host +
    chip, as two families of groups: (host group, chip group) of the
    calling rank. The chip group holds the chips of its host (the inner
    axis); the host group holds the rank at the same chip index on every
    host (the outer axis, one result a host). Every rank creates every group,
    in the same order, as torch.distributed requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_hosts < 1 or chips_per_host < 1 or n_hosts * chips_per_host != world:
        raise ValueError(f"a {n_hosts} x {chips_per_host} grid does not tile "
                         f"a world of {world}")
    td = datetime.timedelta(seconds=timeout)
    chip_group = host_group = None
    for h in range(n_hosts):
        g = dist.new_group([h * chips_per_host + c
                            for c in range(chips_per_host)], timeout=td)
        if rank // chips_per_host == h:
            chip_group = g
    for c in range(chips_per_host):
        g = dist.new_group([h * chips_per_host + c for h in range(n_hosts)],
                           timeout=td)
        if rank % chips_per_host == c:
            host_group = g
    return host_group, chip_group


# -- collectives ------------------------------------------------------------------


def _via_host(group) -> bool:
    """gloo takes CPU tensors only: its payloads travel through the host."""
    return dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's `t` (one a rank, in rank order, on t's device): the
    leading sizes may differ between ranks. The sizes are gathered first,
    then the tensors padded to the largest."""
    world = dist.get_world_size(group)
    src = t.cpu() if _via_host(group) else t
    size = torch.tensor([t.shape[0]], dtype=torch.int64, device=src.device)
    sizes = [torch.empty_like(size) for _ in range(world)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    most = max(sizes)
    if most == 0:
        return [t[:0] for _ in range(world)]
    buf = torch.cat([src, src.new_zeros((most - t.shape[0], *t.shape[1:]))])
    outs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(outs, buf.contiguous(), group=group)
    return [o[:s].to(t.device) for o, s in zip(outs, sizes)]


def all_to_all(parts: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """parts[j] goes to rank j; returns what each rank sent here, in rank
    order, on the parts' device. Every part on every rank has one shape.
    NCCL runs its all-to-all; gloo (which has none in every torch release)
    one send and one receive a pair of ranks, through the host."""
    world = dist.get_world_size(group)
    if len(parts) != world:
        raise ValueError(f"{len(parts)} parts for a world of {world}")
    dev = parts[0].device
    if any(p.shape != parts[0].shape or p.dtype != parts[0].dtype
           for p in parts):
        raise ValueError("all_to_all parts differ in shape or dtype")
    if not _via_host(group):
        src = [p.contiguous() for p in parts]
        outs = [torch.empty_like(src[0]) for _ in range(world)]
        dist.all_to_all(outs, src, group=group)
        return outs
    me = dist.get_rank(group)
    src = [p.cpu().contiguous() for p in parts]
    outs = [src[j] if j == me else torch.empty_like(src[j])
            for j in range(world)]
    peer = (lambda j: j) if group is None else (
        lambda j: dist.get_global_rank(group, j))
    ops = [op for j in range(world) if j != me
           for op in (dist.P2POp(dist.isend, src[j], peer(j), group),
                      dist.P2POp(dist.irecv, outs[j], peer(j), group))]
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    return [o.to(dev) for o in outs]


# -- one world in fresh processes ------------------------------------------------


def _rank_main(rank, world, backend, device, init_method, timeout, fn, args,
               results) -> None:
    from ..kernels import build

    try:
        dev = rank_device(backend, device, rank)
        # the ranks share the host's cores with each other and whatever else
        # runs there: torch's own pool would start as many threads a rank as
        # there are cores. A CPU rank runs the plain twins, small ops that
        # gain nothing from more threads and lose much when oversubscribed.
        torch.set_num_threads(1 if dev.type == "cpu" else
                              max(1, (os.cpu_count() or 1) // world))
        info = init_group(backend, dev, timeout, init_method, rank, world)
        results.put(("ready", rank, None))
        try:
            build.reset_launches()
            out = fn(info, *args)
            results.put(("ok", rank, RankOutcome(
                out, dict(build.LAUNCHES), forbidden_modules())))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put(("error", rank, traceback.format_exc()))
        raise


def spawn(fn, world: int, device="cpu", backend: str = "gloo",
          timeout: float = DEFAULT_TIMEOUT, args: tuple = ()) -> list[RankOutcome]:
    """Run `fn(RankInfo, *args)` on `world` ranks, each a fresh process, and
    return their `RankOutcome`s in rank order. `fn` and `args` are pickled,
    so `fn` is a module-level function of a module that imports no JAX.
    Ranks rendezvous through a `file://` path in a new temporary
    directory. On a card the kernel library and
    the native host library are built here first, so no two ranks build
    them at once. Collectives time out after `timeout` seconds. The ranks
    must join the group within `timeout` seconds of their start, and the
    world must finish within `timeout` seconds of the last join (a loaded
    host may take long to start a process, which is not the world's work):
    when a rank raises or dies, or a deadline passes, every rank is
    stopped and this raises."""
    import multiprocessing

    if world < 1:
        raise ValueError(f"world {world} < 1")
    for r in range(world):
        rank_device(backend, device, r)  # raises before anything starts
    if torch.device(device).type == "cuda":
        from .. import native
        from ..kernels import build

        build.library()
        native.available()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="h2t-rdv-")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, str(device), init_method,
                               timeout, fn, args, results))
             for r in range(world)]
    outcomes: dict[int, RankOutcome] = {}
    ready: set[int] = set()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(outcomes) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                stage = "finish" if len(ready) == world else "join"
                raise TimeoutError(
                    f"world of {world} did not {stage} in {timeout:.0f} s "
                    f"(joined: {sorted(ready)}, done: {sorted(outcomes)})")
            try:
                kind, rank, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in outcomes and p.exitcode is not None]
                if not dead:
                    continue
                try:  # a last message may still be in the pipe
                    kind, rank, payload = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            if kind == "ready":
                ready.add(rank)
                if len(ready) == world:
                    deadline = time.monotonic() + timeout
            else:
                outcomes[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [outcomes[r] for r in range(world)]
