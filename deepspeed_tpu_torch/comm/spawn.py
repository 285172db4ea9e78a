"""A pool of spawned processes, one rank each, over one process group.

``RankPool(world, store_dir)`` starts ``world`` processes (``spawn``, so
nothing of the parent's threads or device state is inherited), brings the
default group up in each (``init_distributed``, gloo on the CPU, over a
``file://`` store in ``store_dir``: no port is bound, so pools in parallel
processes never collide), and runs functions on every rank:
``pool.run(fn, *args)`` calls ``fn(*args)`` on each rank and returns the
results in rank order, tensors turned to numpy. ``fn`` must be importable
by name (a module-level function). A rank that raises fails the call with
its traceback, and the pool is then closed: the other ranks may be stuck
in a collective.

The multi-rank CPU tests run their cases in one pool per module, and
``chip_smoke.py`` trains on two CPU ranks beside the card with it.
"""
from __future__ import annotations

import os
import queue
import time
import traceback

import torch


def _plain(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _worker(rank: int, world: int, init_method: str, tasks, results,
            threads: int) -> None:
    torch.set_num_threads(threads)
    from .comm import init_distributed

    init_distributed(init_method=init_method, rank=rank, world_size=world,
                     device="cpu")
    while True:
        item = tasks.get()
        if item is None:
            break
        fn, args, kwargs = item
        try:
            out = ("ok", _plain(fn(*args, **kwargs)))
        except BaseException as e:
            out = ("err", f"rank {rank}: {type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()}")
        results.put((rank, out))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankPool:
    """See the module docstring."""

    def __init__(self, world: int, store_dir: str, threads: int = 1):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        os.makedirs(store_dir, exist_ok=True)
        init = f"file://{os.path.join(os.path.abspath(store_dir), 'store')}"
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, init, self.tasks[r],
                                        self.results, threads))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 600, **kwargs) -> list:
        for q in self.tasks:
            q.put((fn, args, kwargs))
        out: list = [None] * self.world
        errors = []
        deadline = time.monotonic() + timeout
        for _ in range(self.world):
            while True:
                try:
                    rank, (status, value) = self.results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in self.procs
                            if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close()
                        raise RuntimeError(
                            f"{fn.__name__}: no result from every rank "
                            f"(exit codes of ended ranks: {dead}; "
                            f"{timeout} s allowed)") from None
            if status == "err":
                errors.append(value)
                # the other ranks may wait in a collective forever
                break
            out[rank] = value
        if errors:
            self.close()
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["RankPool"]
