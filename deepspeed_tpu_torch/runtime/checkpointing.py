"""Checkpoint save/load, written as global logical tensors.

Counterpart of ``deepspeed_tpu/runtime/checkpointing.py`` (:188-690). The
JAX package writes through orbax as global logical arrays, so a checkpoint
loads under any mesh or ZeRO stage; this one keeps that property with files
of its own, and needs no converter to reshard.

Layout on disk (the JAX layout, with the state as the port's files)::

    <save_dir>/<tag>/state/<section>.<name>.npy   one per logical tensor
    <save_dir>/<tag>/state/index.json             dtype + shape per file
    <save_dir>/<tag>/meta.json                    the JAX package's keys
    <save_dir>/<tag>/manifest.json                size+crc32 per file
    <save_dir>/latest                             the newest tag

The sections are the JAX tree's keys: ``params`` (the compute dtype),
``master`` (fp32, mixed precision only), ``opt_mu`` / ``opt_nu`` (fp32,
where the optimizer has them), and ``opt_step``, ``global_step`` and
``scaler.*`` (0-d). ``<name>`` is the parameter's dotted JAX-layout name.
bf16 is stored as its uint16 bits (``index.json`` says "bfloat16"): numpy
has no bf16 type.

Writing: rank 0 creates every file's header (``open_memmap``) and all
ranks meet at a barrier; each rank writes the element ranges it owns (its
ZeRO partition, from seq index 0 of the ranks that share it; at stage 0
data-parallel index 0 writes everything), flushes, and meets the others
again; rank 0 then writes ``meta.json``, the manifest and ``latest``. At
tensor > 1 the files still hold the logical tensors: each tensor rank
writes its slice of a sharded parameter into the whole tensor's file, and
tensor index 0 alone writes a replicated one. No rank ever holds the
whole state. Loading: every rank memory-maps the files and reads the
ranges of its own partition (of its own slice, at tensor > 1) under the
current plan — which is the resharding, so a tag moves between any tensor,
data, seq and ZeRO layout.

The integrity contract is the JAX package's: state → manifest → atomic
``latest``; ``load_checkpoint`` falls back to the newest verified tag when
``latest`` is torn, a tag is truncated, or a checksum mismatches; an
explicitly requested bad tag raises :class:`CheckpointIntegrityError`;
``checkpoint.keep_n`` never removes the resume target, the ``latest``
target, the newest verified rewind target or the tag just written;
``checkpoint.integrity`` is crc32, size or none; ``async_save`` snapshots
the rank's ranges to host copies and commits on a thread
(:func:`wait_for_checkpoint` bounds the wait with
:class:`CheckpointWaitTimeout`); the fault-injection points fire where the
JAX package fires them.

Under ZeRO-Offload the master and the moments come from (and return to)
the host optimizer, NVMe-backed ones read whole for the call; a streamed
(ZeRO-Infinity) engine saves its host parameters. The files are the same,
so an offloaded run resumes on the device and the reverse.

The format is not the JAX package's: neither package loads the other's
checkpoints. :func:`state_tree` / :func:`load_state_tree` carry a state
across as numpy trees in these sections.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from .. import comm
from ..checkpoint.manifest import (tag_status, write_file_atomic,
                                   write_manifest)
from ..utils.logging import log_dist, logger
from ..utils.naming import safe_filename
from .resilience import CheckpointWaitTimeout

__all__ = ["CheckpointIntegrityError", "save_checkpoint", "load_checkpoint",
           "wait_for_checkpoint", "state_tree", "load_state_tree",
           "write_manifest", "tag_status"]

#: numpy storage of each dtype: (numpy dtype of the file, index name)
_STORE = {torch.float32: (np.float32, "float32"),
          torch.float16: (np.float16, "float16"),
          torch.bfloat16: (np.uint16, "bfloat16")}
_STORE_BY_NAME = {name: npdt for npdt, name in _STORE.values()}


class CheckpointIntegrityError(RuntimeError):
    """An explicitly requested tag failed manifest verification."""


def _with_host_state(changed: bool):
    """Run under the engine's ``_host_state`` (ZeRO-Offload's host master
    and moments, a streamed engine's parameters, as whole tensors);
    ``changed``: the call writes them (a load)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(engine, *a, **k):
            ctx = getattr(engine, "_host_state", None)
            with ctx(changed) if ctx is not None else \
                    contextlib.nullcontext():
                return fn(engine, *a, **k)
        return wrapper
    return deco


def _injector(engine):
    res = getattr(engine, "resilience", None)
    return res.injector if res is not None else None


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_stored(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A tensor from stored values (uint16 bits for "bfloat16")."""
    a = np.array(a, copy=True)      # memory-mapped slices are read-only
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# --------------------------------------------------------------------------
# what each rank holds
# --------------------------------------------------------------------------

def _has_moment(engine, slot: str) -> bool:
    z = engine._zero
    if z is not None:
        return getattr(z, slot) is not None
    return getattr(engine.opt_state, slot) is not None


def _sections(engine) -> list[str]:
    """The tensor sections this engine writes."""
    out = ["params"]
    if engine.mixed_precision:
        out.append("master")
    out += [f"opt_{s}" for s in ("mu", "nu") if _has_moment(engine, s)]
    return out


def _targets(engine) -> list[str]:
    """The sections a load fills: ``master`` also at stages 1-3 in fp32,
    where the partitioned master is apart from the parameters."""
    out = _sections(engine)
    if "master" not in out and engine._zero is not None:
        out.insert(1, "master")
    return out


def _tp(engine, i: int):
    """``(spec, tensor rank, tensor size)`` of parameter ``i`` where it is
    sharded over ``tensor``, else None."""
    specs = getattr(engine, "_tp_specs", None)
    spec = specs[i] if specs is not None else None
    if spec is None or "tensor" not in spec:
        return None
    return spec, engine.tp_rank, engine.tp_size


def _shape(engine, i: int) -> tuple:
    """Parameter ``i``'s logical (whole) shape."""
    shapes = getattr(engine, "_global_shapes", None)
    return tuple(shapes[i]) if shapes is not None \
        else tuple(engine._params[i].shape)


def _rank_view(a: np.ndarray, shape: tuple, tp) -> np.ndarray:
    """This tensor rank's slice of the whole flat array ``a`` as a 2-D view
    ``[rows, width]`` whose row-major order is the slice's own: the
    sharded dim ``d`` splits the whole tensor into ``[prod(shape[:d]), n,
    width]``."""
    spec, rank, n = tp
    d = spec.index("tensor")
    rows = int(np.prod(shape[:d], dtype=np.int64))
    return a.reshape(rows, n, -1)[:, rank, :]


def _spans(width: int, start: int, length: int):
    """``(row, col0, col1, offset)`` pieces of the flat range ``[start,
    start + length)`` of a ``[rows, width]`` array: a partial first row,
    whole rows as one piece (``row`` a slice), a partial last row."""
    pos, off, end = start, 0, start + length
    while pos < end:
        r, c = divmod(pos, width)
        if c == 0 and end - pos >= width:
            k = (end - pos) // width
            yield slice(r, r + k), 0, width, off
            pos, off = pos + k * width, off + k * width
            continue
        k = min(width - c, end - pos)
        yield r, c, c + k, off
        pos, off = pos + k, off + k


def _put(flat: np.ndarray, shape: tuple, tp, start: int,
         data: np.ndarray) -> None:
    """Write the rank's flat elements ``[start, start + data.size)`` (of
    its slice, when ``tp``) into the whole tensor's flat array."""
    data = data.reshape(-1)
    if tp is None:
        flat[start:start + data.size] = data
        return
    v = _rank_view(flat, shape, tp)
    for r, c0, c1, off in _spans(v.shape[1], start, data.size):
        n = (c1 - c0) * (r.stop - r.start if isinstance(r, slice) else 1)
        v[r, c0:c1] = data[off:off + n].reshape(v[r, c0:c1].shape)


def _take(flat: np.ndarray, shape: tuple, tp, start: int,
          length: int) -> np.ndarray:
    """The rank's flat elements ``[start, start + length)`` (of its slice,
    when ``tp``) read from the whole tensor's flat array."""
    if tp is None:
        return flat[start:start + length]
    v = _rank_view(flat, shape, tp)
    return np.concatenate([v[r, c0:c1].reshape(-1) for r, c0, c1, _
                           in _spans(v.shape[1], start, length)])


def _writes(engine, i: int) -> bool:
    """Whether this rank writes parameter ``i``'s elements it holds: seq
    index 0 of the ranks that share them, and of a replicated parameter
    tensor index 0 (at stage 0 also data-parallel index 0)."""
    if getattr(engine, "sp_rank", 0) != 0:
        return False
    if _tp(engine, i) is None and getattr(engine, "tp_rank", 0) != 0:
        return False
    return engine._zero is not None or engine.dp_rank == 0


def _views(engine, section: str, i: int, writing: bool):
    """``[(start, length, 1-D tensor)]``: the elements of parameter ``i``'s
    ``section`` this rank holds (writing: the ones it writes), their
    offsets in its own slice at tensor > 1."""
    z = engine._zero
    if writing and not _writes(engine, i):
        return []
    if z is None:
        p = engine._params[i]
        t = {"params": p.data,
             "master": engine._master[i] if engine.mixed_precision else p.data,
             "opt_mu": None if engine.opt_state.mu is None
             else engine.opt_state.mu[i],
             "opt_nu": None if engine.opt_state.nu is None
             else engine.opt_state.nu[i]}[section]
        return [(0, p.numel(), t.reshape(-1))]
    s, _ = z.plan.where[i]
    seg = z.plan.segments[s]
    out = []
    for start, ln, po in z.plan.pieces(i):
        if section == "params":
            t = z.local[s][po - seg.part_offset:po - seg.part_offset + ln]
        else:
            flat = {"master": z.master, "opt_mu": z.mu, "opt_nu": z.nu}[section]
            t = flat[po:po + ln]
        out.append((start, ln, t))
    return out


def _file(section: str, name: str) -> str:
    return f"{section}.{safe_filename(name)}.npy"


def _entries(engine) -> list[tuple[str, int, str, tuple, str]]:
    """``(section, param index, file, shape, index dtype)`` per tensor."""
    out = []
    for section in _sections(engine):
        for i, name in enumerate(engine._names):
            p = engine._params[i]
            dt = p.dtype if section == "params" else torch.float32
            out.append((section, i, _file(section, name), _shape(engine, i),
                        _STORE[dt][1]))
    return out


def _scalars(engine) -> dict[str, np.ndarray]:
    out = {"opt_step": np.asarray(engine.opt_step, np.int32),
           "global_step": np.asarray(engine.global_step, np.int32)}
    if engine.scaler is not None:
        out.update({"scaler.scale": np.asarray(engine.scaler.scale,
                                               np.float32),
                    "scaler.good_steps": np.asarray(engine.scaler.good_steps,
                                                    np.int32),
                    "scaler.hysteresis": np.asarray(engine.scaler.hysteresis,
                                                    np.int32)})
    return out


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------

def _tag_steps(path: str) -> float:
    """Recency key for fallback ordering: saved step if readable, else
    dir mtime (orders legacy/damaged tags sanely)."""
    for fn in ("manifest.json", "meta.json"):
        try:
            with open(os.path.join(path, fn)) as f:
                steps = json.load(f).get("global_steps")
            if steps is not None:
                return float(steps)
        except (OSError, ValueError):
            continue
    try:
        return os.path.getmtime(path) - 1e12  # always below any real step
    except OSError:
        return float("-inf")


def wait_for_checkpoint(engine, timeout_s: float | None = None) -> None:
    """Block until an in-flight async save has committed and its 'latest'
    is written. Bounded: ``timeout_s`` (default
    ``checkpoint.wait_timeout_s``; None/0 → wait forever) raises
    :class:`CheckpointWaitTimeout` when the save thread is wedged. A commit
    error captured by the thread re-raises here."""
    if timeout_s is None:
        cfg = getattr(engine, "config", None)
        timeout_s = getattr(getattr(cfg, "checkpoint", None),
                            "wait_timeout_s", None)
    t = getattr(engine, "_latest_thread", None)
    if t is not None:
        t.join(float(timeout_s) if timeout_s else None)
        if t.is_alive():
            raise CheckpointWaitTimeout("commit+latest", float(timeout_s))
        engine._latest_thread = None
    err = getattr(engine, "_ckpt_commit_error", None)
    if err is not None:
        engine._ckpt_commit_error = None
        raise err


def save_checkpoint(engine, save_dir: str, tag: str | None = None,
                    client_state: dict | None = None) -> str:
    """Every rank calls this; see the module docstring. Returns the tag's
    path.

    Telemetry wrapper, as in the JAX package: the save runs under a
    ``checkpoint_save`` span and its host-blocking wall time lands in a
    histogram (the async path's wall time is the snapshot cost only —
    commit durations flow separately through ``record_committed`` →
    Checkpoint/ counters). The flight recorder gets a breadcrumb either
    way, so postmortems show the last save attempt."""
    from ..telemetry import get_telemetry

    telem = get_telemetry()
    t0 = time.perf_counter()
    with telem.span("checkpoint_save", dir=save_dir):
        path = _save_checkpoint_inner(engine, save_dir, tag=tag,
                                      client_state=client_state)
    host_s = time.perf_counter() - t0
    if telem.enabled:
        telem.registry.histogram(
            "checkpoint_save_call_s",
            help="host-blocking save_checkpoint wall time").observe(host_s)
    telem.note("checkpoint_save", path=path, host_s=round(host_s, 3),
               async_save=engine.config.checkpoint.async_save)
    return path


@_with_host_state(changed=False)
def _save_checkpoint_inner(engine, save_dir: str, tag: str | None = None,
                           client_state: dict | None = None) -> str:
    t_start = time.perf_counter()
    inj = _injector(engine)
    res = getattr(engine, "resilience", None)
    rank, world = comm.get_rank(), comm.get_world_size()
    tag = tag or f"global_step{engine.global_steps}"
    root = os.path.abspath(save_dir)
    path = os.path.join(root, tag)
    state = os.path.join(path, "state")
    async_save = engine.config.checkpoint.async_save
    if async_save:
        wait_for_checkpoint(engine)   # at most one save in flight
    if res is not None:
        res.record_save_dir(root)
    entries = _entries(engine)
    if rank == 0:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(state)
        index = {}
        for section, i, fn, shape, dt in entries:
            np.lib.format.open_memmap(os.path.join(state, fn), mode="w+",
                                      dtype=_STORE_BY_NAME[dt],
                                      shape=shape).flush()
            index[f"{section}.{engine._names[i]}"] = {
                "file": fn, "dtype": dt, "shape": list(shape)}
        for key, a in _scalars(engine).items():
            np.save(os.path.join(state, f"{key}.npy"), a)
            index[key] = {"file": f"{key}.npy", "dtype": str(a.dtype),
                          "shape": [], "scalar": True}
        with open(os.path.join(state, "index.json"), "w") as f:
            json.dump(index, f, indent=1)
    comm.barrier()
    # this rank's ranges, as host copies under async_save (the engine
    # updates its buffers in place while the thread writes)
    pieces = []
    for section, i, fn, shape, _ in entries:
        for start, ln, t in _views(engine, section, i, writing=True):
            pieces.append((fn, (shape, _tp(engine, i)), start,
                           to_numpy(t).copy() if async_save else t))
    meta = {
        "tag": tag,
        "global_steps": engine.global_steps,
        "skipped_steps": engine.skipped_steps,
        "config": engine.config.to_dict(),
        "client_state": client_state or {},
        "framework_version": "deepspeed_tpu_torch-0.1",
        "zero_stage": engine.zero_stage,
        "dp_world_size": engine.dp_world_size,
    }
    level = getattr(engine.config.checkpoint, "integrity", "crc32")
    save_host_s = time.perf_counter() - t_start

    def write_pieces():
        by_file: dict[str, list] = {}
        for fn, where, start, data in pieces:
            by_file.setdefault(fn, []).append((where, start, data))
        for fn, items in by_file.items():
            mm = np.load(os.path.join(state, fn), mmap_mode="r+")
            flat = mm.reshape(-1)
            for (shape, tp), start, data in items:
                data = data if isinstance(data, np.ndarray) \
                    else to_numpy(data)
                _put(flat, shape, tp, start, data)
            mm.flush()
            del mm, flat

    def commit_tail(commit_s: float):
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        if inj is not None:
            inj.maybe_crash("crash_after_commit",
                            f"save {tag}: state committed, no manifest yet")
        write_manifest(path, tag, engine.global_steps, level)
        if inj is not None:
            inj.maybe_crash("crash_before_latest",
                            f"save {tag}: manifest written, 'latest' not")
        write_file_atomic(os.path.join(root, "latest"), tag)
        if inj is not None:
            inj.maybe_crash("crash_after_latest",
                            f"save {tag}: 'latest' advanced")
        _apply_retention(engine, root, tag)
        if inj is not None and inj.fire("truncate_tag"):
            _truncate_tag_for_test(path)
        if res is not None:
            res.record_committed(root, tag, {"save_s": save_host_s,
                                             "commit_s": commit_s})

    if not async_save:
        write_pieces()
        comm.barrier()
        if rank == 0:
            commit_tail(save_host_s)
        comm.barrier()
        if rank != 0 and res is not None:
            res.record_committed(root, tag, None)
    else:
        pending = os.path.join(path, ".pending")
        os.makedirs(pending, exist_ok=True)

        def run():
            t0 = time.perf_counter()
            try:
                write_pieces()
                open(os.path.join(pending, str(rank)), "w").close()
                if rank == 0:
                    while len(os.listdir(pending)) < world:
                        time.sleep(0.01)
                    shutil.rmtree(pending)
                    commit_tail(time.perf_counter() - t0)
                else:
                    while _read_latest(root) != tag:
                        time.sleep(0.01)
                    if res is not None:
                        res.record_committed(root, tag, None)
            except BaseException as e:   # surfaced by wait_for_checkpoint
                engine._ckpt_commit_error = e
                logger.error(f"async checkpoint commit for {path} failed: "
                             f"{e!r}")

        engine._latest_thread = threading.Thread(target=run, daemon=True)
        engine._latest_thread.start()
    log_dist(f"saved checkpoint {path}")
    return path



def _read_latest(root: str) -> str | None:
    try:
        with open(os.path.join(root, "latest")) as f:
            return f.read().strip() or None
    except OSError:
        return None


def _truncate_tag_for_test(path: str) -> None:
    """Fault-injection helper: chop the first state file in half — the
    torn-write shape a node loss mid-flush leaves behind."""
    for dirpath, _, files in os.walk(os.path.join(path, "state")):
        for fn in sorted(files):
            full = os.path.join(dirpath, fn)
            size = os.path.getsize(full)
            if size > 1:
                with open(full, "r+b") as f:
                    f.truncate(size // 2)
                logger.error(f"fault injection: truncated {full} "
                             f"({size} -> {size // 2} bytes)")
                return


def _apply_retention(engine, root: str, current_tag: str) -> None:
    """keep-last-N GC (``checkpoint.keep_n``). Never deletes: the tag just
    written, the 'latest' target, the tag training resumed from, or the
    newest verified rewind target."""
    keep = getattr(engine.config.checkpoint, "keep_n", None)
    if not keep or keep < 1:
        return
    protected = {current_tag}
    try:
        with open(os.path.join(root, "latest")) as f:
            protected.add(f.read().strip())
    except OSError:
        pass
    resume_tag = getattr(engine, "_resume_tag", None)
    if resume_tag:
        protected.add(resume_tag)
    res = getattr(engine, "resilience", None)
    if res is not None and res.last_verified is not None:
        protected.add(res.last_verified[1])
    tags = []
    for d in os.listdir(root):
        p = os.path.join(root, d)
        if os.path.isdir(p) and os.path.exists(os.path.join(p, "meta.json")):
            tags.append((_tag_steps(p), d))
    tags.sort(reverse=True)
    for _, d in tags[keep:]:
        if d in protected:
            continue
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
        logger.info(f"checkpoint retention: removed {os.path.join(root, d)} "
                    f"(keep_n={keep})")


# --------------------------------------------------------------------------
# load
# --------------------------------------------------------------------------

def _resolve_tag(load_dir: str, level: str) -> str:
    """The 'latest' target when it is intact+verified; otherwise the newest
    *verified* tag (then newest legacy tag)."""
    latest_file = os.path.join(load_dir, "latest")
    latest_tag = None
    if os.path.exists(latest_file):
        with open(latest_file) as f:
            latest_tag = f.read().strip() or None
    if latest_tag is not None:
        status, reason = tag_status(os.path.join(load_dir, latest_tag), level)
        if status in ("verified", "legacy"):
            return latest_tag
        logger.error(f"'latest' names tag '{latest_tag}' which is not "
                     f"loadable ({reason}); falling back to the newest "
                     f"verified checkpoint")
    elif os.path.isdir(load_dir):
        logger.error(f"missing/torn 'latest' under {load_dir}; falling back "
                     f"to the newest verified checkpoint")
    else:
        raise FileNotFoundError(f"checkpoint dir {load_dir} does not exist")
    candidates = []
    for d in sorted(os.listdir(load_dir)):
        if d == latest_tag:
            continue  # already rejected above
        p = os.path.join(load_dir, d)
        if not os.path.isdir(p):
            continue
        status, reason = tag_status(p, level)
        if status in ("verified", "legacy"):
            candidates.append((status == "verified", _tag_steps(p), d))
        elif status == "bad":
            logger.warning(f"checkpoint fallback: skipping tag '{d}' "
                           f"({reason})")
    if not candidates:
        raise FileNotFoundError(
            f"no loadable checkpoint under {load_dir} ('latest' is "
            f"{'torn' if latest_tag is None else f'unverifiable: {latest_tag}'}"
            f" and no other tag verifies); pass a tag")
    verified, steps, tag = max(candidates)
    logger.warning(f"checkpoint fallback: resuming from "
                   f"{'verified' if verified else 'legacy'} tag '{tag}' "
                   f"(step {steps:.0f})")
    return tag


def _source(section: str, engine, index: dict, name: str) -> str:
    """The checkpoint section that fills ``section``: the fp32 master feeds
    an fp32 engine's parameters, and a checkpoint without a master (an
    fp32 run) feeds the master from its fp32 parameters."""
    has_master = f"master.{name}" in index
    if section == "params" and not engine.mixed_precision and has_master:
        return "master"
    if section == "master" and not has_master:
        return "params"
    return section


@torch.no_grad()
def _fill(engine, read) -> None:
    """Every target section of every parameter from ``read(section, i)``
    (a flat numpy array in stored form, and its dtype name)."""
    for section in _targets(engine):
        for i in range(len(engine._names)):
            views = _views(engine, section, i, writing=False)
            if not views:
                continue
            flat, dt = read(section, i)
            shape, tp = _shape(engine, i), _tp(engine, i)
            for start, ln, t in views:
                t.copy_(from_stored(_take(flat, shape, tp, start, ln), dt)
                        .to(t.dtype))
    if engine._zero is not None:
        engine._zero.regather_persistent()


def load_checkpoint(engine, load_dir: str, tag: str | None = None) -> dict:
    """Every rank calls this; see the module docstring. Returns the saved
    ``client_state``. Runs under a ``checkpoint_load`` span with a
    restore-time histogram and a flight-recorder breadcrumb (a rewind
    storm shows up as a run of checkpoint_load events)."""
    from ..telemetry import get_telemetry

    telem = get_telemetry()
    t0 = time.perf_counter()
    with telem.span("checkpoint_load", dir=load_dir):
        out = _load_checkpoint_inner(engine, load_dir, tag=tag)
    load_s = time.perf_counter() - t0
    if telem.enabled:
        telem.registry.histogram(
            "checkpoint_load_s", help="load_checkpoint wall time"
        ).observe(load_s)
    telem.note("checkpoint_load", dir=load_dir, load_s=round(load_s, 3))
    return out


@_with_host_state(changed=True)
def _load_checkpoint_inner(engine, load_dir: str,
                           tag: str | None = None) -> dict:
    load_dir = os.path.abspath(load_dir)
    level = getattr(engine.config.checkpoint, "integrity", "crc32")
    wait_for_checkpoint(engine)  # an in-flight async save may be the target
    if tag is None:
        tag = _resolve_tag(load_dir, level)
    else:
        status, reason = tag_status(os.path.join(load_dir, tag), level)
        if status == "missing":
            raise FileNotFoundError(
                f"checkpoint tag '{tag}' not found under {load_dir}")
        if status == "bad":
            # an explicitly requested tag is a user decision — fail loudly
            # rather than silently loading something else
            raise CheckpointIntegrityError(
                f"checkpoint tag '{tag}' under {load_dir} failed "
                f"verification: {reason}")
    path = os.path.join(load_dir, tag)
    state = os.path.join(path, "state")
    with open(os.path.join(state, "index.json")) as f:
        index = json.load(f)
    for section in _targets(engine):
        for name in engine._names:
            src = _source(section, engine, index, name)
            if f"{src}.{name}" not in index:
                raise ValueError(
                    f"checkpoint {path} is missing '{src}.{name}', which "
                    f"the current engine configuration requires")

    def read(section, i):
        name = engine._names[i]
        ent = index[f"{_source(section, engine, index, name)}.{name}"]
        if tuple(ent["shape"]) != _shape(engine, i):
            raise ValueError(f"checkpoint {path}: {name} has shape "
                             f"{ent['shape']}, the model "
                             f"{_shape(engine, i)}")
        a = np.load(os.path.join(state, ent["file"]), mmap_mode="r")
        return a.reshape(-1), ent["dtype"]

    _fill(engine, read)
    scal = {k: np.load(os.path.join(state, v["file"]))
            for k, v in index.items() if v.get("scalar")}
    _set_counters(engine, int(scal["opt_step"]), int(scal["global_step"]))
    if engine.scaler is not None and "scaler.scale" in scal:
        from .fp16 import ScalerState

        engine.scaler = ScalerState(
            scale=float(scal["scaler.scale"]),
            good_steps=int(scal["scaler.good_steps"]),
            hysteresis=int(scal["scaler.hysteresis"]))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    engine.global_steps = meta.get("global_steps", engine.global_step)
    _note_loaded(engine, load_dir, tag)
    log_dist(f"loaded checkpoint {path} (step {engine.global_steps})")
    return meta.get("client_state", {})


def _set_counters(engine, opt_step: int, global_step: int) -> None:
    if getattr(engine, "_host_opt", None) is not None:
        engine._host_opt.step_count = opt_step
    if engine._zero is not None:
        engine._zero.step = opt_step
    else:
        engine.opt_state = engine.opt_state._replace(step=opt_step)
    engine.global_step = global_step


def _note_loaded(engine, load_dir: str, tag: str) -> None:
    """Record the resume target: retention must never GC it, and it is the
    default rewind anchor until the next committed save."""
    engine._resume_tag = tag
    res = getattr(engine, "resilience", None)
    if res is not None:
        res.record_save_dir(load_dir)
        if res.last_verified is None:
            res.last_verified = (load_dir, tag)


# --------------------------------------------------------------------------
# numpy trees in the checkpoint's sections
# --------------------------------------------------------------------------

def _nest(names, arrays) -> dict:
    out: dict = {}
    for name, a in zip(names, arrays):
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return out


def _leaf(tree: dict, name: str):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


@_with_host_state(changed=False)
def state_tree(engine) -> dict:
    """The engine's state as numpy trees in the checkpoint's sections
    (``params`` as fp32 values, ``master``, ``opt_mu``, ``opt_nu``,
    ``opt_step``, ``global_step``); at stages 1-3 gathered, a collective
    every rank joins."""
    z = engine._zero
    out = {}
    for section in _sections(engine):
        if z is None:
            vals = [v[0][2] for v in (_views(engine, section, i, False)
                                      for i in range(len(engine._names)))]
        else:
            if section == "params":
                segs = [z.gather_compute(s)
                        for s in range(len(z.plan.segments))]
            else:
                segs = z.full_segments(
                    {"master": z.master, "opt_mu": z.mu,
                     "opt_nu": z.nu}[section])
            vals = []
            for i in range(len(engine._names)):
                s, k = z.plan.where[i]
                seg = z.plan.segments[s]
                vals.append(segs[s][seg.offsets[k]:seg.offsets[k]
                                    + seg.numels[k]])
        out[section] = _nest(engine._names, [
            engine._whole(i, v.detach().reshape(engine._params[i].shape))
            .float().cpu().numpy() for i, v in enumerate(vals)])
    out["opt_step"] = np.asarray(engine.opt_step, np.int32)
    out["global_step"] = np.asarray(engine.global_step, np.int32)
    return out


@_with_host_state(changed=True)
def load_state_tree(engine, tree: dict) -> None:
    """Load numpy trees in the checkpoint's sections (e.g. a JAX engine's
    ``TrainState``: params, master, opt_state.mu / nu, step) into the
    engine; every rank takes the ranges of its own partition. A tree
    without a master feeds it from its parameters."""
    index = {f"{sec}.{n}": True for sec in ("params", "master", "opt_mu",
                                            "opt_nu")
             if sec in tree and tree[sec] is not None
             for n in engine._names}

    def read(section, i):
        name = engine._names[i]
        src = _source(section, engine, index, name)
        a = np.asarray(_leaf(tree[src], name), np.float32).reshape(-1)
        return a, "float32"

    _fill(engine, read)
    step = int(np.asarray(tree.get("opt_step", 0)))
    _set_counters(engine, step, int(np.asarray(tree.get("global_step",
                                                        step))))
    engine.global_steps = engine.global_step
