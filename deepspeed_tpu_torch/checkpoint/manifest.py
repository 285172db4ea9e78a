"""Checkpoint integrity manifests: the verified-checkpoint contract.

A copy of ``deepspeed_tpu/checkpoint/manifest.py`` (free of any
framework there already), but for one thing: a tag's files are
checksummed side by side in threads. One tag dir on disk is::

    <save_dir>/<tag>/state/...        the committed state payload
    <save_dir>/<tag>/meta.json        writer metadata
    <save_dir>/<tag>/manifest.json    per-entry size+crc32 (commit proof)
    <save_dir>/latest                 text file naming the newest tag

The write protocol (state commit → ``manifest.json`` → atomic ``latest``
rename) is the writer's side of the contract (``runtime/checkpointing.py``);
:func:`tag_status` is the reader's: a tag is ``verified`` only when every
manifest entry exists at its recorded size and crc32.
:func:`manifest_digest` derives the stable content digest a fleet uses as
its ``weight_version`` fingerprint — two replicas agree on the digest iff
they loaded byte-identical state.
"""
from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def _crc_workers() -> ThreadPoolExecutor:
    """Threads that checksum a tag's files side by side: the reads and
    ``zlib.crc32`` over a chunk both release the GIL, so a tag of many
    files is checksummed at the host's cores' rate, not one core's."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def write_file_atomic(target: str, content: str) -> None:
    """tmp + ``os.replace``: readers see the old content or the new,
    never a torn/empty file — a crash mid-write cannot poison the tag."""
    tmp = f"{target}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(content)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)


def write_manifest(path: str, tag: str, global_steps: int,
                   level: str = "crc32") -> None:
    """Commit proof for ``<path>`` (one tag dir): every file's size (and
    crc32 under the full integrity level), written atomically AFTER the
    state commit and BEFORE the 'latest' advance."""
    if level == "none":
        return
    entries: dict[str, dict] = {}
    fulls: dict[str, str] = {}
    for dirpath, _, files in os.walk(path):
        for fn in sorted(files):
            if dirpath == path and fn == "manifest.json":
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, path)
            entries[rel] = {"size": os.path.getsize(full)}
            fulls[rel] = full
    if level == "crc32":
        with _crc_workers() as ex:
            for rel, crc in zip(fulls, ex.map(file_crc32, fulls.values())):
                entries[rel]["crc32"] = crc
    doc = {"version": 1, "tag": tag, "global_steps": int(global_steps),
           "integrity": level, "entries": entries}
    write_file_atomic(os.path.join(path, "manifest.json"),
                      json.dumps(doc, indent=2))


def tag_status(path: str, level: str = "crc32") -> tuple[str, str]:
    """Classify one tag dir: ``verified`` (manifest checks out),
    ``legacy`` (complete but pre-manifest), ``bad`` (truncated/corrupt),
    ``missing``."""
    if not os.path.isdir(path):
        return "missing", "no such tag dir"
    if not os.path.exists(os.path.join(path, "meta.json")):
        return "bad", "meta.json missing"
    if not os.path.isdir(os.path.join(path, "state")):
        return "bad", "state dir missing"
    man_path = os.path.join(path, "manifest.json")
    if not os.path.exists(man_path):
        return "legacy", "no manifest (pre-integrity checkpoint)"
    try:
        with open(man_path) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return "bad", f"manifest unreadable: {e}"
    entries = man.get("entries")
    if not isinstance(entries, dict):
        return "bad", "manifest entries malformed"
    ex = _crc_workers()
    try:
        # every checksum the checks below read, started at once; the checks
        # still run in manifest order, so the first bad entry is reported
        crcs = {}
        for rel, ent in entries.items():
            full = os.path.join(path, rel)
            if level == "crc32" and isinstance(ent, dict) \
                    and "crc32" in ent and os.path.exists(full) \
                    and os.path.getsize(full) == ent.get("size"):
                crcs[rel] = ex.submit(file_crc32, full)
        for rel, ent in entries.items():
            if not isinstance(ent, dict):
                return "bad", f"entry malformed: {rel}"
            full = os.path.join(path, rel)
            if not os.path.exists(full):
                return "bad", f"entry missing: {rel}"
            size = os.path.getsize(full)
            if size != ent.get("size"):
                # .get twice: a tampered manifest may lack the key
                # entirely, and the integrity gate must CLASSIFY that,
                # never raise
                return "bad", (f"entry truncated: {rel} "
                               f"({size} != {ent.get('size')})")
            if level == "crc32" and "crc32" in ent:
                crc = crcs[rel].result() if rel in crcs \
                    else file_crc32(full)      # written since the start
                if crc != ent["crc32"]:
                    return "bad", f"entry checksum mismatch: {rel}"
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    return "verified", ""


def manifest_digest(path: str) -> str:
    """Stable content fingerprint of a tag dir: crc32 (hex) of its
    ``manifest.json`` bytes. Because the manifest commits to every state
    file's size+crc32, two processes compute the same digest iff they
    hold byte-identical committed state — which is exactly what a fleet's
    ``weight_version`` must certify. Raises ``OSError`` when the tag has
    no manifest (a legacy tag cannot anchor a versioned deploy)."""
    return format(file_crc32(os.path.join(path, "manifest.json")), "08x")


def resolve_tag(ckpt_dir: str, tag: str | None = None,
                level: str = "crc32") -> tuple[str, str]:
    """Resolve ``(tag, reason-why-not)`` for a deploy/load: an explicit
    ``tag`` is verified and returned (or ``("", reason)`` on failure — an
    explicitly named tag never silently falls back); otherwise the
    ``latest`` target is used when it verifies, falling back to the
    newest *verified* tag. Returns ``("", reason)`` when nothing under
    ``ckpt_dir`` verifies."""
    if tag is not None:
        status, reason = tag_status(os.path.join(ckpt_dir, tag), level)
        if status == "verified":
            return tag, ""
        return "", f"tag '{tag}' {status}: {reason or 'unverifiable'}"
    latest_file = os.path.join(ckpt_dir, "latest")
    latest = None
    if os.path.exists(latest_file):
        try:
            with open(latest_file) as f:
                latest = f.read().strip() or None
        except OSError:
            latest = None
    if latest is not None:
        status, _ = tag_status(os.path.join(ckpt_dir, latest), level)
        if status == "verified":
            return latest, ""
    if not os.path.isdir(ckpt_dir):
        return "", f"checkpoint dir {ckpt_dir} does not exist"
    best: tuple[float, str] | None = None
    for d in sorted(os.listdir(ckpt_dir)):
        p = os.path.join(ckpt_dir, d)
        if not os.path.isdir(p) or d == latest:
            continue
        status, _ = tag_status(p, level)
        if status != "verified":
            continue
        steps = -1.0
        for fn in ("manifest.json", "meta.json"):
            try:
                with open(os.path.join(p, fn)) as f:
                    s = json.load(f).get("global_steps")
                if s is not None:
                    steps = float(s)
                    break
            except (OSError, ValueError):
                continue
        if best is None or (steps, d) > best:
            best = (steps, d)
    if best is None:
        return "", f"no verified checkpoint under {ckpt_dir}"
    return best[1], ""
