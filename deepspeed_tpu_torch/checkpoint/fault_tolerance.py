"""Crash-consistent checkpoint commits: atomic rename, integrity manifest,
walk-back recovery, retention GC, and transient-I/O retry.

A copy of ``deepspeed_tpu/checkpoint/fault_tolerance.py`` (the port
imports nothing of the JAX package): the same protocol and the same
``COMMITTED`` marker, so a tag committed by either package verifies under
the other's :func:`verify_tag`.

1. every writer lands its payload in ``<root>/<tag>.tmp``, a name the
   loader never considers;
2. the payload is fsynced, then a ``COMMITTED`` marker (JSON manifest:
   step metadata + per-file size/CRC32) is written inside the tmp dir
   with its own write-fsync-rename;
3. one ``os.rename(tmp, <tag>)`` publishes the tag: a tag dir either has
   everything and its marker or does not exist;
4. only after the rename does ``latest`` update (write-fsync-rename too).

Recovery inverts the protocol: a tag restores only if its marker is
present and every manifest entry matches on size (and CRC32 unless
disabled); a torn or corrupt tag is skipped and the loader walks back to
the newest tag that verifies.

:func:`commit_tag` can record the seconds of its fsync and CRC passes in a
``timings`` dict (the checkpoint layer's ``fsync_s`` / ``crc_s``). The
files' fsyncs and CRC passes run on a few threads (JAX's run one file
after another): the same manifest, sooner. The JAX package's
fault-injection hooks (``chaos_point``) come with the port's
``testing/chaos.py``.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.runtime.config_utils import logger

COMMIT_MARKER = "COMMITTED"
MANIFEST_VERSION = 1


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested tag failed integrity verification."""


def _counter(name: str, description: str = ""):
    return telemetry.counter(name, description)


def _add(timings: Optional[Dict[str, float]], key: str, t0: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _each_file(fn, paths: List[str]) -> List[Any]:
    """``fn`` over the files on a few threads (fsync and zlib's CRC release
    the interpreter lock; a tag is tens of files of up to GBs), results in
    order."""
    if len(paths) < 2:
        return [fn(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        return list(pool.map(fn, paths))


# --------------------------------------------------------------------- #
# durability primitives
# --------------------------------------------------------------------- #
def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    # a directory fsync makes the rename itself durable; some filesystems
    # (tmpfs among them) reject it: best-effort there
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_tree(root: str) -> None:
    """fsync every file, then every directory bottom-up."""
    walk = list(os.walk(root, topdown=False))
    _each_file(fsync_file, [os.path.join(d, n) for d, _, names in walk
                            for n in names])
    for dirpath, _, _ in walk:
        fsync_dir(dirpath)


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    """write-fsync-rename a small text file (marker, ``latest``)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.rename(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


# --------------------------------------------------------------------- #
# manifest + commit
# --------------------------------------------------------------------- #
def tmp_dir_for(root: str, tag: str) -> str:
    # deterministic: every process names the same directory, and the
    # loader never considers .tmp names
    return os.path.join(root, f"{tag}.tmp")


def is_tmp_name(name: str) -> bool:
    return ".tmp-" in name or name.endswith(".tmp") or ".old-" in name


def build_manifest(tag_dir: str, step: Optional[int] = None,
                   extra: Optional[Dict[str, Any]] = None,
                   checksums: bool = True) -> Dict[str, Any]:
    files: Dict[str, Dict[str, Any]] = {}
    for dirpath, _, names in os.walk(tag_dir):
        for name in names:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, tag_dir)
            if rel == COMMIT_MARKER or rel.startswith(COMMIT_MARKER + ".tmp"):
                continue
            files[rel] = {"size": os.path.getsize(full)}
    if checksums:
        crcs = _each_file(crc32_file, [os.path.join(tag_dir, rel)
                                       for rel in files])
        for info, crc in zip(files.values(), crcs):
            info["crc32"] = crc
    manifest = {
        "version": MANIFEST_VERSION,
        "step": step,
        # the marker's timestamp, also the commit-recency tie-break in
        # committed_tags: wall clock is the point here
        "wall_time": time.time(),
        "files": files,
    }
    if extra:
        manifest.update(extra)
    return manifest


def commit_tag(root: str, tmp_dir: str, tag: str, step: Optional[int] = None,
               fsync: bool = True, checksums: bool = True,
               extra: Optional[Dict[str, Any]] = None,
               timings: Optional[Dict[str, float]] = None) -> str:
    """Durably publish ``tmp_dir`` as ``<root>/<tag>`` (steps 2-3 of the
    protocol). Returns the final tag path. ``timings`` receives
    ``fsync_s`` (the payload's fsync) and ``crc_s`` (the manifest's
    size and CRC32 pass)."""
    t0 = time.perf_counter()
    if fsync:
        fsync_tree(tmp_dir)
    _add(timings, "fsync_s", t0)
    t0 = time.perf_counter()
    manifest = build_manifest(tmp_dir, step=step, extra=extra,
                              checksums=checksums)
    _add(timings, "crc_s", t0)
    atomic_write_text(os.path.join(tmp_dir, COMMIT_MARKER),
                      json.dumps(manifest), fsync=fsync)
    final = os.path.join(root, tag)
    if os.path.exists(final):
        # overwrite by rename-swap: the tag is never observable half-new;
        # a crash between the renames loses this tag, and the loader walks
        # back to an older committed one
        trash = os.path.join(root, f"{tag}.old-{os.getpid()}")
        shutil.rmtree(trash, ignore_errors=True)
        os.rename(final, trash)
        os.rename(tmp_dir, final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.rename(tmp_dir, final)
    if fsync:
        fsync_dir(root)
    return final


def write_latest(root: str, tag: str, latest_file: str = "latest",
                 fsync: bool = True) -> None:
    atomic_write_text(os.path.join(root, latest_file), tag, fsync=fsync)


# --------------------------------------------------------------------- #
# verification + recovery
# --------------------------------------------------------------------- #
def read_marker(root: str, tag: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(root, tag, COMMIT_MARKER)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError) as e:
        logger.warning(f"unreadable commit marker {path}: {e}")
        return None


def verify_tag(root: str, tag: str, checksums: bool = True
               ) -> Tuple[bool, str]:
    """Integrity check of a published tag against its commit manifest."""
    marker = read_marker(root, tag)
    if marker is None:
        return False, "no COMMITTED marker (torn or pre-protocol save)"
    tag_dir = os.path.join(root, tag)
    files = marker.get("files", {})
    for rel, info in files.items():
        full = os.path.join(tag_dir, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel!r}"
        size = os.path.getsize(full)
        if size != info.get("size"):
            return False, (f"size mismatch for {rel!r}: "
                           f"{size} != {info.get('size')}")
    if checksums:
        rels = [rel for rel, info in files.items() if "crc32" in info]
        crcs = _each_file(crc32_file, [os.path.join(tag_dir, rel)
                                       for rel in rels])
        for rel, crc in zip(rels, crcs):
            if crc != files[rel]["crc32"]:
                return False, f"checksum mismatch for {rel!r}"
    return True, "ok"


def committed_tags(root: str) -> List[str]:
    """Tags carrying a commit marker, newest first (marker step, then
    marker wall time)."""
    out = []
    try:
        names = os.listdir(root)
    except (FileNotFoundError, NotADirectoryError):
        return []
    for name in names:
        if is_tmp_name(name) or not os.path.isdir(os.path.join(root, name)):
            continue
        marker = read_marker(root, name)
        if marker is None:
            continue
        step = marker.get("step")
        out.append((step if isinstance(step, (int, float)) else -1,
                    marker.get("wall_time") or 0.0, name))
    out.sort(reverse=True)
    return [name for _, _, name in out]


def find_restore_tag(root: str, checksums: bool = True,
                     exclude: Tuple[str, ...] = ()) -> Optional[str]:
    """Newest committed tag that passes verification: the walk-back the
    loader relies on when the head tag is torn or corrupt."""
    for tag in committed_tags(root):
        if tag in exclude:
            continue
        ok, why = verify_tag(root, tag, checksums=checksums)
        if ok:
            return tag
        _counter("checkpoint_verify_failures_total",
                 "published tags that failed integrity verification"
                 ).inc(reason="corrupt")
        logger.warning(
            f"checkpoint tag {tag!r} failed verification ({why}) — "
            "walking back to an older committed tag")
    return None


# --------------------------------------------------------------------- #
# retention GC
# --------------------------------------------------------------------- #
def gc_tags(root: str, keep_n: int,
            protect: Tuple[str, ...] = ()) -> int:
    """Keep the newest ``keep_n`` committed tags; remove the rest plus any
    stale tmp/old dirs from crashed writers. ``keep_n <= 0`` keeps all
    (the tmp-dir cleanup still runs). Returns the number of dirs
    removed."""
    removed = 0
    try:
        names = os.listdir(root)
    except (FileNotFoundError, NotADirectoryError):
        return 0
    for name in names:
        # stale tmp/old dirs of crashed writers: GC runs on the writing
        # process right after its own commit (one save in flight), so no
        # tmp of this run can be live
        full = os.path.join(root, name)
        if is_tmp_name(name) and os.path.isdir(full) and name not in protect:
            shutil.rmtree(full, ignore_errors=True)
            removed += 1
    if keep_n > 0:
        tags = committed_tags(root)
        for tag in tags[keep_n:]:
            if tag in protect:
                continue
            shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
            removed += 1
    if removed:
        _counter("checkpoint_gc_removed_total",
                 "checkpoint dirs removed by retention GC "
                 "(old tags + stale tmp dirs)").inc(removed)
    return removed


# --------------------------------------------------------------------- #
# transient-I/O retry
# --------------------------------------------------------------------- #
def with_retries(fn, what: str, attempts: int = 3, backoff_s: float = 0.2,
                 jitter_s: float = 0.2, kind: str = "save"):
    """Run ``fn`` with exponential backoff + jitter on OSError. Counts
    every retry and every exhausted failure."""
    attempts = max(1, int(attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            if attempt + 1 >= attempts:
                _counter(f"checkpoint_{kind}_failures_total",
                         f"checkpoint {kind} operations that exhausted "
                         "their retries").inc(op=what)
                raise
            _counter(f"checkpoint_{kind}_retries_total",
                     f"transient-I/O retries on checkpoint {kind} paths"
                     ).inc(op=what)
            delay = backoff_s * (2 ** attempt) + random.random() * jitter_s
            logger.warning(
                f"checkpoint {kind} {what!r} failed ({e}); retry "
                f"{attempt + 1}/{attempts - 1} in {delay:.2f}s")
            time.sleep(delay)
