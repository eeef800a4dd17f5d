"""Checkpoint save/load of an engine's train state.

Ports ``deepspeed_tpu/checkpoint/engine.py`` (``save_state`` :120,
``finalize_async`` :73, ``load_state`` :300, ``read_latest_tag``,
``load_16bit_model``). The tag layout is the JAX package's with
``writer="fast"``, so both packages read each other's checkpoints with no
conversion step::

    <root>/<tag>/state_fast/manifest.json + one .bin a leaf
    <root>/<tag>/client_state.json
    <root>/<tag>/COMMITTED          per-file size + CRC32, the step
    <root>/latest

Every save lands in ``<tag>.tmp``, is fsynced, gains its ``COMMITTED``
marker and is published by one rename; ``latest`` follows the commit
(``checkpoint/fault_tolerance.py``). The state comes as leaves, (name,
tensor) pairs in JAX's names, produced one at a time: a data-parallel
engine gathers a leaf while the one before is written, so no process holds
whole trees. Every rank iterates the leaves (their gathers are
collectives); only the ``primary`` one writes. ``async_save`` copies every
leaf to host memory before it returns (the next step updates the flat
buffers in place) and leaves the write and the commit to a finalizer
thread, as JAX's async path does; :func:`finalize_async` waits for it.
Whatever the ``writer`` (JAX's orbax default, ``fast``), the port writes
the per-leaf layout; a JAX orbax tag (``<tag>/state``) is refused with the
way across named. Transient I/O errors retry with backoff; saves, loads
and commits record ``span("checkpoint/save" | "checkpoint/load" |
"checkpoint/commit")``, and a ``timings`` dict receives the save's
``gather_s``, ``write_s``, ``fsync_s``, ``crc_s`` and ``bytes``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.checkpoint import fault_tolerance as ft
from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
    FastCheckpointEngine,
    Leaves,
    LeafReader,
    snapshot,
)
from deepspeed_tpu_torch.checkpoint.fault_tolerance import (
    CheckpointCorruptError,
)
from deepspeed_tpu_torch.runtime.config_utils import logger

LATEST_FILE = "latest"
STATE_DIR = "state_fast"        # JAX's writer="fast" directory

_async_thread: Optional[threading.Thread] = None
# appended by the finalizer thread, read after its join (the join is the
# edge that publishes the append)
_async_error: List[BaseException] = []
# serializes save_state / finalize_async across threads; reentrant: a save
# finalizes the one in flight first
_save_lock = threading.RLock()


def finalize_async() -> None:
    """Block until an in-flight async save is COMMITTED (write + marker +
    rename + ``latest``), re-raising any error it hit. The join runs
    outside the lock, so an emergency save is not held for the whole
    write."""
    global _async_thread
    with _save_lock:
        thread, _async_thread = _async_thread, None
    if thread is not None:
        thread.join()
    if _async_error:
        err = _async_error.pop()
        _async_error.clear()
        raise err


def _infer_step(tag: str, client_state: Optional[Dict]) -> Optional[int]:
    if client_state and isinstance(client_state.get("global_steps"), int):
        return client_state["global_steps"]
    digits = "".join(c for c in tag if c.isdigit())
    return int(digits) if digits else None


def save_state(save_dir: str, tag: str, state: Leaves,
               client_state: Optional[Dict] = None, save_latest: bool = True,
               async_save: bool = False, writer: str = "fast",
               keep_n: int = 0, fsync: bool = True, checksums: bool = True,
               retries: int = 3, retry_backoff_s: float = 0.2,
               retry_jitter_s: float = 0.2, protect: Tuple[str, ...] = (),
               primary: bool = True,
               timings: Optional[Dict[str, float]] = None) -> None:
    """Commit-protocol save of ``state`` ((name, leaf) pairs in JAX's
    names, e.g. ``flatten_with_paths`` of a tree) under
    ``<save_dir>/<tag>``. Every process calls it and iterates the leaves;
    only ``primary`` writes.
    ``keep_n > 0`` prunes all but the newest N committed tags after the
    commit, sparing ``protect``. ``writer`` is accepted for JAX's config
    values; every value writes the per-leaf layout."""
    with _save_lock:
        return _save_locked(
            save_dir, tag, state, client_state, save_latest, async_save,
            keep_n, fsync, checksums, retries, retry_backoff_s,
            retry_jitter_s, protect, primary, timings)


def _save_locked(save_dir, tag, state, client_state, save_latest,
                 async_save, keep_n, fsync, checksums, retries,
                 retry_backoff_s, retry_jitter_s, protect, primary,
                 timings) -> None:
    global _async_thread
    finalize_async()        # at most one save in flight
    timings = {} if timings is None else timings
    if not primary:
        # the gathers are collectives: every rank runs them
        t0 = time.perf_counter()
        for _ in state:
            pass
        timings["gather_s"] = time.perf_counter() - t0
        return
    os.makedirs(save_dir, exist_ok=True)
    tmp = ft.tmp_dir_for(save_dir, tag)
    shutil.rmtree(tmp, ignore_errors=True)      # a crashed earlier attempt
    os.makedirs(tmp, exist_ok=True)
    step = _infer_step(tag, client_state)
    retry_kw = dict(attempts=retries, backoff_s=retry_backoff_s,
                    jitter_s=retry_jitter_s, kind="save")

    def retry(fn, what):
        return ft.with_retries(fn, what, **retry_kw)

    def write(items):
        FastCheckpointEngine().save(items, os.path.join(tmp, STATE_DIR),
                                    retry=retry, timings=timings)
        with open(os.path.join(tmp, "client_state.json"), "w") as f:
            json.dump(client_state or {}, f, default=str)

    def commit_and_publish():
        with telemetry.span("checkpoint/commit"):
            ft.commit_tag(save_dir, tmp, tag, step=step, fsync=fsync,
                          checksums=checksums, timings=timings)
            if save_latest:
                retry(lambda: ft.write_latest(save_dir, tag, LATEST_FILE,
                                              fsync=fsync), "write_latest")
            ft.gc_tags(save_dir, keep_n,
                       protect=(tag, os.path.basename(tmp)) + tuple(protect))

    if not async_save:
        with telemetry.span("checkpoint/save"):
            write(state)
            commit_and_publish()
        return

    t0 = time.perf_counter()
    with telemetry.span("checkpoint/save"):
        held = snapshot(state)
    timings["gather_s"] = time.perf_counter() - t0

    def finalize():
        try:
            write(held)
            commit_and_publish()
        except BaseException as e:      # surfaced by finalize_async()
            _async_error.append(e)
        finally:
            held.clear()

    _async_thread = threading.Thread(target=finalize, daemon=True,
                                     name="dstpu-ckpt-async-commit")
    _async_thread.start()


def read_latest_tag(load_dir: str) -> Optional[str]:
    latest = os.path.join(load_dir, LATEST_FILE)
    if os.path.exists(latest):
        with open(latest) as f:
            tag = f.read().strip()
        # an empty latest (a torn legacy write) is missing, not a tag
        return tag or None
    return None


def _resolve_restore_tag(load_dir: str, checksums: bool) -> str:
    """tag=None: the newest committed tag that verifies (walk-back over
    torn or corrupt heads); a legacy ``latest`` tag without a marker loads
    with a warning."""
    tag = ft.find_restore_tag(load_dir, checksums=checksums)
    if tag is not None:
        latest = read_latest_tag(load_dir)
        if latest is not None and latest != tag:
            logger.warning(
                f"'latest' names {latest!r} but the newest committed+intact "
                f"tag is {tag!r} — restoring {tag!r} (a crash between "
                "commit and the latest update, or a corrupt head tag)")
        return tag
    legacy = read_latest_tag(load_dir)
    if legacy is not None and os.path.isdir(os.path.join(load_dir, legacy)):
        logger.warning(
            f"checkpoint tag {legacy!r} predates the commit protocol (no "
            "COMMITTED marker) — loading WITHOUT integrity verification")
        return legacy
    raise FileNotFoundError(
        f"no committed checkpoint (and no legacy 'latest' tag) in {load_dir}")


def resolve_tag(load_dir: str, tag: Optional[str],
                verify_checksums: bool = True) -> str:
    """The tag a load restores: ``tag=None`` walks back to the newest
    committed tag that verifies; a named tag that fails verification
    raises :class:`CheckpointCorruptError`."""
    if tag is None:
        return _resolve_restore_tag(load_dir, verify_checksums)
    marker = ft.read_marker(load_dir, tag)
    if marker is None:
        if not os.path.isdir(os.path.join(load_dir, tag)):
            raise FileNotFoundError(
                f"checkpoint tag {tag!r} not found in {load_dir}")
        logger.warning(
            f"checkpoint tag {tag!r} has no COMMITTED marker "
            "(pre-protocol save) — loading WITHOUT verification")
        return tag
    ok, why = ft.verify_tag(load_dir, tag, checksums=verify_checksums)
    if not ok:
        raise CheckpointCorruptError(
            f"checkpoint tag {tag!r} failed verification: {why} "
            "(pass tag=None to walk back to the newest intact "
            "committed tag)")
    return tag


def open_state(tag_dir: str) -> LeafReader:
    """The per-leaf state of a tag directory; a JAX orbax tag is refused
    with the way across."""
    fast = os.path.join(tag_dir, STATE_DIR)
    if os.path.isdir(fast):
        return LeafReader(fast)
    if os.path.exists(os.path.join(tag_dir, "state")):
        raise NotImplementedError(
            f"{tag_dir} holds an orbax checkpoint (<tag>/state), which "
            "needs JAX and tensorstore to read. Save it from the JAX "
            "package with checkpoint.writer 'fast' (the per-leaf layout "
            "both packages read), or convert it there with "
            "deepspeed_tpu.checkpoint.universal.convert_to_universal and "
            "load the universal dir with engine.load_universal_checkpoint")
    raise FileNotFoundError(f"checkpoint not found: {fast}")


def read_client_state(tag_dir: str) -> Dict:
    path = os.path.join(tag_dir, "client_state.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def load_state(load_dir: str, tag: Optional[str] = None,
               verify_checksums: bool = True
               ) -> Tuple[LeafReader, Dict, str]:
    """The committed state of ``tag`` (``None``: the newest that verifies)
    as a :class:`LeafReader` (each leaf read when asked for), its client
    state and the tag. The marker is verified first; a named tag that
    fails raises :class:`CheckpointCorruptError`."""
    finalize_async()        # a load observes any save in flight
    with telemetry.span("checkpoint/load"):
        tag = resolve_tag(load_dir, tag, verify_checksums)
        path = os.path.abspath(os.path.join(load_dir, tag))
        return open_state(path), read_client_state(path), tag


# --------------------------------------------------------------------- #
# the 16-bit export (JAX engine.save_16bit_model / load_16bit_model)
# --------------------------------------------------------------------- #
def write_16bit_npz(save_dir: str, filename: str,
                    flat: Dict[str, torch.Tensor]) -> None:
    """``np.savez`` of the leaves with JAX's ``<filename>.dtypes.json``
    sidecar. numpy has no bf16 here: a bf16 leaf is stored as its raw
    2-byte values (numpy reads JAX's file back the same way, as ``V2``),
    and the sidecar names ``bfloat16``."""
    os.makedirs(save_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, t in flat.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arrays[k] = t.view(torch.int16).numpy().view(np.dtype("V2"))
            dtypes[k] = "bfloat16"
        else:
            arrays[k] = t.numpy()
            dtypes[k] = str(arrays[k].dtype)
    np.savez(os.path.join(save_dir, filename), **arrays)
    with open(os.path.join(save_dir, filename + ".dtypes.json"), "w") as f:
        json.dump(dtypes, f)


def load_16bit_model(save_dir: str, filename: str = "pytorch_model.npz"
                     ) -> Dict[str, torch.Tensor]:
    """A ``save_16bit_model`` export (either package's) as tensors of the
    dtypes its sidecar names: numpy reads bf16 entries back as raw ``V2``
    bytes, which become bf16 tensors by a view, without ml_dtypes."""
    from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
        resolve_dtype,
    )

    path = os.path.join(save_dir, filename)
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    dtypes: Dict[str, str] = {}
    side = path + ".dtypes.json"
    if os.path.exists(side):
        with open(side) as f:
            dtypes = json.load(f)
    out = {}
    for k, arr in data.items():
        want = dtypes.get(k)
        if want == "bfloat16" or arr.dtype.kind == "V":
            raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            out[k] = raw.view(resolve_dtype(want or "bfloat16"))
        else:
            out[k] = torch.from_numpy(np.array(arr))
    return out
