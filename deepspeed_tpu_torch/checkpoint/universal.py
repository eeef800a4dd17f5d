"""Universal checkpoint: the topology-free per-parameter atom format.

Ports ``deepspeed_tpu/checkpoint/universal.py`` (``convert_to_universal``
:106, ``read_manifest`` :244, ``load_atom`` :249, ``repartition_rank_rows``
:293, ``load_universal_into_engine`` :357, ``main``). The format string
stays ``deepspeed_tpu_universal/2``, so each package loads the other's
universal dirs::

    <out>/
      COMMITTED                     per-file size + CRC32
      universal_manifest.json       params, shapes, moments, scalars
      zero/<param-path>/fp32.npy    the fp32 master
      zero/<param-path>/<moment>.npy
      zero/<param-path>/loco_err.npy    per-rank rows [world, *shape]
      client_state.json

The port's :func:`convert_to_universal` reads the native per-leaf layout
(``<tag>/state_fast``, either package's ``writer="fast"``), leaf by leaf;
JAX's reads its orbax tags. The conversion commits through the protocol of
``checkpoint/fault_tolerance.py``. Per-rank state with a leading world dim
(LoCo's ``loco_err``) is stored with its source world and re-partitioned
sum-preservingly onto the loading engine's world. The fp16 scaler's fields
are stored under their leaf names (``.scale``, ``.good_steps``,
``.hysteresis``).

    python -m deepspeed_tpu_torch.checkpoint.universal <ckpt_dir> <out_dir> [--tag TAG]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.fault_tolerance import (
    COMMIT_MARKER,
    CheckpointCorruptError,
    commit_tag,
    crc32_file,
    read_marker,
    tmp_dir_for,
)

MANIFEST = "universal_manifest.json"
FORMAT = "deepspeed_tpu_universal/2"

#: per-rank state trees carrying a leading world dim: name → where the
#: tree lives in the state ("state" = top level, "opt" = inside opt)
RANK_STATE_TREES = {"loco_err": "state", "worker_error": "opt"}


def _np(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy (the universal atoms hold fp32 and integer
    arrays)."""
    return t.detach().cpu().numpy()


def _save_npy(d: str, name: str, arr: np.ndarray) -> None:
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, f"{name}.npy"), arr)


def convert_to_universal(checkpoint_dir: str, out_dir: str,
                         tag: Optional[str] = None,
                         fsync: bool = True) -> str:
    """Offline conversion of a committed native checkpoint (the
    ``ds_to_universal`` analog), on the host, a leaf at a time. Atoms land
    in ``<out>.tmp``, are fsynced, gain a ``COMMITTED`` marker with
    per-file CRC32s, and one rename publishes the dir."""
    from deepspeed_tpu_torch.checkpoint.engine import (
        open_state,
        read_client_state,
        read_latest_tag,
    )

    tag = tag or read_latest_tag(checkpoint_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' tag in {checkpoint_dir}")
    tag_dir = os.path.join(checkpoint_dir, tag)
    reader = open_state(tag_dir)
    out_dir = os.path.abspath(out_dir)
    root, base = os.path.dirname(out_dir) or ".", os.path.basename(out_dir)
    os.makedirs(root, exist_ok=True)
    tmp = tmp_dir_for(root, base)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    names = reader.names
    step = int(reader["step"]) if "step" in reader else 0
    manifest: Dict[str, Any] = {
        "format": FORMAT, "source_tag": tag, "step": step, "params": {},
        "optimizer_moments": [], "optimizer_scalars": {}, "rank_state": {}}
    params = [n[len("master/"):] for n in names if n.startswith("master/")]
    for p in params:
        arr = _np(reader[f"master/{p}"]).astype(np.float32)
        _save_npy(os.path.join(tmp, "zero", p), "fp32", arr)
        manifest["params"][p] = {"shape": list(arr.shape),
                                 "dtype": str(arr.dtype)}
    moments = []
    for n in names:
        if n.startswith("opt/") and n != "opt/step":
            m = n.split("/")[1]
            if m not in moments:
                moments.append(m)
    for m in moments:
        rank_tree = m in RANK_STATE_TREES
        world = None
        for p in params:
            key = f"opt/{m}/{p}"
            if key in reader:
                arr = _np(reader[key])
                _save_npy(os.path.join(tmp, "zero", p), m, arr)
                world = int(arr.shape[0]) if arr.ndim else None
        if rank_tree:
            manifest["rank_state"][m] = {"location": RANK_STATE_TREES[m],
                                         "world": world}
        else:
            manifest["optimizer_moments"].append(m)
    if "opt/step" in reader:
        manifest["optimizer_scalars"]["step"] = int(reader["opt/step"])
    tops = []
    for n in names:
        top = n.split("/")[0]
        if top not in ("master", "opt", "step") and top not in tops:
            tops.append(top)
    for top in tops:
        if top in RANK_STATE_TREES:
            world = None
            for p in params:
                key = f"{top}/{p}"
                if key in reader:
                    arr = _np(reader[key])
                    _save_npy(os.path.join(tmp, "zero", p), top, arr)
                    world = int(arr.shape[0])
            manifest["rank_state"][top] = {
                "location": RANK_STATE_TREES[top], "world": world}
            continue
        if top in names:
            manifest["optimizer_scalars"][top] = _np(reader[top]).tolist()
        else:
            manifest["optimizer_scalars"][top] = {
                n[len(top) + 1:]: _np(reader[n]).tolist()
                for n in names if n.startswith(top + "/")}

    client_state = read_client_state(tag_dir)
    if client_state:
        with open(os.path.join(tmp, "client_state.json"), "w") as f:
            json.dump(client_state, f)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    commit_tag(root, tmp, base, step=step, fsync=fsync,
               extra={"universal_format": 2, "source_tag": tag})
    return out_dir


def _commit_files(universal_dir: str) -> Dict[str, Any]:
    """The committed per-file manifest of a universal dir; raises
    :class:`CheckpointCorruptError` when the dir was never committed."""
    root = os.path.dirname(os.path.abspath(universal_dir)) or "."
    marker = read_marker(root, os.path.basename(
        os.path.abspath(universal_dir)))
    if marker is None:
        raise CheckpointCorruptError(
            f"universal checkpoint {universal_dir!r} has no "
            f"{COMMIT_MARKER} marker — torn or pre-protocol conversion; "
            "re-run the conversion against the native checkpoint")
    return marker.get("files", {})


def read_manifest(universal_dir: str) -> Dict[str, Any]:
    _commit_files(universal_dir)   # committed dirs only
    with open(os.path.join(universal_dir, MANIFEST)) as f:
        return json.load(f)


def load_atom(universal_dir: str, param_name: str, kind: str = "fp32",
              verify: bool = True,
              _files: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """One atom, its CRC32 verified against the commit manifest first. A
    corrupt, truncated or missing atom raises
    :class:`CheckpointCorruptError` naming it."""
    atom = f"zero/{param_name}/{kind}.npy"
    path = os.path.join(universal_dir, "zero", param_name, f"{kind}.npy")
    if verify:
        files = _files if _files is not None else _commit_files(universal_dir)
        info = files.get(atom.replace("/", os.sep)) or files.get(atom)
        if info is None:
            raise CheckpointCorruptError(
                f"atom {atom!r} is not in the commit manifest of "
                f"{universal_dir!r} — the conversion never wrote it")
        if not os.path.exists(path):
            raise CheckpointCorruptError(
                f"atom {atom!r} is committed but missing on disk "
                f"({universal_dir!r})")
        size = os.path.getsize(path)
        if size != info.get("size"):
            raise CheckpointCorruptError(
                f"atom {atom!r} size mismatch: {size} != "
                f"{info.get('size')} (truncated write?)")
        if "crc32" in info and crc32_file(path) != info["crc32"]:
            raise CheckpointCorruptError(
                f"atom {atom!r} failed CRC32 verification — bit rot or "
                "partial overwrite; restore from the native checkpoint")
    try:
        return np.load(path)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"atom {atom!r} unreadable as .npy: {e}") from e


def repartition_rank_rows(arr: np.ndarray, new_world: int) -> np.ndarray:
    """Sum-preserving re-partition of a per-rank leading world dim: the
    sum over rank rows (the un-communicated error) survives a world
    change exactly. Shrinking folds contiguous old-rank groups into each
    new rank; growing places the old rows first and zero-fills."""
    old_world = int(arr.shape[0])
    new_world = int(new_world)
    if old_world == new_world:
        return arr
    out = np.zeros((new_world,) + arr.shape[1:], dtype=arr.dtype)
    if new_world < old_world and old_world % new_world == 0:
        g = old_world // new_world
        out[:] = arr.reshape((new_world, g) + arr.shape[1:]).sum(axis=1)
    elif new_world > old_world:
        out[:old_world] = arr
    else:
        # a non-dividing shrink: round-robin fold (still sum-preserving)
        for i in range(old_world):
            out[i % new_world] += arr[i]
    return out


def universal_reader(universal_dir: str, new_world: int
                     ) -> Callable[[str], Optional[torch.Tensor]]:
    """The universal dir as the engine's leaf reader: JAX's state names
    (``master/<p>``, ``opt/<moment>/<p>``, ``opt/step``, ``step``,
    ``loco_err/<p>`` re-partitioned onto ``new_world``, ``scaler/.scale``,
    ``skips``) → a tensor, None where the dir has no such leaf."""
    files = _commit_files(universal_dir)
    manifest = read_manifest(universal_dir)
    scalars = manifest.get("optimizer_scalars", {})
    params = manifest["params"]

    def atom(p: str, kind: str) -> Optional[torch.Tensor]:
        if p not in params or not os.path.exists(os.path.join(
                universal_dir, "zero", p, f"{kind}.npy")):
            return None
        return torch.from_numpy(np.array(load_atom(universal_dir, p, kind,
                                                   _files=files)))

    def read(name: str) -> Optional[torch.Tensor]:
        top, _, rest = name.partition("/")
        if name == "step":
            return torch.tensor(int(manifest.get("step", 0)),
                                dtype=torch.int32)
        if name == "opt/step":
            if "step" not in scalars:
                return None
            return torch.tensor(int(scalars["step"]), dtype=torch.int32)
        if top == "master":
            return atom(rest, "fp32")
        if top == "opt":
            moment, _, p = rest.partition("/")
            if moment in RANK_STATE_TREES:
                t = atom(p, moment)
                return None if t is None else torch.from_numpy(
                    repartition_rank_rows(t.numpy(), new_world))
            return atom(p, moment) if moment in manifest[
                "optimizer_moments"] else None
        if top in RANK_STATE_TREES:
            t = atom(rest, top)
            return None if t is None else torch.from_numpy(
                repartition_rank_rows(t.numpy(), new_world))
        if top in scalars:
            val = scalars[top]
            if rest:
                if not isinstance(val, dict) or rest not in val:
                    return None
                val = val[rest]
            return torch.from_numpy(np.array(val))
        return None

    return read


def load_universal_into_engine(engine, universal_dir: str,
                               load_optimizer_states: bool = True) -> None:
    """Restore a universal checkpoint into a live engine of any class at
    any world: the master and the moments as whole leaves (each rank keeps
    its part), LoCo's rows re-partitioned sum-preservingly onto the
    engine's world, the fp16 scaler and the client state."""
    read = universal_reader(universal_dir, engine.world_for_rank_state())
    cs_path = os.path.join(universal_dir, "client_state.json")
    client_state: Dict[str, Any] = {}
    if os.path.exists(cs_path):
        with open(cs_path) as f:
            client_state = json.load(f)
    engine._restore(read, client_state, load_optimizer_states,
                    load_lr_scheduler_states=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Convert a deepspeed_tpu_torch checkpoint to universal "
                    "format")
    p.add_argument("checkpoint_dir")
    p.add_argument("out_dir")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_to_universal(args.checkpoint_dir, args.out_dir, args.tag)
    print(f"universal checkpoint written to {args.out_dir}")


if __name__ == "__main__":
    main()
