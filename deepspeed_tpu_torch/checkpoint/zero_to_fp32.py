"""Offline consolidation of a checkpoint into one fp32 state dict.

Ports ``deepspeed_tpu/checkpoint/zero_to_fp32.py`` over the native
per-leaf layout (``<tag>/state_fast``, either package's ``writer="fast"``):
the leaves are stored as global arrays, so consolidation reads the
``master/*`` leaves and exports them. Runs on the host, no card needed.

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <checkpoint_dir> <output.npz> [--tag TAG]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np


def get_fp32_state_dict_from_checkpoint(checkpoint_dir: str,
                                        tag: Optional[str] = None
                                        ) -> Dict[str, np.ndarray]:
    """→ flat {path: fp32 ndarray} of the master weights (reference
    ``get_fp32_state_dict_from_zero_checkpoint``)."""
    from deepspeed_tpu_torch.checkpoint.engine import (
        open_state,
        read_latest_tag,
    )

    tag = tag or read_latest_tag(checkpoint_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' tag file in {checkpoint_dir}")
    reader = open_state(os.path.join(checkpoint_dir, tag))
    return {name[len("master/"):]: reader[name].float().numpy()
            for name in reader.names if name.startswith("master/")}


def convert_checkpoint_to_fp32_state_dict(checkpoint_dir: str,
                                          output_path: str,
                                          tag: Optional[str] = None) -> None:
    flat = get_fp32_state_dict_from_checkpoint(checkpoint_dir, tag)
    np.savez(output_path, **flat)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint_dir")
    p.add_argument("output_path")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                          args.output_path, args.tag)
    print(f"consolidated fp32 state dict written to {args.output_path}")


if __name__ == "__main__":
    main()
