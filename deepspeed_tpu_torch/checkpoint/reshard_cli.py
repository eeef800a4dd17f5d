"""``reshard``: convert a committed native checkpoint to universal form.

Ports ``deepspeed_tpu/checkpoint/reshard_cli.py``: the conversion path
(``convert_to_universal`` over the native per-leaf layout, through the
commit protocol). ``--dry-run``, which prices candidate worlds through
JAX's placement oracle (``elasticity/placement.py`` over
``autotuning/memory_model.py``), raises ``NotImplementedError`` until
those modules are ported.

Exit codes, as JAX's: ``0`` converted; ``1`` the checkpoint is corrupt
(``CheckpointCorruptError``); ``2`` unreadable or missing inputs, or a
usage error.

    python -m deepspeed_tpu_torch.checkpoint.reshard_cli <ckpt_dir> <out_dir> [--tag TAG]
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from deepspeed_tpu_torch.runtime.config_utils import later_slice


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="reshard",
        description="Convert a committed native deepspeed_tpu_torch "
                    "checkpoint to the universal (world-elastic) format.")
    p.add_argument("checkpoint_dir", help="native checkpoint root")
    p.add_argument("out_dir", nargs="?", default=None,
                   help="universal output dir (required unless --dry-run)")
    p.add_argument("--tag", default=None,
                   help="checkpoint tag (default: the committed 'latest')")
    p.add_argument("--dry-run", action="store_true",
                   help="price candidate meshes through the placement "
                        "oracle (a later slice)")
    p.add_argument("--candidate-worlds", type=int, nargs="+", default=[],
                   metavar="N", help="world sizes to survey (--dry-run)")
    args = p.parse_args(argv)
    if args.dry_run or args.candidate_worlds:
        raise later_slice(
            "reshard --dry-run / --candidate-worlds (the placement oracle: "
            "elasticity/placement.py and autotuning/memory_model.py)")
    if args.out_dir is None:
        p.error("out_dir is required")

    from deepspeed_tpu_torch.checkpoint.fault_tolerance import (
        CheckpointCorruptError,
    )
    from deepspeed_tpu_torch.checkpoint.universal import convert_to_universal

    try:
        out = convert_to_universal(args.checkpoint_dir, args.out_dir,
                                   tag=args.tag)
    except CheckpointCorruptError as e:
        print(f"corrupt checkpoint: {e}", file=sys.stderr)
        return 1
    except (FileNotFoundError, NotImplementedError) as e:
        print(f"not found: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"unreadable: {e}", file=sys.stderr)
        return 2
    print(f"universal checkpoint written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
