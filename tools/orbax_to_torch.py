"""Convert a JAX trainer checkpoint (orbax) into a checkpoint of the
PyTorch port's trainer.

Usage, from the repository's root::

    python tools/orbax_to_torch.py RUN_DIR/checkpoint-3 OUT [--model JSON]

``CHECKPOINT`` is an orbax checkpoint that ``poreover_tpu``'s ``train``
wrote (or a run directory, for its newest ``checkpoint-N``). The
architecture comes from ``--model`` (a ``model.json``) or else from the
``CHECKPOINT.json`` the JAX trainer writes beside each checkpoint. ``OUT``
is written in the port's format (``poreover_tpu_torch/network/
checkpoint.py``: the ``PoreOverNet`` state dict, with ``OUT.json``), which
``python -m poreover_tpu_torch call --weights OUT --model JSON`` loads.

The tool reads the checkpoint with the JAX package's ``load_params``, so it
needs jax and orbax; it is not part of the port's package, which imports
neither.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from poreover_tpu.network.call import (  # noqa: E402
    latest_checkpoint, load_params,
)

from poreover_tpu_torch.network.checkpoint import (  # noqa: E402
    save_state_dict,
)
from poreover_tpu_torch.network.model import (  # noqa: E402
    PoreOverNet, params_from_flax,
)


def convert(checkpoint: str, out: str, model_json: str | None = None) -> str:
    """Write ``checkpoint``'s weights to ``out`` in the port's format;
    returns the orbax path that was read."""
    if os.path.isdir(checkpoint) and latest_checkpoint(checkpoint):
        checkpoint = latest_checkpoint(checkpoint)
    cfg_path = model_json or checkpoint.rstrip("/") + ".json"
    with open(cfg_path) as f:
        cfg = json.load(f)
    tree = load_params(checkpoint)

    def to_numpy(t):
        return ({k: to_numpy(v) for k, v in t.items()} if isinstance(t, dict)
                else np.asarray(t, np.float32))

    sd = params_from_flax(to_numpy(tree), cfg["arch"])
    # the architecture's own state dict, key for key and shape for shape
    PoreOverNet(**cfg).load_state_dict(sd)
    save_state_dict(sd, out, cfg)
    return checkpoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="orbax checkpoint or run directory")
    p.add_argument("out", help="checkpoint file to write")
    p.add_argument("--model", default=None, help="model.json of the run")
    args = p.parse_args(argv)
    src = convert(args.checkpoint, args.out, args.model)
    print(f"wrote {args.out} from {src}", file=sys.stderr)


if __name__ == "__main__":
    main()
