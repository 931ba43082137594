"""The port's training checkpoints.

The JAX trainer's names (``checkpoint-N``, ``checkpoint-N.json`` with the
architecture, ``final``) with the port's own content: one file that
``torch.save`` writes and ``torch.load(path, weights_only=True)`` reads,
the ``PoreOverNet`` state dict as float32 CPU tensors. The JAX trainer's
orbax checkpoints convert to this format with ``tools/orbax_to_torch.py``.
"""
from __future__ import annotations

import json
import os
import zipfile

import torch


def save_state_dict(state_dict: dict, path: str,
                    arch_config: dict | None = None) -> None:
    """Write a state dict as a checkpoint at ``path`` (and the architecture
    as ``path + ".json"``); written under a temporary name and renamed
    into place."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    if arch_config is not None:
        with open(path + ".json", "w") as f:
            json.dump(arch_config, f)


def save_params(net, path: str, arch_config: dict | None = None) -> None:
    """Checkpoint ``net``'s weights at ``path``."""
    save_state_dict(net.state_dict(), path, arch_config)


def load_params(path: str) -> dict:
    """The state dict a checkpoint holds (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is a checkpoint of this format (a file that
    ``torch.save`` wrote: a zip archive)."""
    return os.path.isfile(path) and zipfile.is_zipfile(path)
