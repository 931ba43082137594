"""Training-data preparation (host-side).

A copy of ``poreover_tpu/io/labeled_data.py`` (numpy; h5py imported only
by ``read_to_training``), so that the port stands alone.

Equivalents of the reference's standalone scripts:
- make_labeled_data (network/make_labeled_data.py:23-101): nanoraw
  genome_resquiggle FAST5 -> paired .signal/.bases text files, unrolled into
  fixed-width segments.
- to_npz (network/to_npz.py): .signal + .bases -> training.npz with
  {signal, labels, row_lengths}.
"""
from __future__ import annotations

import glob
import os

import numpy as np

ALPHABET = {"A": 0, "C": 1, "G": 2, "T": 3}

_NANORAW_PATH = "/Analyses/RawGenomeCorrected_000/BaseCalled_template/Events"


def read_to_training(
    read_path: str,
    unroll: int = 100,
    scaling: str = "standard",
    expand: bool = False,
) -> bool:
    """Write <read>.signal/<read>.bases next to a resquiggled FAST5.
    Returns False when the read lacks nanoraw annotations."""
    import h5py

    read_path_base = "".join(read_path.split(".")[:-1])
    with h5py.File(read_path, "r") as hdf:
        read_string = list(hdf["/Raw/Reads"].keys())[0]
        raw_signal = np.array(hdf["/Raw/Reads/" + read_string + "/Signal"])
        ch = hdf["UniqueGlobalKey"]["channel_id"]
        alpha = ch.attrs["digitisation"] / ch.attrs["range"]
        offset = ch.attrs["offset"]

        if _NANORAW_PATH not in hdf:
            return False
        events = np.array(hdf[_NANORAW_PATH])
        rel_start = hdf[_NANORAW_PATH].attrs["read_start_rel_to_raw"]

    base_chars = []
    for _mean, _stdev, start, length, base in events:
        b = base.decode() if isinstance(base, bytes) else str(base)
        if expand:
            base_chars.append(b * int(length))
        else:
            base_chars.append(b + "-" * (int(length) - 1))
    base_string = "".join(base_chars)
    end = int(rel_start) + int(start) + int(length)
    raw_signal = raw_signal[int(rel_start): end]

    if scaling == "standard":
        signal = (raw_signal - np.mean(raw_signal)) / np.std(raw_signal)
    elif scaling == "current":
        signal = (raw_signal + offset) / alpha
    elif scaling == "median":
        signal = raw_signal / np.median(raw_signal)
    elif scaling == "rescale":
        signal = (raw_signal - np.mean(raw_signal)) / (
            np.max(raw_signal) - np.min(raw_signal)
        )
    else:
        signal = raw_signal

    assert len(signal) == len(base_string)

    with open(read_path_base + ".signal", "w") as sf, open(
        read_path_base + ".bases", "w"
    ) as bf:
        i = 0
        while i + unroll < len(signal):
            base_out = " ".join(b for b in base_string[i : i + unroll] if b != "-")
            if base_out:
                sf.write(" ".join(map(str, signal[i : i + unroll])) + "\n")
                bf.write(base_out + "\n")
            i += unroll
    return True


def make_labeled_data(input_path: str, unroll=100, scaling="standard",
                      expand=False) -> int:
    files = (
        glob.glob(os.path.join(input_path, "*.fast5"))
        if os.path.isdir(input_path)
        else [input_path]
    )
    return sum(read_to_training(f, unroll, scaling, expand) for f in files)


def to_npz(input_prefix: str, out_path: str = "training.npz") -> None:
    """Package .signal/.bases into an npz (reference to_npz.py)."""
    signal = np.loadtxt(input_prefix + ".signal", dtype=np.float32, delimiter=" ")
    with open(input_prefix + ".bases") as f:
        bases_lines = [line.split() for line in f if line.strip()]
    bases_list = [np.array([ALPHABET[b] for b in line]) for line in bases_lines]
    row_lengths = np.array([len(b) for b in bases_list])
    np.savez(
        out_path.replace(".npz", ""),
        signal=signal,
        labels=np.concatenate(bases_list),
        row_lengths=row_lengths,
    )
