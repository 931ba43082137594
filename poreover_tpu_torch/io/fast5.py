"""FAST5 raw-signal parsing and scaling (host-side, numpy and h5py).

The port's copy of ``poreover_tpu/io/fast5.py`` (reference parse_fast5,
poreover/network/network.py:213-251): read the raw signal, clip the
abasic region (200 < s < 800), and scale with one of
standard/current/median/rescale; ``batch_input`` pads and cuts a signal
into the network's [nbatch, 128, window, 1] windows.
"""
from __future__ import annotations

import numpy as np


def parse_fast5(path: str, scaling: str = "standard"):
    import h5py

    with h5py.File(path, "r") as hdf:
        read_string = list(hdf["/Raw/Reads"].keys())[0]
        read_grp = hdf["/Raw/Reads/" + read_string]
        read_id = read_grp.attrs["read_id"]
        raw_signal = np.array(read_grp["Signal"])
        assert len(raw_signal) == read_grp.attrs["duration"]
        ch = hdf["UniqueGlobalKey"]["channel_id"]
        alpha = ch.attrs["digitisation"] / ch.attrs["range"]
        offset = ch.attrs["offset"]
    return read_id, scale_signal(raw_signal, scaling, alpha, offset)


def scale_signal(raw_signal: np.ndarray, scaling: str = "standard",
                 alpha: float = 1.0, offset: float = 0.0) -> np.ndarray:
    """``parse_fast5``'s clipping and scaling of a raw signal (``alpha``:
    digitisation / range, ``offset``: the channel's offset)."""
    # rough abasic-region heuristic (reference network.py:234)
    raw_signal = raw_signal[np.logical_and(raw_signal > 200, raw_signal < 800)]

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
    elif scaling == "raw":
        signal = raw_signal
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    return signal


def batch_input(signal: np.ndarray, window_size: int, batch_size: int = 128):
    """Pad + reshape signal into [nbatch, batch, window, 1]
    (reference network.py:253-263)."""
    num_batches, last_index = divmod(len(signal), window_size * batch_size)
    if last_index > 0:
        num_batches += 1
    padded = np.zeros(window_size * batch_size * num_batches)
    padded[: len(signal)] = signal
    return (
        padded.reshape((num_batches, batch_size, window_size, 1)),
        last_index,
    )
