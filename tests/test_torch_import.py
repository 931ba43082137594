"""The PyTorch port stands alone: importing it loads neither jax nor any
module of poreover_tpu, and its entry points never fall back to the CPU
on their own."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "poreover_tpu_torch"

MODULES = [
    "poreover_tpu_torch",
    "poreover_tpu_torch.cli",
    "poreover_tpu_torch.native",
    "poreover_tpu_torch.sim",
    "poreover_tpu_torch.decoding.pair",
    "poreover_tpu_torch.decoding.decode",
    "poreover_tpu_torch.decoding.envelope",
    "poreover_tpu_torch.io.trace",
    "poreover_tpu_torch.models.transducer",
    "poreover_tpu_torch.ops.beam",
    "poreover_tpu_torch.ops.beam2d",
    "poreover_tpu_torch.ops.beam2d_planned",
    "poreover_tpu_torch.ops.pair_beam_batch",
    "poreover_tpu_torch.ops.box_beam",
    "poreover_tpu_torch.ops.beam1d",
    "poreover_tpu_torch.ops.viterbi",
    "poreover_tpu_torch.ops.prefix",
    "poreover_tpu_torch.ops.gamma",
    "poreover_tpu_torch.ops.pair_prefix",
    "poreover_tpu_torch.ops.acceptor",
    "poreover_tpu_torch.io.fast5",
    "poreover_tpu_torch.io.tf_checkpoint",
    "poreover_tpu_torch.network.model",
    "poreover_tpu_torch.network.call",
    "poreover_tpu_torch.decoding.fused",
    "poreover_tpu_torch.utils",
    "poreover_tpu_torch.ops.ctc",
    "poreover_tpu_torch.network.train",
    "poreover_tpu_torch.network.checkpoint",
    "poreover_tpu_torch.io.labeled_data",
    "poreover_tpu_torch.benchmark",
]


@pytest.mark.parametrize("mod", MODULES)
def test_import_leaves_jax_out(mod):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'poreover_tpu' or m.startswith('poreover_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|poreover_tpu)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tools" / "tf_bundle.py"]
    hits = [f"{f.relative_to(REPO)}" for f in files
            if pat.search(f.read_text())]
    assert not hits, hits


def test_cuda_request_without_card_raises(monkeypatch):
    from poreover_tpu_torch.ops.beam2d_planned import beam_search_2d_planned
    from poreover_tpu_torch.ops.pair_beam_batch import pair_beam_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.log(np.full((4, 5), 0.2, np.float32))
    env = np.tile(np.array([0, 4], np.int64), (4, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        beam_search_2d_planned(y, y, env)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_beam_batch([(y, y, env)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_beam_batch([(y, y, env)], device="cuda")
    # an explicit CPU request runs the plain version
    assert isinstance(pair_beam_batch([(y, y, env)], device="cpu")[0], str)


def test_new_entry_points_need_the_card_or_cpu(monkeypatch, tmp_path):
    """``call``, the network builder and the acceptor run on the card
    unless asked for the CPU; without a card they raise rather than fall
    back."""
    from poreover_tpu_torch.cli import main
    from poreover_tpu_torch.network.model import init_params, load_network
    from poreover_tpu_torch.ops.acceptor import viterbi_acceptor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.log(np.full((6, 5), 0.2, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viterbi_acceptor(y, "AC")
    assert viterbi_acceptor(y, "AC", device="cpu").shape == (6,)
    small = dict(num_neurons=4, kernel_size=3, filters=2)
    tree = init_params("conv1_bigru3", seed=0, **small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_network(tree, "conv1_bigru3", **small)
    net = load_network(tree, "conv1_bigru3", device="cpu", **small)
    assert next(net.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["call", str(tmp_path), "--weights", str(tmp_path)])


def test_train_needs_the_card_or_cpu(monkeypatch, tmp_path):
    """``train`` runs on the card unless asked for the CPU; without a card
    it raises rather than fall back."""
    from poreover_tpu_torch.cli import main

    rng = np.random.default_rng(0)
    data = tmp_path / "training.npz"
    np.savez(data, signal=rng.normal(size=(4, 20)).astype(np.float32),
             labels=rng.integers(0, 4, 8), row_lengths=np.full(4, 2))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train", "--data", str(data), "--batch_size", "2", "--holdout",
            "0", "--num_neurons", "4", "--filters", "2", "--kernel_size", "3"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not list(tmp_path.glob("conv1_bigru3_run_*"))
    main(argv + ["--device", "cpu"])
    (run,) = tmp_path.glob("conv1_bigru3_run_*")
    assert (run / "final").is_file()


def test_prefix_search_needs_the_card_or_cpu(monkeypatch):
    """The pair prefix search and the gamma band API take the card unless
    asked for the CPU; without a card they raise rather than fall back."""
    from poreover_tpu_torch.ops.gamma import pair_gamma_log
    from poreover_tpu_torch.ops.pair_prefix import pair_prefix_search_log

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.log(np.full((4, 5), 0.2, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_prefix_search_log(y, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_gamma_log(y, y)
    assert isinstance(pair_prefix_search_log(y, y, device="cpu")[0], str)
    assert pair_gamma_log(y, y, device="cpu").shape == (5, 5)
