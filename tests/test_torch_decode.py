"""The port's ``decode`` subcommand on the CPU against the JAX package's.

Each case writes seeded simulated reads, runs
``poreover_tpu.cli.main(["decode", ...])`` (float32: jax_enable_x64 off,
restored afterwards) and ``poreover_tpu_torch.cli.main(["decode", ...,
"--device", "cpu"])`` on the same directory, and compares the FASTA files
byte for byte. Covered: poreover and bonito ``.npy`` traces and 8-column
flip-flop ``.csv`` traces; ``viterbi``, ``beam`` and ``prefix``; one read
and several; a corrupt read among good ones.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu import cli as jcli

from poreover_tpu_torch import cli as tcli
from poreover_tpu_torch import sim
from poreover_tpu_torch.decoding import decode as tdecode
from poreover_tpu_torch.io.trace import model_from_trace

torch.set_num_threads(1)

EXT = {"poreover": ".npy", "bonito": ".npy", "flipflop": ".csv"}
BASECALLER = {"poreover": "poreover", "bonito": "bonito",
              "flipflop": "flappie"}


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def both(tmp_path, inputs, kind, algorithm, extra=()):
    """Run both packages' ``decode``; returns (jax fasta, port fasta)."""
    argv = ["decode", *inputs, "--basecaller", BASECALLER[kind],
            "--algorithm", algorithm, *extra]
    with jax_f32():
        jcli.main(argv + ["--out", str(tmp_path / "jax")])
    tcli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    return ((tmp_path / "jax.fasta").read_text(),
            (tmp_path / "port.fasta").read_text())


def records(fasta):
    out, name = {}, None
    for line in fasta.splitlines():
        if line.startswith(">"):
            name = line[1:]
            out[name] = ""
        else:
            out[name] += line
    return out


@pytest.mark.parametrize("algorithm", ["viterbi", "beam"])
@pytest.mark.parametrize("kind", ["poreover", "bonito", "flipflop"])
def test_several_reads_byte_identical(tmp_path, kind, algorithm):
    d = tmp_path / "reads"
    d.mkdir()
    truth = sim.write_reads(str(d), 3, seed=5, lo=20, hi=45, kind=kind)
    inputs = ([str(d)] if kind != "flipflop" else
              [str(d / f"r{i}.csv") for i in range(3)])
    want, got = both(tmp_path, inputs, kind, algorithm,
                     ["--beam_width", "8", "--threads", "2"])
    assert got == want
    recs = records(got)
    assert list(recs) == ["r0", "r1", "r2"]
    # a decode of a simulated read is close to its true sequence
    for i, t in enumerate(truth):
        assert abs(len(recs[f"r{i}"]) - len(t)) <= max(4, len(t) // 4)


@pytest.mark.parametrize("algorithm", ["viterbi", "beam"])
@pytest.mark.parametrize("kind", ["poreover", "bonito", "flipflop"])
def test_one_read_byte_identical(tmp_path, kind, algorithm):
    d = tmp_path / "reads"
    d.mkdir()
    sim.write_reads(str(d), 1, seed=8, lo=25, hi=30, kind=kind)
    want, got = both(tmp_path, [str(d / ("r0" + EXT[kind]))], kind,
                     algorithm, ["--beam_width", "6"])
    assert got == want
    assert len(records(got)["r0"]) > 10


def test_corrupt_read_is_skipped_like_the_jax_package(tmp_path):
    """The batched-decode case of tests/test_batch_decode.py on both
    packages: mixed lengths in two buckets, one trace of the wrong rank."""
    d = tmp_path / "reads"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i, T in enumerate([30, 44, 600, 30]):
        np.save(d / f"r{i}.npy", rng.dirichlet(np.ones(5), size=T))
    np.save(d / "bad.npy", np.zeros((3, 3, 3)))
    want, got = both(tmp_path, [str(d)], "poreover", "beam",
                     ["--beam_width", "6", "--threads", "2"])
    assert got == want
    assert set(records(got)) == {"r0", "r1", "r2", "r3"}
    for name, seq in records(got).items():
        m = model_from_trace(str(d / f"{name}.npy"), "poreover")
        assert seq == tdecode.decode_read(m, "beam", beam_width=6,
                                          device="cpu")


def test_prefix_windows_byte_identical(tmp_path):
    d = tmp_path / "reads"
    d.mkdir()
    sim.write_reads(str(d), 2, seed=4, lo=30, hi=40, kind="poreover")
    want, got = both(tmp_path, [str(d)], "poreover", "prefix",
                     ["--window", "60"])
    assert got == want
    assert all(len(s) > 10 for s in records(got).values())


def test_collect_and_bucket_helpers(tmp_path):
    from poreover_tpu.decoding import decode as jdecode
    from poreover_tpu.ops.beam import _pad_bucket as jbucket

    from poreover_tpu_torch.ops.beam import _pad_bucket

    for name in ("b.npy", "a.npy", "c.csv", "d.hdf5"):
        (tmp_path / name).write_text("")
    for bc in ("poreover", "bonito", "flappie", "guppy"):
        assert tdecode.collect_input_files([str(tmp_path)], bc) == \
            jdecode.collect_input_files([str(tmp_path)], bc)
    assert tdecode.collect_input_files(["x", "y"], "poreover") == ["x", "y"]
    for T in (1, 511, 512, 513, 40000):
        assert _pad_bucket(T) == jbucket(T)


def test_wide_beam_and_cpu_take_the_engine():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tdecode._uses_kernel(cuda, 25)
    assert not tdecode._uses_kernel(cuda, 26)
    assert not tdecode._uses_kernel(cpu, 25)


def test_missing_card_ends_the_run(tmp_path, monkeypatch):
    d = tmp_path / "reads"
    d.mkdir()
    sim.write_reads(str(d), 2, seed=1, lo=10, hi=12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["decode", str(d), "--basecaller", "poreover",
                   "--algorithm", "beam", "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o.fasta").exists()


def test_a_failing_wave_is_not_passed_over(tmp_path, monkeypatch):
    """No per-read fallback: an error inside a wave's decode ends the run
    instead of being logged and skipped."""
    from poreover_tpu_torch.ops import beam as tbeam

    d = tmp_path / "reads"
    d.mkdir()
    sim.write_reads(str(d), 2, seed=1, lo=10, hi=12)

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tbeam, "beam_search_batch", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        tcli.main(["decode", str(d), "--basecaller", "poreover",
                   "--algorithm", "beam", "--device", "cpu", "--out",
                   str(tmp_path / "o")])


def test_kernel_route_decodes_a_kind_in_one_wave(tmp_path, monkeypatch):
    """The kernel pads nothing, so its route does not split a kind by
    length bucket: reads of three buckets go out as one wave (through the
    wrapper, which on CPU tensors runs the plain version), and the FASTA
    equals the engine route's."""
    from poreover_tpu_torch.ops import beam1d

    d = tmp_path / "reads"
    d.mkdir()
    rng = np.random.default_rng(3)
    for i, T in enumerate([30, 700, 44, 1100]):
        np.save(d / f"r{i}.npy", rng.dirichlet(np.ones(5), size=T))
    argv = ["decode", str(d), "--basecaller", "poreover", "--algorithm",
            "beam", "--beam_width", "5", "--device", "cpu", "--out"]
    tcli.main(argv + [str(tmp_path / "engine")])
    waves = []
    launch = beam1d.launch_beam1d
    monkeypatch.setattr(beam1d, "launch_beam1d",
                        lambda prep: waves.append(prep["meta"][:, 1].tolist())
                        or launch(prep))
    monkeypatch.setattr(tdecode, "_uses_kernel", lambda dev, w: True)
    tcli.main(argv + [str(tmp_path / "kernel")])
    assert waves == [[30, 44, 700, 1100]]
    assert (tmp_path / "kernel.fasta").read_text() == \
        (tmp_path / "engine.fasta").read_text()
