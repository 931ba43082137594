"""``python -m poreover_tpu_torch benchmark`` against the JAX package's
``benchmark`` on ``tests/test_benchmark.py``'s genome fixture and noisy
reads (the built-in seeded aligner; mappy is not installed here): the
``.benchmark.csv`` files are byte-identical, the ``--full`` pickles hold
the same statistics, and the stderr summaries are the same lines."""
import pickle
import shutil
import types

import numpy as np
import pytest

from poreover_tpu.benchmark import benchmark as jax_benchmark

from poreover_tpu_torch.benchmark import KmerIndex, align_to_reference
from poreover_tpu_torch.cli import main as torch_main


def _genome(rng):
    """``tests/test_benchmark.py``'s reference: 5000 random bases, 70 to a
    line."""
    seq = "".join(rng.choice(list("ACGT"), size=5000))
    return seq, ">chr1\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n"


def _mutate(rng, s, rate=0.05):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rng.choice(list("ACGT")))
        elif r < rate:
            out.append(c)
            out.append(rng.choice(list("ACGT")))
        else:
            out.append(c)
    return "".join(out)


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.fixture
def inputs(tmp_path):
    """The genome, and as a --fasta_pair prefix: noisy reads of both
    strands (.1d) and a read that maps nowhere among noisy reads (.2d)."""
    seq, text = _genome(np.random.default_rng(0))
    src = tmp_path / "src"
    src.mkdir()
    (src / "ref.fasta").write_text(text)
    rng = np.random.default_rng(1)
    reads = []
    for i in range(4):
        start = rng.integers(0, 3000)
        r = _mutate(rng, seq[start:start + 1200])
        reads.append((f"r{i}", r if i % 2 == 0 else _revcomp(r)))
    (src / "out.1d.fasta").write_text(
        "".join(f">{n}\n{s}\n" for n, s in reads))
    junk = "".join(rng.choice(list("ACGT"), size=800))
    (src / "out.2d.fasta").write_text(
        "".join(f">{n}\n{s}\n" for n, s in reads[:2])
        + f">junk\n{junk}\n>empty\n\n")
    return src


def _run(who, src, dest, capsys, **kw):
    shutil.copytree(src, dest)
    args = dict(fasta=None, fasta_pair=None, fastq=None,
                reference=str(dest / "ref.fasta"), full=False)
    args.update({k: str(dest / v) if isinstance(v, str) else v
                 for k, v in kw.items()})
    capsys.readouterr()
    if who == "jax":
        jax_benchmark(types.SimpleNamespace(**args))
    else:
        argv = ["benchmark", "--reference", args["reference"]]
        for k in ("fasta", "fasta_pair", "fastq"):
            if args[k]:
                argv += [f"--{k}", args[k]]
        if args["full"]:
            argv.append("--full")
        torch_main(argv)
    err = capsys.readouterr().err
    return [ln.replace(str(dest), "DIR") for ln in err.splitlines()
            if "mapped" in ln]


@pytest.mark.parametrize("full", [False, True])
def test_fasta_pair_csv_is_the_jax_packages(inputs, tmp_path, capsys, full):
    j = _run("jax", inputs, tmp_path / "j", capsys, fasta_pair="out",
             full=full)
    t = _run("port", inputs, tmp_path / "t", capsys, fasta_pair="out",
             full=full)
    assert j == t and len(t) == 2
    assert "4/4 mapped" in t[0] and "2/3 mapped" in t[1]
    for kind in ("1d", "2d"):
        name = f"out.{kind}.benchmark.csv"
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
        if full:
            pj, pt = (pickle.load(open(tmp_path / w / f"out.{kind}."
                                       "benchmark.pickle", "rb"))
                      for w in ("j", "t"))
            assert pj["homopolymers"] == pt["homopolymers"]
            for k, v in pj["error_positions"].items():
                np.testing.assert_array_equal(pt["error_positions"][k], v)


def test_single_fasta_csv_is_the_jax_packages(inputs, tmp_path, capsys):
    j = _run("jax", inputs, tmp_path / "j", capsys, fasta="out.1d.fasta")
    t = _run("port", inputs, tmp_path / "t", capsys, fasta="out.1d.fasta")
    assert j == t
    assert (tmp_path / "t" / "out.1d.benchmark.csv").read_bytes() == \
        (tmp_path / "j" / "out.1d.benchmark.csv").read_bytes()


def test_port_aligner_places_both_strands(inputs):
    seq = "".join(l for l in (inputs / "ref.fasta").read_text().splitlines()
                  if not l.startswith(">"))
    idx = KmerIndex(str(inputs / "ref.fasta"))
    for query, strand in ((seq[1000:2000], 1), (_revcomp(seq[2000:3000]),
                                               -1)):
        a_q, a_r, contig, got = align_to_reference(idx, query)
        assert (contig, got) == ("chr1", strand)
        assert a_q == a_r


def test_benchmark_without_a_file_exits(inputs):
    with pytest.raises(SystemExit, match="required"):
        torch_main(["benchmark", "--reference", str(inputs / "ref.fasta")])
