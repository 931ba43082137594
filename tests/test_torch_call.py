"""``python -m poreover_tpu_torch call --device cpu`` against the JAX
package's ``call``, on FAST5 files and a TF bundle that the test writes
(the reference's checkpoint and reads are not in the repository).

The FAST5 files (``sim.write_fast5``, h5py) have the layout
``parse_fast5`` reads; the weights are a tiny
conv1_bigru3 (8 units, 4 filters), initialised by the port's seeded
numpy initialiser and written under the Keras names by
``tools/tf_bundle.py``. Probabilities within atol 1e-6 (the two packages
order their float32 products differently; observed 6e-8); the ``.csv``
header and shape equal; both TF bundle readers return the writer's arrays.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.io import tf_checkpoint as jtf
from poreover_tpu.network.call import call as jax_call

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.io import tf_checkpoint as ttf
from poreover_tpu_torch.network.model import init_params
from poreover_tpu_torch.sim import synth_raw_signal, write_fast5
from tools.tf_bundle import keras_conv1_bigru3_tensors, write_bundle

torch.set_num_threads(1)

ATOL = 1e-6


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("call")
    rng = np.random.default_rng(21)
    reads = d / "reads"
    reads.mkdir()
    for i, n in enumerate((700, 12_950, 300)):
        write_fast5(reads / f"read{i}.fast5", synth_raw_signal(rng, n),
                    f"id-{i}")
    tree = init_params("conv1_bigru3", num_neurons=8, kernel_size=9,
                       filters=4, seed=5)
    tensors = keras_conv1_bigru3_tensors(tree)
    prefix = str(d / "ckpt" / "checkpoint-0")
    write_bundle(prefix, tensors)
    cfg = d / "model.json"
    cfg.write_text(json.dumps(dict(arch="conv1_bigru3", num_neurons=8,
                                   filters=4, kernel_size=9)))
    return d, reads, prefix, cfg, tensors


def jax_f32_call(**kw):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jax_call(types.SimpleNamespace(**kw))
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("fmt", ["npy", "csv"])
def test_call_matches_jax(tiny, tmp_path, fmt):
    d, reads, prefix, cfg, _ = tiny
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    torch_main(["call", str(reads), "--weights", prefix, "--model", str(cfg),
                "--window", "100", "--format", fmt, "--dir",
                str(tmp_path / "t"), "--device", "cpu"])
    jax_f32_call(**{"in": str(reads), "weights": prefix, "model": str(cfg),
                    "scaling": "standard", "use_id": False,
                    "dir": str(tmp_path / "j"), "window": 100,
                    "format": fmt})
    for i, n_kept in enumerate((700 - 5, 12_950 - 5, 300 - 5)):
        if fmt == "npy":
            t = np.load(tmp_path / "t" / f"read{i}.npy")
            j = np.load(tmp_path / "j" / f"read{i}.npy")
        else:
            tl = (tmp_path / "t" / f"read{i}.csv").read_text().splitlines()
            jl = (tmp_path / "j" / f"read{i}.csv").read_text().splitlines()
            assert tl[0] == jl[0] == "A,C,G,T,"
            t = np.loadtxt(tmp_path / "t" / f"read{i}.csv", delimiter=",",
                           skiprows=1)
            j = np.loadtxt(tmp_path / "j" / f"read{i}.csv", delimiter=",",
                           skiprows=1)
        assert t.shape == j.shape == (n_kept, 5)
        assert t.dtype == j.dtype
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
        np.testing.assert_allclose(t.sum(1), 1.0, atol=1e-5)


def test_use_id_names_files_by_read_id(tiny, tmp_path):
    d, reads, prefix, cfg, _ = tiny
    torch_main(["call", str(reads / "read2.fast5"), "--weights", prefix,
                "--model", str(cfg), "--window", "100", "--use_id", "--dir",
                str(tmp_path), "--device", "cpu"])
    assert np.load(tmp_path / "id-2.npy").shape == (295, 5)


@pytest.mark.parametrize("reader", [ttf, jtf], ids=["port", "jax"])
def test_bundle_readers_return_the_written_arrays(tiny, reader):
    _, _, prefix, _, tensors = tiny
    ckpt = reader.TFCheckpoint(prefix)
    assert ckpt.keys() == sorted(tensors)
    for k, v in tensors.items():
        got = ckpt.get(k)
        assert got.dtype == v.dtype and np.array_equal(got, v), k


def test_both_loaders_give_the_same_tree(tiny):
    _, _, prefix, _, _ = tiny
    a = ttf.load_keras_conv1_bigru3(prefix)
    b = jtf.load_keras_conv1_bigru3(prefix)
    la, lb = jax.tree.leaves_with_path(a), jax.tree.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_weights_that_are_not_a_bundle_name_a12(tiny, tmp_path):
    """A directory that holds no checkpoint the port reads (an orbax
    checkpoint of the JAX trainer, here an empty one) exits naming the
    converter, ``tools/orbax_to_torch.py`` (ROADMAP A12's tool)."""
    d, reads, _, cfg, _ = tiny
    with pytest.raises(SystemExit, match="orbax_to_torch"):
        torch_main(["call", str(reads), "--weights", str(tmp_path),
                    "--model", str(cfg), "--device", "cpu"])
