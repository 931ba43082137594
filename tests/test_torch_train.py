"""The port's trainer (``poreover_tpu_torch/network/train.py``) against the
JAX package's, on the CPU at small widths (8 units, 4 filters, kernel 3,
T 40), on ``tests/test_network.py``'s square-wave data.

- Three ``train_step``s from flax ``init_params`` weights carried across by
  ``params_from_flax``, on the same batches, against the JAX update
  composed here (``ctc_loss`` + ``model.apply`` + ``optax.adam``, as
  ``poreover_tpu/network/train.py:update`` composes it), for conv1_bigru3
  and conv1_gru5, both CTC variants. Tolerances: the losses within 1e-5
  relative (observed <= 4.9e-7); the parameters after three steps within
  1e-6 absolute (float32 products and recurrences summed in other orders,
  and torch's and optax's Adam in other float orders; observed <= 1.2e-7
  at learning rate 1e-3).
- The shuffle and holdout split: the batches the two trainers train and
  validate on are equal.
- ``train`` through the CLI with ``--device cpu`` writes the same set of
  files and the same stderr lines as the JAX trainer, and its loss falls.
- ``call --weights <run dir>`` loads the run's newest checkpoint.
- ``tools/orbax_to_torch.py``: a JAX trainer's orbax checkpoint, converted,
  gives the JAX ``call``'s probabilities through the port's ``call
  --device cpu`` within 1e-5 (``chip_smoke.py`` phase 13's tolerance).
"""
import datetime
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poreover_tpu.network import model as jm
from poreover_tpu.network import train as jtrain
from poreover_tpu.network.call import call as jax_call
from poreover_tpu.ops.ctc import ctc_loss as jax_ctc_loss

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.network import train as ttrain
from poreover_tpu_torch.network.checkpoint import load_params
from poreover_tpu_torch.network.model import PoreOverNet, params_from_flax
from poreover_tpu_torch.sim import synth_raw_signal, write_fast5
from tools.orbax_to_torch import convert

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
PROB_ATOL = 1e-5
LR = 1e-3
SMALL = dict(num_neurons=8, filters=4, kernel_size=3)


def square_wave(seed=0, N=64, T=40):
    """``tests/test_network.py``'s data: 4 bases per window, each a level
    held for T / 4 samples, plus noise."""
    rng = np.random.default_rng(seed)
    levels = np.array([-1.5, -0.5, 0.5, 1.5])
    labels = rng.integers(0, 4, size=(N, 4))
    signal = np.repeat(levels[labels], T // 4, axis=1)
    signal += rng.normal(size=signal.shape) * 0.1
    return dict(signal=signal.astype(np.float32), labels=labels.reshape(-1),
                row_lengths=np.full(N, 4, np.int64))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = tmp_path_factory.mktemp("train") / "training.npz"
    np.savez(path, **square_wave())
    return str(path)


def jax_f32(fn):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("arch", ["conv1_bigru3", "conv1_gru5"])
@pytest.mark.parametrize("merge", [False, True])
def test_three_steps_match_jax(data, arch, merge):
    signal, labels, lengths = ttrain.load_training_npz(data)
    batches = [(signal[i:i + 16], labels[i:i + 16], lengths[i:i + 16])
               for i in (0, 16, 32)]

    def run_jax():
        model = jm.build_model(arch, **SMALL)
        params = jm.init_params(model, jax.random.PRNGKey(4), window=40)
        params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), params)
        opt = optax.adam(LR)
        state = opt.init(params)

        @jax.jit
        def update(params, state, X, y, n):
            def loss_fn(p):
                return jnp.mean(jax_ctc_loss(model.apply({"params": p}, X),
                                             y, n, merge_repeated=merge))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            upd, state = opt.update(grads, state)
            return optax.apply_updates(params, upd), state, loss

        init = jax.tree.map(np.asarray, params)
        losses = []
        for X, y, n in batches:
            params, state, loss = update(params, state, jnp.asarray(X),
                                         jnp.asarray(y), jnp.asarray(n))
            losses.append(float(loss))
        return init, losses, jax.tree.map(np.asarray, params)

    init, want_losses, want_params = jax_f32(run_jax)
    net = PoreOverNet(arch, **SMALL)
    net.load_state_dict(params_from_flax(init, arch))
    opt = ttrain.make_optimizer(net, LR)
    losses = [float(ttrain.train_step(
        net, opt, *ttrain.to_device(X, y, n, torch.device("cpu")), merge))
        for X, y, n in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    want = params_from_flax(want_params, arch)
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    # the steps moved the weights by about the learning rate
    moved = max(float((got[k] - v).abs().max()) for k, v in
                params_from_flax(init, arch).items())
    assert 2 * LR < moved < 4 * LR


def _args(data, **kw):
    base = dict(data=data, name="t", epochs=2, save_every=5, holdout=0.25,
                loss_every=3, ctc_merge_repeated=False, model="conv1_bigru3",
                restart=False, batch_size=8, learning_rate=0.01, seed=1,
                **SMALL)
    base.update(kw)
    return types.SimpleNamespace(**base)


class _Recorder:
    """``jnp`` for the JAX trainer, recording what ``asarray`` is given."""

    def __init__(self, seen):
        self._seen = seen

    def asarray(self, x, *a, **k):
        self._seen.append(np.array(x))
        return jnp.asarray(x, *a, **k)

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_batches_are_the_jax_trainers(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen, jax_test = [], []
    monkeypatch.setattr(jtrain, "jnp", _Recorder(seen))
    monkeypatch.setattr(jtrain, "save_params", lambda *a, **k: None)
    monkeypatch.setattr(jtrain, "validation_error",
                        lambda f, p, b: jax_test.append(b) or 0.0)
    jax_f32(lambda: jtrain.train(_args(data, name="j", epochs=2)))
    jax_train = [tuple(seen[i:i + 3]) for i in range(0, len(seen), 3)]

    port_train, port_test = [], []

    def record_step(net, opt, X, y, n, merge=False):
        port_train.append((X.numpy(), y.numpy(), n.numpy()))
        return torch.zeros(())

    monkeypatch.setattr(ttrain, "train_step", record_step)
    monkeypatch.setattr(ttrain, "validation_error",
                        lambda f, p, b: port_test.append(b) or 0.0)
    ttrain.train(_args(data, name="p", epochs=2, device="cpu"))
    assert len(port_train) == len(jax_train) == 12
    for a, b in zip(port_train, jax_train):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert len(port_test) == len(jax_test) == 3
    for a, b in zip(port_test, jax_test):
        for u, v in zip(a, b):
            assert all(np.array_equal(p, q) for p, q in zip(u, v))


def _lines(err, prefix):
    return [ln.split("\t")[1].split(":")[0] + "@" + ln.split("\t")[0]
            for ln in err.splitlines() if ln.startswith(prefix)]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX trainer and the port's CLI ``train --device cpu`` on the
    square-wave data, each in its own directory; their stderr."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("runs")
    cwd = os.getcwd()
    out = {}
    # both trainers name their run directory by the minute they start: one
    # clock for both, so that a minute turning between the two runs cannot
    # name their directories apart
    start = datetime.datetime.now()
    clock = types.SimpleNamespace(
        datetime=types.SimpleNamespace(now=lambda: start))
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "datetime", clock)
    mp.setattr(ttrain, "datetime", clock)
    try:
        for who in ("jax", "port"):
            os.makedirs(d / who)
            os.chdir(d / who)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                if who == "jax":
                    jax_f32(lambda: jtrain.train(_args(data, save_every=11)))
                else:
                    torch_main(["train", "--data", data, "--name", "t",
                                "--epochs", "2", "--save_every", "11",
                                "--holdout", "0.25", "--loss_every", "3",
                                "--batch_size", "8", "--learning_rate",
                                "0.01", "--seed", "1", "--num_neurons", "8",
                                "--filters", "4", "--kernel_size", "3",
                                "--device", "cpu"])
            (run,) = os.listdir(d / who)
            out[who] = (str(d / who / run), err.getvalue())
    finally:
        os.chdir(cwd)
        mp.undo()
    return out


def test_cli_train_writes_the_jax_trainers_files(runs):
    (jrun, jerr), (prun, perr) = runs["jax"], runs["port"]
    assert sorted(os.listdir(prun)) == sorted(os.listdir(jrun)) == sorted(
        ["checkpoint-0", "checkpoint-0.json", "checkpoint-1",
         "checkpoint-1.json", "final", "final.json", "metrics.jsonl",
         "model.json", "train.log"])
    assert os.path.basename(prun) == os.path.basename(jrun)
    for f in ("model.json", "checkpoint-0.json", "final.json"):
        assert json.load(open(os.path.join(prun, f))) == json.load(
            open(os.path.join(jrun, f)))
    assert _lines(perr, "Iteration:") == _lines(jerr, "Iteration:")
    jm_, pm = ([json.loads(x) for x in open(os.path.join(r, "metrics.jsonl"))]
               for r in (jrun, prun))
    assert [sorted(m) for m in pm] == [sorted(m) for m in jm_]
    assert [m["step"] for m in pm] == [m["step"] for m in jm_]
    losses = [m["loss"] for m in pm if "loss" in m]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "Command-line arguments:" in open(os.path.join(
        prun, "train.log")).read()


def _fast5s(d):
    rng = np.random.default_rng(21)
    reads = d / "reads"
    reads.mkdir()
    for i, n in enumerate((700, 1_950)):
        write_fast5(reads / f"read{i}.fast5", synth_raw_signal(rng, n),
                    f"id-{i}")
    return reads


def test_call_from_the_run_directory(runs, tmp_path):
    prun, _ = runs["port"]
    reads = _fast5s(tmp_path)
    torch_main(["call", str(reads), "--weights", prun, "--model",
                os.path.join(prun, "model.json"), "--window", "100",
                "--dir", str(tmp_path), "--device", "cpu"])
    # the newest checkpoint (t = 11, the last step) holds the final weights
    sd = load_params(os.path.join(prun, "checkpoint-1"))
    final = load_params(os.path.join(prun, "final"))
    assert all(torch.equal(sd[k], final[k]) for k in final)
    net = PoreOverNet(**json.load(open(os.path.join(prun, "model.json"))))
    net.load_state_dict(final)
    from poreover_tpu_torch.io.fast5 import batch_input, parse_fast5
    from poreover_tpu_torch.network.call import make_forward

    fwd = make_forward(net.eval(), torch.device("cpu"))
    for i in range(2):
        _, sig = parse_fast5(str(reads / f"read{i}.fast5"))
        batches, last = batch_input(sig, window_size=100)
        outs = [np.concatenate(fwd(b)) for b in batches]
        if last > 0:
            outs[-1] = outs[-1][:last]
        got = np.load(tmp_path / f"read{i}.npy")
        assert got.shape == (len(sig), 5)
        np.testing.assert_array_equal(got, np.concatenate(outs))


def test_restart_from_a_run_directory(runs, data, tmp_path, monkeypatch):
    """``--restart <run dir>`` starts from the run's newest checkpoint."""
    prun, _ = runs["port"]
    monkeypatch.chdir(tmp_path)
    started = []
    real_step = ttrain.train_step

    def first(net, *a, **k):
        if not started:
            started.append({k_: v.clone() for k_, v in
                            net.state_dict().items()})
        return real_step(net, *a, **k)

    monkeypatch.setattr(ttrain, "train_step", first)
    ttrain.train(_args(data, name="r", epochs=1, restart=prun,
                       device="cpu"))
    newest = load_params(os.path.join(prun, "checkpoint-1"))
    assert all(torch.equal(started[0][k], newest[k]) for k in newest)


def test_orbax_checkpoint_converts(runs, tmp_path):
    """A JAX trainer's orbax checkpoint, converted by
    ``tools/orbax_to_torch.py``, gives the JAX ``call``'s probabilities
    through the port's ``call --device cpu``."""
    jrun, _ = runs["jax"]
    out = str(tmp_path / "converted")
    src = convert(jrun, out)
    assert src.endswith("checkpoint-1")
    reads = _fast5s(tmp_path)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    cfg = os.path.join(jrun, "model.json")
    torch_main(["call", str(reads), "--weights", out, "--model", cfg,
                "--window", "100", "--dir", str(tmp_path / "t"),
                "--device", "cpu"])
    jax_f32(lambda: jax_call(types.SimpleNamespace(**{
        "in": str(reads), "weights": src, "model": cfg,
        "scaling": "standard", "use_id": False, "dir": str(tmp_path / "j"),
        "window": 100, "format": "npy"})))
    for i in range(2):
        t = np.load(tmp_path / "t" / f"read{i}.npy")
        j = np.load(tmp_path / "j" / f"read{i}.npy")
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=PROB_ATOL)
    # the port's call names the tool when handed the orbax checkpoint
    with pytest.raises(SystemExit, match="orbax_to_torch"):
        torch_main(["call", str(reads), "--weights", src, "--model", cfg,
                    "--device", "cpu"])
