"""The by-row 2D pair beam search (``beam_search_2d(method="row")``) of
the port against the JAX package's ``_beam2d_row_scan``, on the CPU.

Module level, per model kind: ``_sweep_node_states``,
``_layered_axis_sweep`` and one ``_beam2d_row_iteration`` on the same
candidate tables (JAX's own, after some of its rows): finite values
within 1e-5 (the two frameworks' log-add-exps differ in the last bits),
-inf positions, keys, characters and beam_src equal. Whole searches:
strings byte-identical to the JAX package's on seeded pairs with and
without an envelope, at beam widths 5 and 25, in waves whose storage
takes the kernel's shared memory and its global scratch; and the edge
cases (one row, empty rows, an empty read 2) as the JAX engine takes
them, raising included. The JAX side runs with x64 off (float32).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.ops import beam2d as jb
from poreover_tpu.ops.beam import _init_candidates as jax_init

from poreover_tpu_torch.ops import beam2d as tb
from poreover_tpu_torch.ops import pair_row_beam as prb
from poreover_tpu_torch.sim import template_pairs as row_pairs

torch.set_num_threads(1)

MODELS = ("ctc", "ctc_merge_repeats", "ctc_flipflop")
MID = {"ctc": 0, "ctc_merge_repeats": 1, "ctc_flipflop": 2}
ATOL = 1e-5


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def jax_tables(y1, y2, env, model, W, rows):
    """JAX's own row iteration from its initial table over the rows up to
    max(rows); for each of ``rows`` the table before it, the row's (u,
    rs, re), JAX's table after it and its beam_src (numpy), and the
    engine's window width and padded constants."""
    mid, A = MID[model], 4
    Wb = int(np.max(env[:, 1] - env[:, 0]))
    pad, C, dt = max(Wb + 2, 2), W * (A + 1), jnp.float32
    y1j, y2j = jnp.asarray(y1), jnp.asarray(y2)
    S = y2.shape[1]
    ninf = lambda *s: jnp.full(s, -jnp.inf, dt)  # noqa: E731
    y2_pad = jnp.concatenate([ninf(pad, S), y2j, ninf(pad, S)])
    cum1_pad = jnp.concatenate([jnp.zeros((pad,), dt),
                                jnp.cumsum(y1j[:, -1]), ninf(pad)])
    cum2_pad = jnp.concatenate([jnp.zeros((pad,), dt),
                                jnp.cumsum(y2j[:, -1]), ninf(pad)])
    consts = (y1j, y2_pad, cum1_pad, cum2_pad, pad)
    i0 = jax_init(mid, y1j[0], W, A, dt)
    i1 = jax_init(mid, y2j[0], W, A, dt)
    cand = dict(
        k1=i0["k1"], k2=i0["k2"], pk1=i0["pk1"], pk2=i0["pk2"],
        char=i0["char"], pchar=i0["pchar"], valid=i0["valid"],
        state0=ninf(C, 2), sweep1=ninf(C, 2, Wb).at[:, :, 0].set(
            i1["state"]), off=jnp.asarray(0, jnp.int32),
        score=jnp.where(i0["valid"], 0.0, -jnp.inf).astype(dt),
        psweep1=ninf(C, 2, Wb), poff=jnp.zeros((C,), jnp.int32))
    step = jax.jit(lambda c, inp: jb._beam2d_row_iteration(
        mid, W, A, Wb, c, inp, consts))
    out = []
    for r in range(max(rows) + 1):
        inp = tuple(jnp.asarray(x, jnp.int32)
                    for x in (r, env[r, 0], env[r, 1]))
        new, src = step(cand, inp)
        if r in rows:
            out.append((jax.tree_util.tree_map(np.asarray, cand),
                        (r, int(env[r, 0]), int(env[r, 1])),
                        jax.tree_util.tree_map(np.asarray, new),
                        np.asarray(src)))
        cand = new
    return out, Wb


def port_consts(y1, y2, Wb):
    """The padded constants of ``row_scan`` for one pair (B = 1)."""
    pad = max(Wb + 2, 2)
    y2p = torch.full((1, 2 * pad + len(y2), y2.shape[1]), -np.inf)
    y2p[0, pad:pad + len(y2)] = torch.from_numpy(y2)
    cum2p = torch.full((1, 2 * pad + len(y2)), -np.inf)
    cum2p[0, :pad] = 0.0
    cum2p[0, pad:pad + len(y2)] = tb.ROW_SUMS(
        torch.from_numpy(y2[:, -1].copy()))
    cum1 = tb.ROW_SUMS(torch.from_numpy(y1[:, -1].copy()))[None]
    return cum1, y2p, cum2p, pad


def port_table(cand):
    """A JAX table as the port's, with a batch dimension of 1."""
    out = {k: torch.from_numpy(np.array(v))[None] for k, v in cand.items()}
    for k in ("k1", "k2", "pk1", "pk2", "char", "pchar", "off", "poff"):
        out[k] = out[k].to(torch.int64)
    out["off"] = out["off"].reshape(1)
    return out


def close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=what)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=what)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=ATOL,
                               err_msg=what)


def pair_of(model, seed, bases=45, half_width=14):
    return row_pairs(model, seed, 1, bases, bases + 1, half_width)[0]


@pytest.mark.parametrize("model", MODELS)
def test_row_iteration_matches_jax(model):
    y1, y2, env = pair_of(model, 21)
    with jax_f32():
        steps, Wb = jax_tables(y1, y2, env, model, 5, rows=(0, 1, 7, 60,
                                                            150))
    consts = port_consts(y1, y2, Wb)
    for cand, (u, rs, re), want, want_src in steps:
        got, src = tb._beam2d_row_iteration(
            MID[model], 5, 4, Wb, port_table(cand), torch.tensor([u]),
            torch.tensor([rs]), torch.tensor([re]),
            torch.from_numpy(y1[u])[None], consts)
        np.testing.assert_array_equal(src[0].numpy(), want_src)
        for k in ("k1", "k2", "pk1", "pk2", "char", "pchar", "valid",
                  "poff"):
            np.testing.assert_array_equal(got[k][0].numpy(), want[k],
                                          err_msg=k)
        assert int(got["off"][0]) == int(want["off"])
        for k in ("state0", "sweep1", "psweep1", "score"):
            close(got[k][0].numpy(), want[k], f"row {u} {k}")


@pytest.mark.parametrize("model", MODELS)
def test_layered_axis_sweep_matches_jax(model):
    """The sweep of a table JAX made, over the next row's window."""
    y1, y2, env = pair_of(model, 22)
    with jax_f32():
        steps, Wb = jax_tables(y1, y2, env, model, 5, rows=(40, 90))
        cum1, y2p, cum2p, pad = port_consts(y1, y2, Wb)
        for _, (u, _, _), c, _ in steps:
            rs, re = int(env[u + 1, 0]), int(env[u + 1, 1])
            S = y2.shape[1]
            y_pad = jnp.concatenate([jnp.full((pad, S), -jnp.inf), y2,
                                     jnp.full((pad, S), -jnp.inf)])
            cum_pad = jnp.asarray(cum2p[0].numpy())
            args = [c[k] for k in ("k1", "k2", "pk1", "pk2", "char",
                                   "pchar", "valid", "sweep1")]
            want = jb._layered_axis_sweep(
                MID[model], 4, Wb, jnp.int32(rs), jnp.int32(re), *args,
                c["off"], c["psweep1"], c["poff"], y_pad, cum_pad, pad)
            t = port_table(c)
            got = tb._layered_axis_sweep(
                MID[model], 4, Wb, torch.tensor([rs]), torch.tensor([re]),
                *[t[k] for k in ("k1", "k2", "pk1", "pk2", "char", "pchar",
                                 "valid", "sweep1")],
                t["off"], t["psweep1"], t["poff"], y2p, cum2p, pad)
            for name, g, w in zip(("sweep", "psweep", "poff", "max"), got,
                                  want):
                close(g[0].numpy(), np.asarray(w), f"row {u + 1} {name}")


@pytest.mark.parametrize("model", MODELS)
def test_sweep_node_states_matches_jax(model):
    """Random parent values (some -inf), seeds and windows, every chain of
    the kind (the flip-flop root's flop start included)."""
    rng = np.random.default_rng(MID[model])
    C, Wb, S = 25, 37, (8 if model == "ctc_flipflop" else 5)
    parent = np.log(rng.random((C, 2, Wb + 1))).astype(np.float32)
    parent[rng.random(parent.shape) < 0.2] = -np.inf
    seed = np.log(rng.random((C, 2))).astype(np.float32)
    seed[rng.random(seed.shape) < 0.2] = -np.inf
    y_w = np.log(rng.dirichlet(np.ones(S), Wb)).astype(np.float32)
    char = rng.integers(0, 4, C)
    in_range = (np.arange(Wb)[None] < 30) & (rng.random(C) < 0.9)[:, None]
    gap_w = np.where(np.arange(Wb) < 30, y_w[:, -1], 0).astype(np.float32)
    same = rng.random(C) < 0.3
    c_emit, c_emit2 = y_w.T[char], y_w.T[(char + 4) % S]
    root = (rng.random(C) < 0.3)[:, None] & (np.arange(Wb) == 0)[None]
    with jax_f32():
        want = jb._sweep_node_states(
            MID[model], jnp.asarray(parent), jnp.asarray(seed), y_w,
            jnp.asarray(c_emit), jnp.asarray(c_emit2), jnp.asarray(same),
            jnp.asarray(gap_w), jnp.asarray(in_range), jnp.asarray(root))
    t = lambda x: torch.from_numpy(np.asarray(x))[None]  # noqa: E731
    got = tb._sweep_node_states(
        MID[model], t(parent), t(seed), t(c_emit), t(c_emit2), t(same),
        t(gap_w[None]), t(in_range), t(root))
    close(got[0].numpy(), np.asarray(want), model)


def searches(model):
    """Seeded workloads of 60-400 rows in three waves: envelopes at W 5
    (storage in shared memory), whole lattices at W 5, and a wide
    envelope at W 25 (storage in global scratch)."""
    return [
        (5, row_pairs(model, 31, 3, 10, 50, half_width=12), "shared"),
        (5, row_pairs(model, 32, 2, 14, 20), "shared"),
        (25, row_pairs(model, 33, 2, 12, 15, half_width=40), "global"),
    ]


@pytest.mark.parametrize("model", MODELS)
def test_searches_byte_identical_to_jax(model):
    n = 0
    for W, wls, path in searches(model):
        prep = prb.prepare_rows(wls, beam_width=W, device="cpu",
                                model=model)
        assert prb.storage_path(prep) == path
        rows = prep["meta"][:, tb.RM_R]
        assert rows.min() >= 60 and rows.max() <= 400
        got = prb.fetch_prepared(prep, prb.launch_prepared(prep))
        with jax_f32():
            want = [jb.beam_search_2d(*w, beam_width=W, model=model)
                    for w in wls]
        assert got == want
        assert got == [tb.beam_search_2d(*w, beam_width=W, model=model,
                                         device="cpu") for w in wls[:1]] + \
            got[1:]
        n += len(wls)
    assert n >= 6


@pytest.mark.parametrize("case", ["one_row", "empty_rows", "empty_y2",
                                  "all_rows_empty", "no_rows"])
def test_edge_cases_as_the_jax_engine(case):
    rng = np.random.default_rng(9)
    lp = lambda T: np.log(rng.dirichlet(np.ones(5), T)).astype(  # noqa
        np.float32)
    y1, y2 = lp(12), lp(15)
    env = np.stack([np.arange(12), np.arange(12) + 4], 1)
    if case == "one_row":
        y1, env = y1[:1], np.array([[0, 15]])
    elif case == "empty_rows":
        env[3:6, 1] = env[3:6, 0]
    elif case == "empty_y2":
        y2, env = y2[:0], np.zeros((12, 2), np.int64)
    elif case == "all_rows_empty":
        env[:, 1] = env[:, 0]
    else:
        y1, env = y1[:1], None
    with jax_f32():
        try:
            want = jb.beam_search_2d(y1, y2, env, beam_width=5)
        except (IndexError, ValueError) as exc:
            want = exc
    if isinstance(want, Exception):
        with pytest.raises(type(want)):
            tb.beam_search_2d(y1, y2, env, beam_width=5, device="cpu")
        assert case in ("empty_y2", "all_rows_empty", "no_rows")
    else:
        assert tb.beam_search_2d(y1, y2, env, beam_width=5,
                                 device="cpu") == want
