"""The banded Viterbi acceptor (``poreover_tpu_torch/ops/acceptor.py``) on
the CPU, its plain version against the JAX package's
``poreover_tpu.ops.acceptor``, in float32 (x64 off, as the CLI runs) and
in float64 (x64 on).

(a) With the JAX package's own G (``jnp.cumsum`` of the gap column, XLA's
    summation order) handed to the port: the pointer band equals
    ``_acceptor_scan``'s byte for byte, and the path ``viterbi_acceptor``'s
    at every step. Tolerance 0: both take the same float adds and maxima.
(b) With the port's own G (``gap_prefix``: float64 prefix sums rounded
    once, which differ from XLA's in the last bit at many steps): the
    number of path steps that differ from the JAX package's is counted; on
    every case here it is 0 (asserted, so that a change shows).

Cases: ``tests/test_acceptor.py:17``'s toy lattice (and its numpy replica
of the reference DP), band 1000 with T < 2 * band, a band narrower than
T / L, L = 0, L = 1, T = 1, the kernel's edges (windows at a warp slot's
32 cells and at a 128-cell row of pointer bits +- 1, W = 2001, the widest
window of 2048 cells, labels at the walk's 32-row batches +- 1), and the
1D beam's string of simulated reads of all three model kinds (``poreover_tpu_torch/sim.py``; flip-flop's last
column, the flop of T, is the gap as in the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.ops import acceptor as ja

from poreover_tpu_torch import sim
from poreover_tpu_torch.ops import acceptor as ta
from poreover_tpu_torch.ops.beam import beam_search_batch

torch.set_num_threads(1)


def log_softmax(rng, T, S):
    x = rng.normal(size=(T, S)) * 2
    return x - np.log(np.exp(x).sum(1, keepdims=True))


def random_case(seed, T, L, band, S=5):
    rng = np.random.default_rng(seed)
    label = "".join("ACGT"[i] for i in rng.integers(0, 4, L))
    return log_softmax(rng, T, S), label, band, "ACGT"


def toy_case():
    rng = np.random.default_rng(5)
    y = rng.random((8, 3))
    return np.log(y / y.sum(axis=1, keepdims=True)), "ABA", 100, "AB"


def sim_case(kind, seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, int(rng.integers(60, 110)))
    render = sim.synth_flipflop_read if kind == "flipflop" else \
        sim.synth_ctc_read
    y = render(rng, seq).astype(np.float64)
    model = {"poreover": "ctc", "bonito": "ctc_merge_repeats",
             "flipflop": "ctc_flipflop"}[kind]
    label = beam_search_batch([y], 25, model=model, device="cpu")[0]
    return y, label, 1000, "ACGT"


CASES = {
    "toy": toy_case,
    "band1000_T_lt_2band": lambda: random_case(1, 700, 90, 1000),
    "band_lt_T_over_L": lambda: random_case(2, 600, 20, 10),
    "narrow_band_many_rows": lambda: random_case(3, 400, 120, 5),
    "L0": lambda: random_case(4, 50, 0, 1000),
    "L1": lambda: random_case(5, 50, 1, 1000),
    "T1": lambda: random_case(6, 1, 1, 1000),
    "T_lt_L": lambda: random_case(7, 5, 9, 1000),
    # the kernel's edges: windows of W = T + 2 cells at a warp slot's 32
    # cells +- 1 and at 16-byte rows of pointer bits (128 cells) +- 1,
    # W = 2001, the widest window (band 1023: 2048 cells); labels at the
    # walk's 32-row batches +- 1
    "W31": lambda: random_case(9, 29, 6, 1000),
    "W32": lambda: random_case(10, 30, 7, 1000),
    "W33": lambda: random_case(11, 31, 8, 1000),
    "W127_L31": lambda: random_case(12, 125, 31, 1000),
    "W128_L32": lambda: random_case(13, 126, 32, 1000),
    "W129_L33": lambda: random_case(14, 127, 33, 1000),
    "W2001": lambda: random_case(15, 1999, 300, 1000),
    "W2048_widest": lambda: random_case(16, 2100, 360, 1023),
    **{f"sim_{k}{s}": (lambda k=k, s=s: sim_case(k, s))
       for k in ("poreover", "bonito", "flipflop") for s in (0, 1)},
}


def jax_reference(y, label, band, alphabet, x64):
    """JAX's path, its pointer band and its G, with x64 set as given."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        path = ja.viterbi_acceptor(y, label, band_size=band,
                                   alphabet=alphabet)
        dt = jnp.float64 if x64 else jnp.float32
        yj = jnp.asarray(y, dt)
        G = jnp.cumsum(yj[:, -1])
        ptr = None
        if label:
            li = ta.label_ints(label, alphabet)
            T, L = len(y), len(li)
            rs, re, slo, shi = ja._band_tables(T, L, band)
            ptr, _, _ = ja._acceptor_scan(
                yj, jnp.asarray(li), G, *map(jnp.asarray, (rs, re, slo, shi)),
                jnp.asarray(L, jnp.int32), ta.window(T, band))
            ptr = np.asarray(ptr)
        return path, ptr, np.asarray(G)
    finally:
        jax.config.update("jax_enable_x64", old)


def port(y, label, band, alphabet, dtype, G=None):
    packed = ta.pack_acceptor([y], [label], band, alphabet,
                              None if G is None else [G], dtype)
    dev = torch.device("cpu")
    ptr, path = ta.acceptor(*ta.upload(packed, dev), packed["meta"],
                            len(alphabet))
    return ptr.numpy(), path.numpy().astype(np.int64)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_path_and_pointers_equal_jax_with_its_g(name, x64):
    y, label, band, alphabet = CASES[name]()
    want, want_ptr, G = jax_reference(y, label, band, alphabet, x64)
    dtype = np.float64 if x64 else np.float32
    ptr, path = port(y, label, band, alphabet, dtype, G=G)
    assert path.shape == want.shape == (len(y),)
    assert np.array_equal(path, want)
    if want_ptr is not None:
        assert np.array_equal(ptr.reshape(want_ptr.shape), want_ptr)
    # the entry point gives the same path
    got = ta.viterbi_acceptor(y, label, band, alphabet, device="cpu", G=G,
                              dtype=dtype)
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_that_differ_with_the_ports_own_g(name, x64):
    y, label, band, alphabet = CASES[name]()
    want, _, G = jax_reference(y, label, band, alphabet, x64)
    dtype = np.float64 if x64 else np.float32
    own = ta.viterbi_acceptor(y, label, band, alphabet, device="cpu",
                              dtype=dtype)
    differing = int((own != want).sum())
    assert differing == 0, (
        f"{differing} of {len(y)} steps differ with the port's G "
        f"({int((ta.gap_prefix(y.astype(dtype)) != G).sum())} G entries "
        "differ)")


def test_toy_lattice_matches_the_reference_dp():
    """tests/test_acceptor.py:17's numpy replica of the reference DP."""
    y, label, band, alphabet = toy_case()
    li = [alphabet.index(c) for c in label]
    T, L = len(y), len(label)
    v = np.full((L + 1, T), -np.inf)
    ptr = np.zeros((L + 1, T), dtype=int)
    v[0] = np.cumsum(y[:, -1])
    v[1, 0] = y[0, li[0]]
    ptr[1, 0] = 1
    for l in range(1, L + 1):
        for t in range(1, T):
            if t >= l - 1:
                emit = y[t, li[l - 1]] + v[l - 1, t - 1]
                stay = y[t, -1] + v[l, t - 1]
                v[l, t], ptr[l, t] = (emit, 1) if emit >= stay else (stay, 0)
    expect = np.full(T, 2)
    l, t = L, T - 1
    while l > 0:
        if ptr[l, t] > 0:
            expect[t] = li[l - 1]
            l -= 1
        t -= 1
    path = ta.viterbi_acceptor(y, label, band, alphabet, device="cpu")
    assert np.array_equal(path, expect)


def test_batch_equals_one_by_one():
    """Reads of different lengths and labels in one call decode as alone."""
    cases = [CASES[n]() for n in ("band1000_T_lt_2band", "L0", "T1",
                                  "sim_bonito0")]
    ys = [c[0] for c in cases]
    labels = [c[1] for c in cases]
    batch = ta.viterbi_acceptor_batch(ys, labels, 1000, device="cpu")
    for (y, label, _, _), got in zip(cases, batch):
        assert np.array_equal(got, ta.viterbi_acceptor(y, label, 1000,
                                                       device="cpu"))


def test_every_label_character_is_emitted_once_in_order():
    y, label, band, alphabet = CASES["sim_poreover0"]()
    path = ta.viterbi_acceptor(y, label, band, alphabet, device="cpu")
    assert "".join(alphabet[c] for c in path if c < 4) == label


def test_cpu_route_counts_no_launch():
    before = ta.launch_count
    ta.viterbi_acceptor(*CASES["L1"]()[:2], device="cpu")
    assert ta.launch_count == before


def test_kernel_refuses_cpu_tensors_and_wide_bands():
    y, label, _, alphabet = CASES["band1000_T_lt_2band"]()
    packed = ta.pack_acceptor([y], [label], 1000, alphabet)
    args = ta.upload(packed, torch.device("cpu"))
    with pytest.raises(ValueError, match="expected cuda"):
        ta.acceptor_cuda(*args, packed["meta"], 4)
    # a window wider than the CTA's 2048 cells: the plain version takes it
    y2, label2, _, _ = random_case(8, 3000, 40, 1500)
    wide = ta.pack_acceptor([y2], [label2], 1500, alphabet)
    assert wide["meta"][0, 4] == 3002
    wide_args = ta.upload(wide, torch.device("cpu"))
    with pytest.raises(ValueError, match="windows of <= 2048"):
        ta.acceptor_cuda(*wide_args, wide["meta"], 4)
    _, path = ta.acceptor_plain(*wide_args, wide["meta"], 4)
    want, _, _ = jax_reference(y2, label2, 1500, alphabet, False)
    assert np.array_equal(path.numpy(), want)


def test_pointer_bits_unpack_to_the_byte_band():
    """The kernel's pointer bits (row l-1 of a read at meta[:, 7] + (l-1) *
    row_bytes(W), cell w at bit w % 8 of byte w // 8), written here from
    the plain version's byte band, unpack to that band exactly; windows at
    16-byte rows of bits (128 cells) +- 1, at a thread's 8 cells, the
    widest window, a narrow band and L = 0 in one call."""
    bands, bits, meta, b0 = [], [], [], 0
    for i, (T, L, band) in enumerate(((126, 20, 1000), (127, 33, 1000),
                                      (6, 2, 1000), (300, 41, 10),
                                      (50, 0, 1000), (2100, 40, 1023))):
        y, label, _, alphabet = random_case(30 + i, T, L, band)
        ptr, _ = port(y, label, band, alphabet, np.float32)
        W = ta.window(T, band)
        rb = ta.row_bytes(W)
        assert rb % 16 == 0 and 8 * (rb - 16) < W <= 8 * rb
        rows = np.zeros((L, 8 * rb), np.uint8)
        rows[:, :W] = ptr.reshape(L, W)
        bands.append(ptr)
        bits.append(np.packbits(rows, axis=1, bitorder="little").reshape(-1))
        meta.append([0, T, 0, L, W, 0, band, b0])
        b0 += L * rb
    got = ta.unpack_pointers(torch.from_numpy(np.concatenate(bits)),
                             np.array(meta))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.concatenate(bands))


def test_pack_gives_the_kernels_pointer_offsets():
    """meta[:, 7] is each read's first byte of pointer bits: the rows of
    the reads before it, row_bytes(W) bytes each."""
    cases = [random_case(40 + i, T, L, 1000)
             for i, (T, L) in enumerate(((126, 20), (700, 90), (5, 9)))]
    meta = ta.pack_acceptor([c[0] for c in cases], [c[1] for c in cases],
                            1000)["meta"]
    sizes = [len(c[1]) * ta.row_bytes(ta.window(len(c[0]), 1000))
             for c in cases]
    assert meta[:, 7].tolist() == [0, sizes[0], sizes[0] + sizes[1]]
