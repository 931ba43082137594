"""The 1D kernel's step (csrc/beam1d.cu) modelled on the CPU and held to
the plain version's (ops/beam1d.py).

The kernel does not rank the whole table the way ``_select`` describes it,
nor join by a masked max over all slots as ``_join`` does. Each step it:

- keeps a valid slot when its key's bucket in an open-addressed hash table
  (linear probing, the key in the bucket) names it as the first slot with
  that key, whatever order the slots were inserted in; a slot whose key
  equals the empty marker is kept when no valid slot before it has its key;
- takes as threshold the lowest score code of the W stay slots (0 when a
  stay is invalid), lists the kept slots at or above it warp by warp (32
  slots per warp, zero-padded), as 32-bit words (the code above the
  threshold over the slot) or, on a "wide" step, as 64-bit words, and
  ranks each survivor by counting, segment by segment, the words that beat
  its own;
- joins a query key through the same hash table: the largest states kept
  in its bucket.

The table has 2^bits buckets, bits from 8 to 12 as the launch picks it.
``model_select`` and ``model_join`` below follow that schedule with numpy,
bucket function and all. ``plain_step`` and ``plain_join`` are one
iteration of ``beam1d_plain``'s loop and its masked-max join, copied here
so that the model's selection and join can be put in their place (a test
holds the copy, run step after step, to ``beam1d_plain`` itself, bit for
bit). The tests hold the model to ``_select`` and ``plain_join`` on random
tables that carry what makes the schedule hard: tied scores (equal codes,
-0 and +0), invalid slots, -inf states, scores too far apart for 32-bit
words, duplicate keys between a stay and a child and between two children
(with equal and with different states, as a hash collision would give),
and keys equal to the empty marker; and then one whole ``plain_step`` run
with the model's selection and join against the plain one, bit for bit,
for W in {1, 5, 8, 25} and all three model kinds. The kernel itself runs
only on a card (the ``cuda``-marked tests in tests/test_torch_kernel.py,
and ``chip_smoke.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from poreover_tpu_torch.ops import beam1d
from poreover_tpu_torch.ops.beam import (
    _M1, _M2, _MASK32, _NEG_INF, _dedup_mask, _mul32,
)

torch.set_num_threads(1)

A = 4
NT = 128            # csrc/beam1d.cu: NT (slots per CTA), 32 per warp
NB_BITS = (8, 12)   # csrc/beam1d.cu: NB_BITS_MIN, NB_BITS_MAX
EMPTY = (_MASK32, _MASK32)
NEG_INF = float("-inf")
SRC = Path(beam1d.__file__).resolve().parent.parent / "csrc" / "beam1d.cu"


def order_code(x: float) -> int:
    """csrc/beam1d.cu:order_code: -0 as +0, larger float larger code."""
    u = int(np.array([x + 0.0], np.float32).view(np.uint32)[0])
    return (~u & _MASK32) if u & 0x80000000 else (u | 0x80000000)


def max_code(x: float) -> int:
    """csrc/beam1d.cu:max_code: a state as an int of the same order, -0
    below +0 (the kernel's atomicMax)."""
    b = int(np.array([x], np.float32).view(np.int32)[0])
    return b if b >= 0 else b ^ 0x7FFFFFFF


def state_max(a: float, b: float) -> float:
    return a if max_code(a) >= max_code(b) else b


def bucket_of(k1: int, k2: int, bits: int) -> int:
    x = (k1 * 0x9E3779B1 + k2) & _MASK32
    return ((x * 0x85EBCA6B) & _MASK32) >> (32 - bits)


class HashTable:
    """The kernel's table of one candidate table, 2^bits buckets, built by
    inserting its valid slots in ``order`` (the kernel's threads race; any
    order gives the same table contents but the placement of colliding
    buckets)."""

    def __init__(self, tab: dict, row: int, order, bits: int):
        self.key, self.first, self.st = {}, {}, {}
        self.marker = False
        self.tab, self.row, self.bits = tab, row, bits
        for i in order:
            if not tab["val"][row, i]:
                continue
            k = (int(tab["k1"][row, i]), int(tab["k2"][row, i]))
            if k == EMPTY:
                self.marker = True
                continue
            b = bucket_of(*k, bits)
            while b in self.key and self.key[b] != k:   # linear probing
                b = (b + 1) % (1 << bits)
            self.key[b] = k
            self.first[b] = min(self.first.get(b, NT), i)
            if "st0" in tab:  # a selection's table has no states
                s0 = float(tab["st0"][row, i])
                s1 = float(tab["st1"][row, i])
                o0, o1 = self.st.get(b, (NEG_INF, NEG_INF))
                self.st[b] = (state_max(o0, s0), state_max(o1, s1))

    def bucket(self, k):
        b = bucket_of(*k, self.bits)
        while b in self.key:
            if self.key[b] == k:
                return b
            b = (b + 1) % (1 << self.bits)
        return None

    def kept(self, i: int) -> bool:
        t, r = self.tab, self.row
        if not t["val"][r, i]:
            return False
        k = (int(t["k1"][r, i]), int(t["k2"][r, i]))
        if k == EMPTY:  # the first valid slot with the marker's key
            return not any(t["val"][r, j] and (int(t["k1"][r, j]),
                                               int(t["k2"][r, j])) == EMPTY
                           for j in range(i))
        return self.first[self.bucket(k)] == i

    def lookup(self, k):
        if k == EMPTY:  # a scan of the table
            t, r = self.tab, self.row
            hits = [j for j in range(t["k1"].shape[1]) if t["val"][r, j]
                    and (int(t["k1"][r, j]), int(t["k2"][r, j])) == EMPTY]
            if not self.marker or not hits:
                return NEG_INF, NEG_INF
            return (max(float(t["st0"][r, j]) for j in hits),
                    max(float(t["st1"][r, j]) for j in hits))
        b = self.bucket(k)
        return (NEG_INF, NEG_INF) if b is None else self.st[b]


def model_select_row(tab: dict, row: int, W: int, order, bits: int) -> list:
    """Winners of one table as the kernel picks them."""
    h = HashTable(tab, row, order, bits)
    C = tab["k1"].shape[1]
    codes = [order_code(float(tab["sc"][row, i])) if tab["val"][row, i]
             else 0 for i in range(C)]
    tau = min(codes[:W])  # 0 when a stay is invalid
    surv = [i for i in range(C) if h.kept(i) and codes[i] >= tau]
    wide = any(codes[i] - tau >= 1 << 25 for i in surv)
    # the lists: each warp's survivors in lane order, zeros after them
    segs = []
    for g in range(NT // 32):
        mine = [i for i in surv if i // 32 == g]
        if wide:
            words = [(codes[i] << 32) | (NT - 1 - i) for i in mine]
        else:
            words = [((codes[i] - tau) << 7) | (NT - 1 - i) for i in mine]
        segs.append(words + [0] * (32 - len(words)))
    src = [-1] * W
    for i in surv:
        me = ((codes[i] << 32) | (NT - 1 - i) if wide
              else ((codes[i] - tau) << 7) | (NT - 1 - i))
        r = sum(sum(w > me for w in seg) for seg in segs)
        if r < W:
            assert src[r] == -1, "two survivors of one rank"
            src[r] = i
    return src


def make_select(rng, bits: int):
    def select(sc, k1, k2, val, W):
        tab = dict(sc=sc, k1=k1, k2=k2, val=val)
        C = k1.shape[1]
        rows = [model_select_row(tab, r, W, rng.permutation(C), bits)
                for r in range(k1.shape[0])]
        return torch.tensor(rows, dtype=torch.int64).reshape(-1, W)
    return select


def make_join(rng, bits: int):
    def join(tab, q1, q2):
        l0 = torch.empty(q1.shape, dtype=torch.float32)
        l1 = torch.empty(q1.shape, dtype=torch.float32)
        C = tab["k1"].shape[1]
        for r in range(q1.shape[0]):
            h = HashTable(tab, r, rng.permutation(C), bits)
            for q in range(q1.shape[1]):
                l0[r, q], l1[r, q] = h.lookup((int(q1[r, q]),
                                               int(q2[r, q])))
        return l0, l1
    return join


def child_key(k1: int, k2: int, c: int):
    c = int(c)
    return (((k1 * _M1) + c + 1) & _MASK32, ((k2 * _M2) + c + 1) & _MASK32)


def random_table(rng, W: int, model_id: int, B: int = 3) -> dict:
    """[B, C] tables shaped like the kernel's after a step: distinct stay
    keys; planted duplicates, ties, -0/+0, -inf and marker keys."""
    C = W * (A + 1)
    k1 = rng.integers(0, 1 << 32, (B, C), dtype=np.int64)
    k2 = rng.integers(0, 1 << 32, (B, C), dtype=np.int64)
    st0 = (-rng.random((B, C)) * 30).astype(np.float32)
    st1 = (-rng.random((B, C)) * 30).astype(np.float32)
    val = rng.random((B, C)) < 0.85
    # stays' keys distinct (they are the winners'), not the marker's
    k1[:, :W] = np.arange(W) + 17 + 1000 * np.arange(B)[:, None]
    for b in range(B):
        kind = b % 3
        if kind == 0:   # ties: a few score values shared by many slots
            vals = np.array([-1.5, -2.0, 0.0, -0.0], np.float32)
            st0[b] = vals[rng.integers(0, 4, C)]
            st1[b] = vals[rng.integers(0, 4, C)]
        elif kind == 1:  # wide: -inf states and far-apart scores
            st0[b, rng.random(C) < 0.2] = NEG_INF
            st1[b, rng.random(C) < 0.2] = NEG_INF
            st0[b, rng.random(C) < 0.2] *= 1e4
            if W > 1:
                val[b, :W] = True  # a threshold from the stays
        for _ in range(max(1, C // 10)):
            # a child with a stay's key (the usual duplicate), with the
            # stay's states or, as a collision would give, its own
            i, j = rng.integers(0, W), rng.integers(W, C)
            k1[b, j], k2[b, j] = k1[b, i], k2[b, i]
            if rng.random() < 0.5:
                st0[b, j], st1[b, j] = st0[b, i], st1[b, i]
        if C - W >= 2:  # two children with one key
            i, j = rng.choice(np.arange(W, C), 2, replace=False)
            k1[b, j], k2[b, j] = k1[b, i], k2[b, i]
        for _ in range(max(1, C // 20)):  # the marker's key
            j = rng.integers(W, C)
            k1[b, j], k2[b, j] = EMPTY
        for _ in range(max(1, C // 8)):
            # a slot holding the key some winner's child will look up
            i, c, j = rng.integers(0, C), rng.integers(0, A), rng.integers(
                W, C)
            k1[b, j], k2[b, j] = child_key(int(k1[b, i]), int(k2[b, i]), c)
    # parents: some the root (0), some another slot's key
    pk1 = np.where(rng.random((B, C)) < 0.3, 0, k1[:, rng.permutation(C)])
    pk2 = np.where(pk1 == 0, 0, k2[:, rng.permutation(C)])
    same = rng.random((B, C)) < 0.5
    pk2 = np.where(same & (pk1 != 0), k2[:, ::-1], pk2)
    chr_ = rng.integers(-1, A, (B, C))
    pch = rng.integers(-1, A, (B, C))
    st0 = np.where(val, st0, NEG_INF).astype(np.float32)
    st1 = np.where(val, st1, NEG_INF).astype(np.float32)
    # valid slots with one key and zero states of both signs: the masked
    # max takes either (test_join_of_signed_zeros_takes_plus_zero), so
    # each key's zeros keep the sign of its first
    for b in range(B):
        for st in (st0, st1):
            first_zero = {}
            for j in range(C):
                if val[b, j] and st[b, j] == 0:
                    st[b, j] = first_zero.setdefault(
                        (k1[b, j], k2[b, j]), st[b, j])
    if model_id == 0:
        st1[:] = NEG_INF
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        k1=k1, k2=k2, pk1=pk1, pk2=pk2, chr=chr_, pch=pch, st0=st0,
        st1=st1).items()}
    t["val"] = torch.from_numpy(val)
    t["sc"] = t["st0"] if model_id == 0 else torch.logaddexp(t["st0"],
                                                             t["st1"])
    return t


def emission_row(rng, B: int, model_id: int) -> torch.Tensor:
    S = 2 * A if model_id == 2 else A + 1
    x = rng.normal(size=(B, S)) * 2
    return torch.from_numpy(
        (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32))


def int_view(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


TABLE_FIELDS = ("k1", "k2", "pk1", "pk2", "chr", "pch", "st0", "st1",
                "sc", "val")


def plain_join(tab, q1, q2):
    """beam1d_plain's hash join: for each query key [B, Q] the largest st0
    and st1 over the valid slots of ``tab`` with that key (-inf when
    none)."""
    eq = (tab["val"][:, None, :] & (q1[:, :, None] == tab["k1"][:, None, :])
          & (q2[:, :, None] == tab["k2"][:, None, :]))
    l0 = torch.where(eq, tab["st0"][:, None, :], _NEG_INF).max(dim=2).values
    l1 = torch.where(eq, tab["st1"][:, None, :], _NEG_INF).max(dim=2).values
    return l0, l1


def plain_step(tab, y_t, r_t, W: int, A: int, model_id: int,
               select=beam1d._select, join=plain_join):
    """One iteration of beam1d_plain's loop on [B, C] tables (a dict of
    TABLE_FIELDS): the W winners of ``tab``, then the new table, each slot
    built from its winner with the state it joins with (a stay looks up
    its parent, a child its own state at t-1) and the per-kind update.
    ``y_t`` [B, S] is the step's emission row, ``r_t`` [B, 1] the root's
    value at t-1 (ctc). Returns (src [B, W], the new table)."""
    C = tab["k1"].shape[1]
    slot = torch.arange(C)
    stay = slot < W
    widx = torch.where(stay, slot, (slot - W) // A)
    cchar = torch.where(stay, -1, (slot - W) % A)[None, :]
    src = select(tab["sc"], tab["k1"], tab["k2"], tab["val"], W)

    ok = (src >= 0)[:, widx]
    s = src.clamp(min=0)[:, widx]

    def win(name, none):
        return torch.where(ok, tab[name].gather(1, s), none)

    wk1, wk2, wpk1, wpk2 = (win(k, 0) for k in ("k1", "k2", "pk1", "pk2"))
    wch, wpch = win("chr", -1), win("pch", -1)
    ws0, ws1 = win("st0", _NEG_INF), win("st1", _NEG_INF)

    nk1 = torch.where(stay, wk1, (_mul32(wk1, _M1) + cchar + 1) & _MASK32)
    nk2 = torch.where(stay, wk2, (_mul32(wk2, _M2) + cchar + 1) & _MASK32)
    npk1 = torch.where(stay, wpk1, wk1)
    npk2 = torch.where(stay, wpk2, wk2)
    nch = torch.where(stay, wch, cchar)
    npch = torch.where(stay, wpch, wch)

    l0, l1 = join(tab, torch.where(stay, wpk1, nk1),
                  torch.where(stay, wpk2, nk2))
    s0 = torch.where(stay, ws0, l0)
    s1 = torch.where(stay, ws1, l1)
    p0 = torch.where(stay, l0, ws0)
    p1 = torch.where(stay, l1, ws1)
    if model_id == 0:
        is_root = stay & (wpk1 == 0) & (wpk2 == 0)
        p0 = torch.where(is_root, r_t, p0)

    same = nch == npch
    ch = nch.clamp(min=0)
    y_c = y_t.gather(1, ch)
    if model_id == 0:
        n0 = torch.logaddexp(p0 + y_c, s0 + y_t[:, -1:])
        n1 = torch.full_like(n0, _NEG_INF)
    elif model_id == 1:
        n0 = torch.logaddexp(s0, s1) + y_t[:, -1:]
        frm = torch.where(same, p0, torch.logaddexp(p0, p1))
        n1 = torch.logaddexp(frm + y_c, s1 + y_c)
    else:
        y_cf = y_t.gather(1, ch + A)
        emit_flip = torch.where(same, p1, torch.logaddexp(p0, p1)) + y_c
        emit_flop = torch.where(same, p0 + y_cf, _NEG_INF)
        n0 = torch.logaddexp(emit_flip, s0 + y_c)
        n1 = torch.logaddexp(emit_flop, s1 + y_cf)
    n0 = torch.where(ok, n0, _NEG_INF)
    n1 = torch.where(ok, n1, _NEG_INF)
    nsc = n0 if model_id == 0 else torch.logaddexp(n0, n1)
    return src, dict(k1=nk1, k2=nk2, pk1=npk1, pk2=npk2, chr=nch, pch=npch,
                     st0=n0, st1=n1, sc=nsc, val=ok)


def initial_table(y0, W: int, A: int, model_id: int) -> dict:
    """beam1d_plain's table at t = 0: the A root children in slots W ..
    W+A-1, from the first emission rows y0 [B, S]."""
    B, C = y0.shape[0], W * (A + 1)
    slot = torch.arange(C)
    child0 = (slot >= W) & (slot < W + A)
    c0 = (slot - W).clamp(0, A - 1)
    e0 = torch.where(child0[None, :], y0[:, c0], _NEG_INF)
    ninf = torch.full((B, C), _NEG_INF)
    if model_id == 0:
        st0, st1 = e0, ninf
    elif model_id == 1:
        st0, st1 = ninf, e0
    else:
        st0 = e0
        st1 = torch.where(child0[None, :], y0[:, c0 + A], _NEG_INF)
    k1 = torch.where(child0, slot - W + 1, 0)[None, :].repeat(B, 1)
    chr_ = torch.where(child0, slot - W, -1)[None, :].repeat(B, 1)
    return dict(k1=k1, k2=k1.clone(), pk1=torch.zeros_like(k1),
                pk2=torch.zeros_like(k1), chr=chr_,
                pch=torch.full_like(chr_, -1), st0=st0, st1=st1,
                sc=st0 if model_id == 0 else torch.logaddexp(st0, st1),
                val=child0[None, :].repeat(B, 1))


WIDTHS = [1, 5, 8, 25]
KINDS = [0, 1, 2]


@pytest.mark.parametrize("model_id", KINDS)
@pytest.mark.parametrize("W", [1, 5, 25])
def test_plain_step_copy_runs_as_beam1d_plain(W, model_id):
    """``plain_step``, run step after step from ``initial_table`` over a
    batch of reads of different lengths, gives ``beam1d_plain``'s
    provenance and final table bit for bit: the copy is the loop's."""
    rng = np.random.default_rng(50 + 3 * W + model_id)
    S = 2 * A if model_id == 2 else A + 1
    model = {0: "ctc", 1: "ctc_merge_repeats", 2: "ctc_flipflop"}[model_id]
    ys = [emission_row(rng, T, model_id).numpy() for T in (40, 17, 1, 33)]
    prep = beam1d.prepare_beam1d(ys, beam_width=W, model=model,
                                 device="cpu")
    y, root, meta = prep["dev"]
    want = beam1d.beam1d_plain(y, root, meta, prep["meta"], W, A, model_id)
    lens = torch.as_tensor(prep["meta"][:, 1])
    offs = prep["meta"][:, 0]
    T = int(lens.max())
    rows = torch.as_tensor(offs[:, None] + np.arange(T)[None, :]).clamp(
        max=y.shape[0] - 1)
    yb, rb = y[rows], (root[rows] if model_id == 0 else None)
    assert yb.shape[2] == S
    tab = initial_table(yb[:, 0], W, A, model_id)
    prov = torch.zeros(len(ys), T, W, dtype=torch.uint8)
    for t in range(1, T):
        adv = (t < lens)[:, None]
        src, new = plain_step(tab, yb[:, t],
                              rb[:, t:t + 1] if model_id == 0 else None,
                              W, A, model_id)
        prov[:, t] = torch.where(adv, src + 1, 0).to(torch.uint8)
        tab = {k: torch.where(adv, new[k], tab[k]) for k in TABLE_FIELDS}
    got_prov = torch.cat([prov[b, :int(n)] for b, n in enumerate(lens)])
    np.testing.assert_array_equal(got_prov.numpy(), want[0].numpy())
    np.testing.assert_array_equal(int_view(tab["st0"]), int_view(want[2]))
    np.testing.assert_array_equal(int_view(tab["st1"]), int_view(want[3]))
    np.testing.assert_array_equal(tab["val"].numpy(), want[4].numpy())


@pytest.mark.parametrize("nb_bits", NB_BITS)
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("model_id", KINDS)
def test_model_select_is_select(W, model_id, nb_bits):
    rng = np.random.default_rng(100 * W + model_id + nb_bits)
    for _ in range(4):
        tab = random_table(rng, W, model_id)
        want = beam1d._select(tab["sc"], tab["k1"], tab["k2"], tab["val"], W)
        got = make_select(rng, nb_bits)(tab["sc"], tab["k1"], tab["k2"],
                                        tab["val"], W)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("nb_bits", NB_BITS)
@pytest.mark.parametrize("W", WIDTHS)
def test_model_join_is_masked_max(W, nb_bits):
    rng = np.random.default_rng(7 + W + nb_bits)
    for model_id in KINDS:
        tab = random_table(rng, W, model_id)
        C = W * (A + 1)
        # queries: the table's own keys, parent keys, the marker's, misses
        pick = rng.integers(0, C, (3, C))
        q1 = torch.where(torch.from_numpy(rng.random((3, C)) < 0.5),
                         tab["k1"].gather(1, torch.from_numpy(pick)),
                         tab["pk1"])
        q2 = torch.where(q1 == tab["pk1"], tab["pk2"],
                         tab["k2"].gather(1, torch.from_numpy(pick)))
        q1[:, 0], q2[:, 0] = EMPTY
        q1[:, -1] = 12345
        want = plain_join(tab, q1, q2)
        got = make_join(rng, nb_bits)(tab, q1, q2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(int_view(a), int_view(b))


def test_join_of_signed_zeros_takes_plus_zero():
    """The one difference the model shows from the plain join (ROADMAP C):
    two valid slots with one key (a hash collision) whose states are -0
    and +0. The kernel's atomicMax takes +0; the plain masked max takes
    whichever its reduction order gives, a value equal to it."""
    rng = np.random.default_rng(3)
    tab = random_table(rng, 5, 2, B=1)
    for i, j in ((5, 6), (6, 5)):
        t = {k: v.clone() for k, v in tab.items()}
        t["val"][0, [i, j]] = True
        t["k1"][0, j], t["k2"][0, j] = t["k1"][0, i], t["k2"][0, i]
        t["st0"][0, i], t["st0"][0, j] = -0.0, 0.0
        q1, q2 = t["k1"][:, i:i + 1], t["k2"][:, i:i + 1]
        for nb_bits in NB_BITS:
            got = make_join(rng, nb_bits)(t, q1, q2)[0]
            assert int_view(got)[0, 0] == 0  # +0
        assert plain_join(t, q1, q2)[0][0, 0] == 0.0


@pytest.mark.parametrize("nb_bits", NB_BITS)
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("model_id", KINDS)
def test_one_step_equals_plain_step(W, model_id, nb_bits):
    """A whole step with the kernel's selection and join is the plain
    step, bit for bit, and the kernel's dedup of the new table (through
    its own hash table) is ``_dedup_mask``'s."""
    rng = np.random.default_rng(1000 + 10 * W + model_id + nb_bits)
    tab = random_table(rng, W, model_id)
    y_t = emission_row(rng, 3, model_id)
    r_t = torch.from_numpy((-rng.random((3, 1)) * 5).astype(np.float32))
    src_p, new_p = plain_step(tab, y_t, r_t, W, A, model_id)
    src_m, new_m = plain_step(tab, y_t, r_t, W, A, model_id,
                              select=make_select(rng, nb_bits),
                              join=make_join(rng, nb_bits))
    np.testing.assert_array_equal(src_m.numpy(), src_p.numpy())
    for k in TABLE_FIELDS:
        a, b = new_m[k], new_p[k]
        if a.dtype == torch.float32:
            np.testing.assert_array_equal(int_view(a), int_view(b),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    keep = _dedup_mask(new_p["k1"], new_p["k2"], new_p["val"]).numpy()
    for r in range(3):
        h = HashTable(new_p, r, rng.permutation(W * (A + 1)), nb_bits)
        assert [h.kept(i) for i in range(W * (A + 1))] == keep[r].tolist()


def test_step_tables_hold_what_the_schedule_must_handle():
    """The random tables above do carry ties, wide steps, child-child and
    stay-child duplicates and marker keys (else the tests prove less)."""
    rng = np.random.default_rng(5)
    seen = dict(tie=0, wide=0, stay_dup=0, child_dup=0, marker=0)
    for _ in range(6):
        tab = random_table(rng, 25, 1, B=3)
        for r in range(3):
            val = tab["val"][r].numpy()
            keys = list(zip(tab["k1"][r].tolist(), tab["k2"][r].tolist()))
            codes = [order_code(float(x)) for x in tab["sc"][r]]
            kc = [codes[i] for i in range(125) if val[i]]
            seen["tie"] += len(kc) > len(set(kc))
            seen["wide"] += max(kc) - min(kc[:25] or [0]) >= 1 << 25
            seen["stay_dup"] += any(val[j] and keys[j] in keys[:25]
                                    for j in range(25, 125))
            ck = [keys[j] for j in range(25, 125) if val[j]]
            seen["child_dup"] += len(ck) > len(set(ck))
            seen["marker"] += any(val[j] and keys[j] == EMPTY
                                  for j in range(125))
    assert all(v > 0 for v in seen.values()), seen


def test_clock_phases_match_the_kernel():
    """chip_smoke.py names the instrumented build's phase sums with
    ``beam1d.CLOCK_PHASES``: the kernel's CK_* enum, in order, then the
    step count."""
    enum = re.search(r"enum \{([^}]*)\};", SRC.read_text()).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names[-2:] == ["CK_STEPS", "CK_N"]
    assert [n[3:].lower() for n in names[:-2]] == list(beam1d.CLOCK_PHASES)


def test_kernel_constants_match_the_model():
    text = SRC.read_text()
    assert re.search(r"constexpr int NT = (\d+);", text).group(1) == str(NT)
    lo = re.search(r"constexpr int NB_BITS_MIN = (\d+);", text).group(1)
    hi = re.search(r"constexpr int NB_BITS_MAX = (\d+);", text).group(1)
    assert (int(lo), int(hi)) == NB_BITS
    assert "0x9e3779b1u" in text and "0x85ebca6bu" in text
