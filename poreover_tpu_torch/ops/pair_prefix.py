"""2D pair prefix search: the wrapper of the CUDA kernel
``csrc/pair_prefix.cu``, its plain PyTorch version, and the host loop.

Port of ``poreover_tpu/ops/pair_prefix.py`` (jitted XLA level steps and a
host loop, not a Pallas kernel; the reference's pair_prefix_search_log,
prefix_search.py:247-385, and PairPrefixSearch.cpp:79-229): greedy
best-prefix expansion where a prefix's score is the probability that both
reads emit an extension of it,

  P(prefix) = lse_{(u,v) in envelope} alpha*_1(u) + alpha*_2(v)
              + gamma(u+1, v+1)  -  gamma(0,0),

with gamma from ``ops/gamma.py``. The search stops when the best
extension's prefix probability drops below the previous level's best
complete label's (prefix_search.py:298-308).

A level computes, for all A extension characters of both reads, the label
forward alpha (fw[t] = lse(y[t,gap] + fw[t-1], y[t,c] + prev[t-1])), the
no-gap forward alpha* (shifted prev + y[:,c]), the envelope reduction
lse_u(alpha*_1 + lse_w(alpha*_2 + G)) and the label probabilities. The
label forward is taken in closed form, fw = cw + cumlse(E - cw) with cw
the gap column's prefix sums (numpy's float64 cumsum, once per read), in
float64 on the inputs rounded to the run's dtype, through the odd/even
tree of ``jax.lax.associative_scan`` (``beam2d._lse_scan_``): log-depth,
where the JAX package's step-by-step chain is T dependent log-add-exps
per level. Its values are rounded to the run's dtype, in which the rest
of the level runs as in the JAX package. The log-sum-exps of the
envelope reduction add their terms in a pairwise tree (adjacent pairs,
the length padded with zeros to a power of two), so that the kernel can
split a sum over its threads and keep the order.

A batch of workloads (pairs or anchor boxes) searches in lockstep, one
level per iteration, each workload dropping out at its own stop; its
result is the one it has alone. For tensors on a CUDA device each level
is one launch of the kernel over the live workloads, and only 2·A floats
per workload come back to the host; the chosen rows of alpha stay on the
card, picked by index. For tensors on the CPU the plain version
``level_plain`` runs instead (it also runs on the card, for the check).
A kernel that does not build or launch raises; there is no fallback.
``launch_count`` counts kernel launches.

The host loop keeps the JAX package's rules: the reads rounded to
float64, then to the dtype; the empty label's probability numpy's
float64 sum of both gap columns, not normalised by gamma(0,0); the stop
test against the previous level's top label; the top label the first
of the largest in insertion order (kept as a running maximum); and the
``max(U, V)`` depth limit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from ..utils.logspace import LOG_0
from . import gamma as gm
from .beam2d import _cumsum_xla, _lse_scan_

_NEG_INF = LOG_0

launch_count = 0
levels_run: list[int] = []  # levels each searched workload ran, appended

# per-workload meta of a level (int64): read offsets and lengths in the
# frames, envelope rows, G's width and offset, the scratch offset of the
# envelope's per-row values
(L_O1, L_U, L_O2, L_V, L_EOFF, L_WB, L_G, L_VOFF) = range(8)
LEVEL_COLS = 8

_lib = None


def load_kernel():
    """Build (once) and load the kernel library; returns the ctypes lib."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernel("pair_prefix")))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pair_prefix_launch.restype = i
        lib.pair_prefix_launch.argtypes = [vp] * 15 + [ll, ll, i, i, i, i,
                                                       i, vp]
        lib.pair_prefix_rows_per_cta.restype = i
        lib.pair_prefix_rows_per_cta.argtypes = []
        _lib = lib
    return _lib


def workload_error(y1, y2, env):
    """The exception the JAX package's search raises on this workload
    before any result (an empty read: its label forward indexes row 0; an
    envelope of zero width: its reduction takes the max of an empty
    axis; a row ending before it starts, unless the widest row is no
    wider than that row is short: G's row takes an empty slice), or
    None."""
    U, V = len(y1), len(y2)
    if U == 0 or V == 0:
        return IndexError("index is out of bounds for axis 0 with size 0")
    env = np.asarray(env)
    width = env[:U, 1] - env[:U, 0]
    Wb = int(np.max(width))
    if Wb <= 0:
        return ValueError("zero-size array to reduction operation max "
                          "which has no identity")
    if np.any((width < 0) & (Wb + width > 0)):
        return ValueError("could not broadcast an empty row of G")
    return None


def prepare_search(workloads, device=None, dtype=np.float32):
    """Pack the workloads and run the gamma DP (kernel on the card).
    Returns the state both routes of a level read and write."""
    envs = [np.asarray(env, dtype=np.int64) for _, _, env in workloads]
    ws = []
    for (y1, y2, _), env in zip(workloads, envs):
        if env.shape[0] != len(y1):  # the search's envelope has U rows
            raise ValueError(f"envelope of {env.shape[0]} rows for a read "
                             f"of {len(y1)}")
        ws.append((y1, y2, env))
    gp = gm.prepare_gamma(ws, device=device, dtype=dtype)
    G, g00 = gm.gamma_batch(gp)
    meta = gp["meta"]
    dev, dt, A = gp["device"], gp["dtype"], gp["A"]
    lmeta, voff = [], 0
    for m in meta:
        U = int(m[gm.M_U])
        lmeta.append((m[gm.M_O1], U, m[gm.M_O2], m[gm.M_V], m[gm.M_EOFF],
                      m[gm.M_W] - 1, m[gm.M_G], voff))
        voff += U
    lmeta = np.asarray(lmeta, dtype=np.int64).reshape(-1, LEVEL_COLS)
    y = gp["y"]
    N = y.shape[0]
    # cw[o + t] = sum of the read's gap column over 1..t (float64)
    gap = y[:, A].double().cpu().numpy()
    cw = np.zeros(N, np.float64)
    for o, T in [(m[L_O1], m[L_U]) for m in lmeta] + [
            (m[L_O2], m[L_V]) for m in lmeta]:
        cw[o + 1:o + T] = np.cumsum(gap[o + 1:o + T])
    alpha = torch.full((2, A, N), _NEG_INF, dtype=dt, device=dev)
    # level 1 reads row 0 of buffer 0: each read's gap cumsum (XLA's)
    alpha[0, 0] = _read_cumsums(y[:, A], lmeta)
    return dict(
        device=dev, dtype=dt, A=A, gamma=gp, G=G, g00=g00,
        meta=lmeta, meta_t=torch.as_tensor(lmeta, device=dev), y=y,
        env=gp["env"], cw=torch.as_tensor(cw, device=dev), alpha=alpha,
        n_rows=voff, plain=None)


def _read_cumsums(gap, lmeta):
    """Each read's inclusive gap cumsum (``jnp.cumsum(y[:, -1])``, XLA's
    association), in the frames' layout."""
    out = torch.zeros_like(gap)
    reads = [(int(m[L_O1]), int(m[L_U])) for m in lmeta] + [
        (int(m[L_O2]), int(m[L_V])) for m in lmeta]
    Tm = max(T for _, T in reads)
    starts = torch.as_tensor([s for s, _ in reads], device=gap.device)
    lens = torch.as_tensor([T for _, T in reads], device=gap.device)
    rows, ok = gm._padded(gap, starts, lens, Tm)
    cs = _cumsum_xla(rows)
    for i, (s, T) in enumerate(reads):
        out[s:s + T] = cs[i, :T]
    return out


def _tree_sum(x):
    """Sum over the last axis in a pairwise tree: adjacent pairs, the
    length padded with zeros to a power of two."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p > n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _lse_tree(x):
    """The JAX package's ``logsumexp`` over the last axis, its sum taken
    by ``_tree_sum``."""
    m = x.max(dim=-1).values
    fin = torch.isfinite(m)
    ms = torch.where(fin, m, 0.0)
    s = _tree_sum(torch.exp(x - ms[..., None]))
    return torch.where(fin, torch.log(s) + ms, m)


def _plain_state(st):
    """Padded per-workload views of the packed state for the plain
    version (built once)."""
    if st["plain"] is not None:
        return st["plain"]
    dev, mt = st["device"], st["meta_t"]
    U, V, Wb = mt[:, L_U], mt[:, L_V], mt[:, L_WB]
    T = torch.stack([U, V], 1)  # [B, 2]
    starts = torch.stack([mt[:, L_O1], mt[:, L_O2]], 1)
    Tm = int(T.max())
    t = torch.arange(Tm, device=dev)
    fr = (starts[..., None] + t).clamp(0, st["y"].shape[0] - 1)  # [B,2,Tm]
    Um, Wbm = int(U.max()), max(int(Wb.max()), 1)
    env, _ = gm._padded(st["env"].long(), mt[:, L_EOFF], U, Um)
    env0 = env[..., 0]
    w = torch.arange(Wbm, device=dev)
    a2i = (env0[..., None] + w).clamp(min=0)
    a2i = torch.minimum(a2i, (V + Wb)[:, None, None])
    a2ok = a2i < V[:, None, None]
    B = len(st["meta"])
    G = torch.full((B, Um, Wbm), _NEG_INF, dtype=st["dtype"], device=dev)
    for b, m in enumerate(st["meta"]):
        Ub, Wbb = int(m[L_U]), int(m[L_WB])
        G[b, :Ub, :Wbb] = st["G"][m[L_G]:m[L_G] + Ub * Wbb].view(Wbb, Ub).T
    st["plain"] = dict(T=T, fr=fr, Tm=Tm, Um=Um, a2i=a2i.clamp(max=Tm - 1),
                       a2ok=a2ok, G=G,
                       umask=torch.arange(Um, device=dev)[None] < U[:, None],
                       y=st["y"][fr], cw=st["cw"][fr])
    return st["plain"]


def level_plain(st, level: int, live, sel, parity: int):
    """One level of the live workloads (``live`` int tensor of workload
    indices, ``sel`` [B] the previous level's chosen character of each):
    reads alpha buffer 1 - parity, writes buffer ``parity``. Returns [n,
    2, A] (prefix_prob, label_prob) in the run's dtype."""
    ps = _plain_state(st)
    A, dt = st["A"], st["dtype"]
    L = live.long()
    fr, y, cw, T = ps["fr"][L], ps["y"][L], ps["cw"][L], ps["T"][L]
    n, Tm = len(L), ps["Tm"]
    prev = st["alpha"][1 - parity][sel.long()[L][:, None, None], fr]
    emis = y[..., :A]  # [n, 2, Tm, A]
    first = level == 1
    seed = torch.full((n, 2, 1), 0.0 if first else _NEG_INF, dtype=dt,
                      device=prev.device)
    shifted = torch.cat([seed, prev[..., :-1]], dim=-1)
    aast = (shifted[..., None] + emis).transpose(-1, -2)  # [n, 2, A, Tm]
    # label forward, closed form in float64
    fw0 = emis[:, :, 0, :] if first else torch.full(
        (n, 2, A), _NEG_INF, dtype=dt, device=prev.device)
    e64, p64 = emis.double(), prev.double()
    E = (e64[:, :, 1:, :] + p64[..., :-1, None]).transpose(-1, -2)
    body = torch.cat([fw0.double()[..., None], E - cw[:, :, None, 1:]],
                     dim=-1)
    _lse_scan_(body)
    alpha = torch.cat([fw0[..., None],
                       (body[..., 1:] + cw[:, :, None, 1:]).to(dt)], dim=-1)
    g00 = st["g00"][L]
    last = alpha.gather(3, (T - 1)[:, :, None, None].expand(n, 2, A, 1))
    label = (last[:, 0, :, 0] + last[:, 1, :, 0]) - g00[:, None]
    # the envelope reduction
    Um = ps["Um"]
    a1 = torch.where(ps["umask"][L][:, None], aast[:, 0, :, :Um], _NEG_INF)
    a2i, a2ok = ps["a2i"][L], ps["a2ok"][L]  # [n, Um, Wb]
    a2 = aast[:, 1].gather(2, a2i.reshape(n, 1, -1).expand(n, A, -1))
    a2 = torch.where(a2ok.reshape(n, 1, -1), a2, _NEG_INF).view(
        n, A, Um, -1)
    inner = _lse_tree(a2 + ps["G"][L][:, None])
    prefix = _lse_tree(a1 + inner) - g00[:, None]
    # the chosen rows stay here: write this level's alpha back
    for i, b in enumerate(L.tolist()):
        m = st["meta"][b]
        for r, (o, Tr) in enumerate(((m[L_O1], m[L_U]), (m[L_O2], m[L_V]))):
            st["alpha"][parity, :, o:o + Tr] = alpha[i, r, :, :Tr]
    return torch.stack([prefix, label], dim=1)


def level_cuda(st, level: int, live, sel, parity: int):
    """One level as one launch of the kernel on the current stream (the
    arguments as ``level_plain``'s, on one CUDA device, float32). Returns
    [n, 2, A] without synchronising."""
    global launch_count
    dev = st["device"]
    if dev.type != "cuda":
        raise ValueError(f"level_cuda: tensors on {dev}, expected cuda")
    if st["dtype"] != torch.float32:
        raise TypeError(f"level_cuda: float32 only, got {st['dtype']}")
    lib = load_kernel()
    A, B = st["A"], len(st["meta"])
    if "scan" not in st:
        N = st["y"].shape[0]
        rows = lib.pair_prefix_rows_per_cta()
        st["chunks"] = max(-(-int(st["meta"][:, L_U].max()) // rows), 1)
        st["scan"] = torch.empty((A, max(N, 1)), dtype=torch.float64,
                                 device=dev)
        st["val"] = torch.empty((A, max(st["n_rows"], 1)),
                                dtype=torch.float32, device=dev)
        st["cmax"] = torch.empty(B * A * st["chunks"], dtype=torch.float32,
                                 device=dev)
        st["lastv"] = torch.empty(B * A * 2, dtype=torch.float32,
                                  device=dev)
        # counters of finished CTAs; the kernel leaves them at 0
        st["cnt"] = torch.zeros(B * A * 2, dtype=torch.int32, device=dev)
    n = int(live.shape[0])
    res = torch.empty((n, 2, A), dtype=torch.float32, device=dev)
    args = [st["y"], st["cw"], st["env"], st["G"], st["g00"], st["meta_t"],
            live, sel, st["alpha"], st["scan"], st["val"], st["cmax"],
            st["lastv"], st["cnt"], res]
    for t in args:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"level_cuda: inputs must be contiguous on "
                             f"{dev}")
    if live.dtype != torch.int32 or sel.dtype != torch.int32:
        raise TypeError("level_cuda: live and sel must be int32")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pair_prefix_launch(
            *(t.data_ptr() for t in args), st["y"].shape[0], st["n_rows"],
            n, A, level, parity, st["chunks"], stream)
    if err != 0:
        raise RuntimeError(f"pair_prefix kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return res


class _Search:
    """One workload's host state: the JAX loop's variables, the label
    dict kept as its running maximum."""

    def __init__(self, y1, y2, alphabet):
        self.alphabet = alphabet
        gap_prob = float(np.sum(y1[:, -1]) + np.sum(y2[:, -1]))
        self.curr = []  # chosen characters
        # labels as (length of curr they extend, character); the empty
        # label is (0, None)
        self.best = ((0, None), gap_prob)  # max of the dict so far
        self.top = self.best  # the top label of the previous level
        self.max_depth = max(len(y1), len(y2))
        self.levels = 0

    def level(self, prefix_prob, label_prob) -> int | None:
        """Feed one level's outputs (numpy, the run's dtype); returns the
        chosen character, or None when the search stops."""
        n = len(self.curr)
        self.levels += 1
        for c in range(len(label_prob)):
            val = float(label_prob[c])
            if val > self.best[1]:
                self.best = ((n, c), val)
        best_c = int(np.argmax(prefix_prob))
        if prefix_prob[best_c] < self.top[1]:
            return None
        self.top = self.best
        self.curr.append(best_c)
        if len(self.curr) > self.max_depth:
            return None
        return best_c

    def result(self):
        (n, c), prob = self.top
        chars = self.curr[:n] + ([] if c is None else [c])
        return "".join(self.alphabet[k] for k in chars), prob


def pair_prefix_search_batch(workloads, alphabet: str = "ACGT", device=None,
                             dtype=np.float32, max_levels=None,
                             trace=None, route=None):
    """Pair prefix search over (y1, y2, envelope) workloads in lockstep;
    returns one (label, log probability) per workload, each what it gets
    alone. ``route`` "plain" runs the plain version on a CUDA device (the
    card's check); ``max_levels`` stops after that many levels (every
    workload then returns its top label so far); ``trace`` (a list)
    collects each level's [n, 2, A] outputs."""
    if not workloads:
        return []
    searches = [_Search(np.asarray(y1, np.float64), np.asarray(y2,
                                                               np.float64),
                        alphabet) for y1, y2, _ in workloads]
    st = prepare_search(workloads, device=device, dtype=dtype)
    dev = st["device"]
    use_kernel = dev.type == "cuda" and route != "plain"
    step = level_cuda if use_kernel else level_plain
    B = len(workloads)
    sel = np.zeros(B, np.int32)
    live = list(range(B))
    live_t = None  # uploaded again only when a workload drops out
    level = 1
    while live and (max_levels is None or level <= max_levels):
        parity = level & 1
        if live_t is None or len(live_t) != len(live):
            live_t = torch.as_tensor(np.asarray(live, np.int32), device=dev)
        sel_t = torch.as_tensor(sel, device=dev)
        res = step(st, level, live_t, sel_t, parity).cpu().numpy()
        if trace is not None:
            trace.append(res)
        still = []
        for i, b in enumerate(live):
            c = searches[b].level(res[i, 0], res[i, 1])
            if c is not None:
                sel[b] = c
                still.append(b)
        live = still
        level += 1
    levels_run.extend(s.levels for s in searches)
    return [s.result() for s in searches]


def pair_prefix_search_log(y1, y2, envelope=None, alphabet: str = "ACGT",
                           device=None, dtype=np.float32):
    """Pair prefix search of one pair; returns (label, log joint
    probability). ``envelope``: [U, 2] int rows [start, end); None is the
    full lattice (the pure-python reference, prefix_search.py:247-310)."""
    y1 = np.asarray(y1, dtype=np.float64)
    y2 = np.asarray(y2, dtype=np.float64)
    if envelope is None:
        envelope = np.tile(np.array([0, len(y2)], dtype=np.int64),
                           (len(y1), 1))
    err = workload_error(y1, y2, envelope)
    if err is not None:
        raise err
    return pair_prefix_search_batch([(y1, y2, envelope)], alphabet,
                                    device=device, dtype=dtype)[0]
