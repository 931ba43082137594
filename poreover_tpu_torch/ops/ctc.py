"""CTC loss: the wrapper of the CUDA kernel ``csrc/ctc.cu`` and its plain
PyTorch version.

Port of ``poreover_tpu/ops/ctc.py`` (tf.compat.v1.nn.ctc_loss semantics,
blank LAST, reference network.py:97-102): ``merge_repeated=False`` is the
plain "poreover" variant (paths map to labels by deleting blanks only),
``merge_repeated=True`` standard (Graves) CTC with the repeat rule. The
JAX package computes both as a ``lax.scan`` over time and takes the
gradient by autodiff; here the log-softmax stays in PyTorch autograd and
the trellis is an autograd function with a forward (alpha) and a backward
(gamma, the adjoint of the alpha recursion) pass:

- ``ctc_cuda``: the kernels of ``csrc/ctc.cu``: the alpha pass, and the
  gradient pass's sequential kernel and its class sums (one launch of the
  library per pass, geometry from ``launch_geometry``);
- ``ctc_plain``: the same recursions written step by step in PyTorch over
  [B, SP] columns, with the kernel's float32 operations in the kernel's
  order, including the order in which a warp sums a class's edge
  occupancies (each lane its states s = lane, lane + 32, ... in turn, then
  a butterfly over 16, 8, 4, 2, 1 lanes: ``_fold``);
- ``ctc_loss``: the log-softmax, then ``ctc_cuda`` for logits on a CUDA
  device and ``ctc_plain`` for logits on the CPU. Nothing falls back.

``_NEG_INF = -1e5`` is the finite stand-in for log 0 everywhere (as in the
JAX loss: an infeasible label gives a loss near 1e5 with finite
gradients); time steps at or past ``logit_lengths`` leave alpha as it is
and get a zero gradient. The backward pass starts with weight only on the
state(s) the loss reads and zero elsewhere; see ``csrc/ctc.cu`` for the
formulas. Labels are clamped to 0..A-1 (the bases; the blank is A). The
kernel takes A + 1 = 5 classes and at most ``MAX_SP`` padded states
(``2 L + 1`` or ``L + 1`` rounded up to a multiple of 32); the plain
version takes any.

``launch_count`` counts alpha-pass launches and ``grad_launch_count``
gradient-pass launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import build_kernel

_NEG_INF = -1e5
C_KERNEL = 5  # classes the kernel takes (4 bases + blank)
# padded states per sequence the kernels take (merging: labels of up to
# 4831 bases); within a CTA's 227 KB the gradient pass needs 3 (plain) or
# 4 (merging) float32 per state at its shallowest ring
MAX_SP = 9664
SMEM_MAX = 232448  # dynamic shared memory one CTA may use (H100)
STATES_PER_THREAD = (1, 2, 4, 8, 16)  # the kernels' instances (K)
RING_MAX = 8  # most alpha columns per chunk of the gradient pass's ring
Y_ROW = 8  # floats per staged log-probability row
Y_CHUNK = 32  # log-probability rows per chunk of the alpha pass's ring

launch_count = 0
grad_launch_count = 0

PHASE_CLOCKS = "POREOVER_PHASE_CLOCKS"  # macro of the instrumented build
# the instrumented build's phase sums (csrc/ctc.cu: CK_*), in order: the
# alpha pass's, the gradient pass's; then the two passes' step counts and
# a sink slot
CLOCK_ALPHA = ("load", "lse", "wait", "barrier")
CLOCK_GRAD = ("weights", "barrier1", "gamma", "prefetch", "barrier2")
CLOCK_PARTS = (("alpha", CLOCK_ALPHA, "step"), ("grad", CLOCK_GRAD, "step"))
CLOCK_SLOTS = len(CLOCK_ALPHA) + len(CLOCK_GRAD) + 3

_libs = {}


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own,
    with ``phase_clocks_read``)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "ctc", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ctc_alpha_launch.restype = i
    lib.ctc_alpha_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                                     i, i, vp, vp, vp]
    lib.ctc_grad_launch.restype = i
    lib.ctc_grad_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                                    i, vp, vp, vp, vp, vp]
    if phase_clocks:
        lib.phase_clocks_read.restype = i
        lib.phase_clocks_read.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), i, i]
    _libs[phase_clocks] = lib
    return lib


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """The JAX loss's log-softmax over the last axis: max-shifted, then
    minus the log of the sum of exps."""
    s = logits - logits.amax(-1, keepdim=True)
    return s - torch.log(torch.exp(s).sum(-1, keepdim=True))


def padded_states(L: int, merge: bool) -> int:
    """SP: the states of a label of L (2L + 1 merged, L + 1 plain) rounded
    up to a multiple of 32 (one warp's round)."""
    S = 2 * L + 1 if merge else L + 1
    return 32 * ((S + 31) // 32)


def launch_geometry(SP: int, merge: bool, grad: bool):
    """One CTA's geometry for SP padded states: (threads, states per thread
    K, ring, dynamic shared bytes), the one source both launchers follow
    (``csrc/ctc.cu`` checks it).

    K is the smallest instance that needs at most 1024 threads; state s
    belongs to thread s % threads. Each pass stages its inputs in two
    chunks of a ring: the alpha pass Y_CHUNK log-probability rows per
    chunk (besides two columns of SP floats); the gradient pass ``ring``
    alpha columns per chunk (plain: each with its row), as many as the
    shared memory left allows up to RING_MAX, besides one (plain) or two
    (merging) arrays of SP floats."""
    K = next((k for k in STATES_PER_THREAD if -(-SP // k) <= 1024), None)
    if K is None or SP <= 0 or SP % 32:
        raise ValueError(f"ctc: no launch geometry for SP = {SP}")
    threads = 32 * -(-SP // (32 * K))
    if not grad:
        return threads, K, Y_CHUNK, (2 * SP + 2 * Y_CHUNK * Y_ROW) * 4
    fixed = (2 if merge else 1) * SP * 4
    slot = (SP if merge else SP + Y_ROW) * 4
    ring = min(RING_MAX, (SMEM_MAX - fixed) // (2 * slot))
    if ring < 1:
        raise ValueError(f"ctc: SP = {SP} leaves no room for the ring")
    return threads, K, ring, fixed + 2 * ring * slot


def _check(logp, labels, label_lengths, logit_lengths):
    dev = logp.device
    if logp.dim() != 3 or logp.dtype != torch.float32:
        raise TypeError(f"logp: expected float32 [B, T, C], got {logp.dtype} "
                        f"{tuple(logp.shape)}")
    B, T, _ = logp.shape
    if labels.dim() != 2 or labels.shape[0] != B:
        raise ValueError(f"labels {tuple(labels.shape)}: expected [{B}, L]")
    for name, t, shape in (("labels", labels, tuple(labels.shape)),
                           ("label_lengths", label_lengths, (B,)),
                           ("logit_lengths", logit_lengths, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: expected int32 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if not logp.is_contiguous():
        raise ValueError("logp: not contiguous")


def alpha_pass(logp, labels, label_lengths, logit_lengths,
               merge: bool = False):
    """The forward kernel on the current stream: (nll float32 [B], alpha
    float32 [B, T+1, SP]), without synchronising. Arguments as
    ``ctc_cuda``'s."""
    global launch_count
    _check(logp, labels, label_lengths, logit_lengths)
    dev = logp.device
    if dev.type != "cuda":
        raise ValueError(f"ctc_cuda: tensors on {dev}, expected cuda")
    B, T, C = logp.shape
    L = labels.shape[1]
    if C != C_KERNEL:
        raise ValueError(f"ctc_cuda: the kernel takes {C_KERNEL} classes, "
                         f"got {C}")
    SP = padded_states(L, merge)
    if SP > MAX_SP:
        raise ValueError(f"ctc_cuda: labels of {L} need {SP} states; the "
                         f"kernel takes <= {MAX_SP}")
    lib = load_kernel()
    alpha = torch.empty((B, T + 1, SP), dtype=torch.float32, device=dev)
    nll = torch.empty(B, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ctc_alpha_launch(
            logp.data_ptr(), labels.data_ptr(), label_lengths.data_ptr(),
            logit_lengths.data_ptr(), B, T, L, SP, int(merge),
            *launch_geometry(SP, merge, grad=False), alpha.data_ptr(),
            nll.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ctc alpha kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return nll, alpha


def grad_pass(logp, labels, label_lengths, logit_lengths, merge, alpha,
              grad_out):
    """The backward kernels on the current stream: the gradient float32
    [B, T, C] of ``sum(grad_out * nll)`` in ``logp``, from
    ``alpha_pass``'s alpha, without synchronising."""
    global grad_launch_count
    B, T, C = logp.shape
    L, SP = labels.shape[1], alpha.shape[2]
    if alpha.shape != (B, T + 1, SP) or SP != padded_states(L, merge):
        raise ValueError(f"alpha {tuple(alpha.shape)} does not match logp "
                         f"{tuple(logp.shape)} and labels "
                         f"{tuple(labels.shape)}")
    go = grad_out.to(torch.float32).contiguous()
    grad = torch.empty_like(logp)
    # each step's class terms, summed by the second kernel
    terms = torch.empty(((1 if merge else 2) * B, T, SP), dtype=torch.float32,
                        device=logp.device)
    dev = logp.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = load_kernel().ctc_grad_launch(
            logp.data_ptr(), labels.data_ptr(), label_lengths.data_ptr(),
            logit_lengths.data_ptr(), B, T, L, SP, int(merge),
            *launch_geometry(SP, merge, grad=True), alpha.data_ptr(),
            go.data_ptr(), terms.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ctc gradient kernel launch failed: CUDA error "
                           f"{err}")
    grad_launch_count += 1
    return grad


class _CTCCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logp, labels, label_lengths, logit_lengths, merge):
        nll, alpha = alpha_pass(logp, labels, label_lengths, logit_lengths,
                                merge)
        ctx.merge = merge
        ctx.save_for_backward(logp, labels, label_lengths, logit_lengths,
                              alpha)
        return nll

    @staticmethod
    def backward(ctx, grad_out):
        logp, labels, label_lengths, logit_lengths, alpha = ctx.saved_tensors
        return grad_pass(logp, labels, label_lengths, logit_lengths,
                         ctx.merge, alpha, grad_out), None, None, None, None


def ctc_cuda(logp, labels, label_lengths, logit_lengths,
             merge: bool = False):
    """Per-sequence NLL [B] of ``logp`` float32 [B, T, 5] (log-probs, blank
    last) on a CUDA device, through the kernels; differentiable in
    ``logp``. ``labels`` int32 [B, L], ``label_lengths`` and
    ``logit_lengths`` int32 [B], all contiguous on the same device."""
    return _CTCCuda.apply(logp, labels, label_lengths, logit_lengths,
                          bool(merge))


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[..., SP] -> [...]: the kernel's sum of per-state terms, each lane's
    states in round order, then the warp's xor butterfly (every row alone:
    the classes of a step go through one fold, one launch a round)."""
    *lead, SP = x.shape
    x = x.reshape(-1, SP // 32, 32)
    acc = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0].reshape(lead)


def _tables(labels, label_lengths, logit_lengths, T, SP, merge, C):
    """The kernel's per-state tables as [B, SP] tensors: the class each
    state emits, whether the s-2 -> s move is allowed (merge), which states
    are real (s < S_b); and the clamped lengths."""
    dev = labels.device
    B, L = labels.shape
    Lb = label_lengths.long().clamp(0, L)
    Tb = logit_lengths.long().clamp(0, T)
    lab = labels.long().clamp(0, C - 2)
    s = torch.arange(SP, device=dev)
    gap = torch.full((B, SP), C - 1, dtype=torch.long, device=dev)
    if merge:
        idx = ((s - 1) // 2).clamp(0, max(L - 1, 0))
        odd = (s % 2 == 1) & (s <= 2 * L)
        lab_s = lab[:, idx] if L else gap
        cls = torch.where(odd[None, :], lab_s, gap)
        prev = lab[:, ((s - 3) // 2).clamp(0, max(L - 1, 0))] if L else gap
        skip = odd[None, :] & (s >= 3)[None, :] & (lab_s != prev)
        S = 2 * Lb + 1
    else:
        idx = (s - 1).clamp(0, max(L - 1, 0))
        real = (s >= 1) & (s <= L)
        cls = torch.where(real[None, :], lab[:, idx] if L else gap, gap)
        skip = torch.zeros((B, SP), dtype=torch.bool, device=dev)
        S = Lb + 1
    valid = s[None, :] < S[:, None]
    return cls, skip, valid, Lb, Tb


def _shift(x, n, fill):
    """x moved n states up (state s takes s - n), ``fill`` below."""
    return torch.cat([torch.full_like(x[:, :n], fill), x[:, :-n]], 1)


def _unshift(x, n):
    """x moved n states down (state s takes s + n), zero above."""
    return torch.cat([x[:, n:], torch.zeros_like(x[:, :n])], 1)


def _final(alpha, Lb, merge):
    """ll of each sequence from the last alpha column, and the weights of
    the states it reads (the backward pass's start)."""
    rows = torch.arange(alpha.shape[0], device=alpha.device)
    if not merge:
        ll = alpha[rows, Lb]
        gam = torch.zeros_like(alpha)
        gam[rows, Lb] = 1.0
        return ll, gam
    last_blank = alpha[rows, 2 * Lb]
    last_char = torch.where(Lb > 0, alpha[rows, (2 * Lb - 1).clamp(min=0)],
                            torch.full_like(last_blank, _NEG_INF))
    ll = torch.logaddexp(last_blank, last_char)
    gam = torch.zeros_like(alpha)
    has = Lb > 0
    gam[rows[has], 2 * Lb[has] - 1] = torch.exp(last_char[has] - ll[has])
    gam[rows, 2 * Lb] = torch.exp(last_blank - ll)
    return ll, gam


def _alpha_step(alpha, y, cls, skip, t, merge):
    """One column of the forward recursion (before the logit-length mask)."""
    e = y.gather(1, cls)
    if not merge:
        stay = alpha + y[:, -1:]
        x1 = _shift(alpha, 1, 0.0)[:, 1:] + e[:, 1:]
        return torch.cat([stay[:, :1], torch.logaddexp(x1, stay[:, 1:])], 1)
    if t == 0:
        new = torch.full_like(alpha, _NEG_INF)
        new[:, :2] = e[:, :2]
        return new
    sh1 = _shift(alpha, 1, _NEG_INF)
    sk = torch.where(skip, _shift(alpha, 2, _NEG_INF), _NEG_INF)
    return torch.logaddexp(torch.logaddexp(alpha, sh1), sk) + e


def _plain_forward(logp, labels, label_lengths, logit_lengths, merge):
    B, T, C = logp.shape
    SP = padded_states(labels.shape[1], merge)
    cls, skip, valid, Lb, Tb = _tables(labels, label_lengths, logit_lengths,
                                       T, SP, merge, C)
    alpha = torch.full((B, SP), _NEG_INF, dtype=logp.dtype,
                       device=logp.device)
    if not merge:
        alpha[:, 0] = 0.0
    alphas = [alpha]
    for t in range(T):
        new = _alpha_step(alpha, logp[:, t], cls, skip, t, merge)
        alpha = torch.where((t < Tb)[:, None], new, alpha)
        alphas.append(alpha)
    ll, _ = _final(alpha, Lb, merge)
    return -ll, torch.stack(alphas, 1)


def _plain_backward(logp, labels, label_lengths, logit_lengths, merge,
                    alphas, grad_out):
    B, T, C = logp.shape
    SP = alphas.shape[2]
    cls, skip, valid, Lb, Tb = _tables(labels, label_lengths, logit_lengths,
                                       T, SP, merge, C)
    rows = torch.arange(B, device=logp.device)
    _, gam = _final(alphas[rows, Tb], Lb, merge)
    zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
    mgo = -grad_out
    grad = torch.zeros_like(logp)
    masks = torch.stack([(cls == c) & valid for c in range(C)])  # [C, B, SP]
    for t in reversed(range(T)):
        act = t < Tb
        a, an, y = alphas[:, t], alphas[:, t + 1], logp[:, t]
        if not merge:
            e = y.gather(1, cls)
            x1 = _shift(a, 1, 0.0) + e
            x2 = a + y[:, -1:]
            ge = torch.where(valid, gam * torch.exp(x1 - an), zero)
            ge[:, 0] = 0.0
            gs = torch.where(valid, gam * torch.exp(x2 - an), zero)
            gs[:, 0] = gam[:, 0]
            sums = _fold(torch.cat([torch.where(masks[:C - 1], ge, zero),
                                    torch.where(valid, gs, zero)[None]]))
            new_gam = torch.where(valid, gs + _unshift(ge, 1), zero)
        else:
            em = gam if t > 0 else torch.where(
                torch.arange(SP, device=a.device) < 2, gam, zero)
            sums = _fold(torch.where(masks, em, zero))
            if t > 0:
                sh1 = _shift(a, 1, _NEG_INF)
                sk = torch.where(skip, _shift(a, 2, _NEG_INF), _NEG_INF)
                p1 = torch.logaddexp(a, sh1)
                p2 = torch.logaddexp(p1, sk)
                gp1 = torch.where(valid, gam * torch.exp(p1 - p2), zero)
                gsk = torch.where(valid & skip, gam * torch.exp(sk - p2),
                                  zero)
                v = gp1 * torch.exp(a - p1)
                v = v + torch.where(_unshift(valid, 1),
                                    _unshift(gp1, 1) * torch.exp(
                                        a - _unshift(p1, 1)), zero)
                v = v + _unshift(gsk, 2)
                new_gam = torch.where(valid, v, zero)
            else:
                new_gam = gam
        g_t = (mgo * sums).t()
        grad[:, t] = torch.where(act[:, None], g_t, zero)
        gam = torch.where(act[:, None], new_gam, gam)
    return grad


class _CTCPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logp, labels, label_lengths, logit_lengths, merge):
        _check(logp, labels, label_lengths, logit_lengths)
        nll, alphas = _plain_forward(logp, labels, label_lengths,
                                     logit_lengths, merge)
        ctx.merge = merge
        ctx.save_for_backward(logp, labels, label_lengths, logit_lengths,
                              alphas)
        return nll

    @staticmethod
    def backward(ctx, grad_out):
        logp, labels, label_lengths, logit_lengths, alphas = ctx.saved_tensors
        grad = _plain_backward(logp, labels, label_lengths, logit_lengths,
                               ctx.merge, alphas,
                               grad_out.to(logp.dtype).contiguous())
        return grad, None, None, None, None


def ctc_plain(logp, labels, label_lengths, logit_lengths,
              merge: bool = False):
    """The kernels' plain PyTorch version: the same arguments and result as
    ``ctc_cuda``, on the inputs' device."""
    return _CTCPlain.apply(logp, labels, label_lengths, logit_lengths,
                           bool(merge))


def _ints(x, device, shape=None):
    t = torch.as_tensor(x, device=device).to(torch.int32)
    if shape is not None:
        t = t.reshape(shape)
    return t.contiguous()


def ctc_loss(logits, labels, label_lengths, logit_lengths=None,
             merge_repeated: bool = False):
    """Batched CTC negative log-likelihood [B], differentiable in
    ``logits``.

    logits        [B, T, A+1] float32 raw scores, blank LAST
    labels        [B, L] ints, padded with any value past label_lengths
    label_lengths [B]
    logit_lengths [B] or None (= full T)

    Logits on a CUDA device go through the kernels, logits on the CPU
    through the plain version; the integer arguments (tensors or numpy
    arrays) are moved to the logits' device."""
    B, T, _ = logits.shape
    dev = logits.device
    labels = _ints(labels, dev)
    if labels.dim() != 2:
        labels = labels.reshape(B, -1)
    label_lengths = _ints(label_lengths, dev, (B,))
    logit_lengths = (torch.full((B,), T, dtype=torch.int32, device=dev)
                     if logit_lengths is None
                     else _ints(logit_lengths, dev, (B,)))
    logp = log_softmax(logits).contiguous()
    run = ctc_cuda if dev.type == "cuda" else ctc_plain
    return run(logp, labels, label_lengths, logit_lengths,
               bool(merge_repeated))
