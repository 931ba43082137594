"""The by-row pair beam kernel's wrapper (ops/pair_row_beam.py).

On the CPU: the packed layout the kernel and its plain version read,
argument checks, the storage path a wave takes, and the plain route.
Tests marked ``cuda`` build and launch the kernel and hold it bit for bit
against its plain version on the card, per model kind, storage path and
beam width; they skip without one (run them with ``python -m pytest
--noconftest -m cuda tests/test_torch_row_kernel.py`` on a CUDA machine,
where ``tests/conftest.py`` would import jax). This file imports no jax.
"""
import numpy as np
import pytest
import torch

from poreover_tpu_torch.ops import beam2d as tb
from poreover_tpu_torch.ops import pair_row_beam as prb
from poreover_tpu_torch.sim import template_pairs as row_pairs

torch.set_num_threads(1)

MODELS = ("ctc", "ctc_merge_repeats", "ctc_flipflop")


def test_storage_layout_and_paths():
    """The storage a workload takes grows with C and Wb; a wave whose
    largest workload is over the shared-memory limit takes global
    scratch."""
    assert prb.storage_floats(25, 83) * 4 < prb.SMEM_STORAGE_LIMIT
    assert prb.storage_floats(125, 83) * 4 > prb.SMEM_STORAGE_LIMIT
    narrow = row_pairs("ctc", 1, 2, 20, 30, half_width=10)
    wide = row_pairs("ctc", 1, 1, 60, 70, half_width=1000)
    for W, wls, want in ((5, narrow, "shared"), (25, narrow, "shared"),
                         (5, narrow + wide, "global")):
        prep = prb.prepare_rows(wls, beam_width=W, device="cpu")
        assert prb.storage_path(prep) == want


def test_scratch_offsets_follow_the_storage_layout():
    """Each workload's storage starts in global scratch where the one
    before it ends; the packer alone leaves the column at 0."""
    wls = row_pairs("ctc", 3, 2, 20, 30, half_width=10) + \
        row_pairs("ctc", 4, 1, 20, 30)
    for W in (5, 25):
        prep = prb.prepare_rows(wls, beam_width=W, device="cpu")
        m = prep["meta"]
        sizes = [prb.storage_floats(W * 5, int(wb)) for wb in m[:, tb.RM_WB]]
        assert list(m[:, tb.RM_SCR]) == [0, sizes[0], sizes[0] + sizes[1]]
        assert torch.equal(prep["dev"][5], torch.from_numpy(m))
    assert not tb.pack_rows(wls, 5)["meta"][:, tb.RM_SCR].any()


def test_packed_rows_and_offsets():
    wls = row_pairs("ctc_flipflop", 2, 2, 10, 20, half_width=6) + \
        row_pairs("ctc_flipflop", 3, 1, 10, 20)
    p = tb.pack_rows(wls, 5, model="ctc_flipflop")
    m = p["meta"]
    assert p["y1"].shape == (sum(len(w[0]) for w in wls), 8)
    assert list(m[:, tb.RM_U0]) == [0, 0, 1]
    assert list(m[:, tb.RM_R]) == [len(wls[0][0]), len(wls[1][0]),
                                   len(wls[2][0]) - 1]
    assert m[2, tb.RM_WB] == len(wls[2][1])
    assert list(m[:, tb.RM_ROW]) == [0, m[0, tb.RM_R],
                                     m[0, tb.RM_R] + m[1, tb.RM_R]]
    assert len(p["rows"]) == m[:, tb.RM_R].sum()
    np.testing.assert_array_equal(
        p["cum2"][:len(wls[0][1])],
        tb._cumsum_xla(torch.from_numpy(wls[0][1][:, -1].copy())).numpy())


def test_packed_tensors_are_contiguous_for_any_input_order():
    """A reverse-complemented trace can be a Fortran-order view; the packed
    tensors the kernel reads are C order all the same."""
    wls = [(np.asfortranarray(y1), np.asfortranarray(y2[::-1]), env)
           for y1, y2, env in row_pairs("ctc", 7, 2, 10, 20, 8)]
    prep = prb.prepare_rows(wls, device="cpu")
    assert all(t.is_contiguous() for t in prep["dev"])


def test_cpu_tensors_are_refused_by_the_kernel():
    prep = prb.prepare_rows(row_pairs("ctc", 4, 2, 10, 20, 8),
                            device="cpu")
    with pytest.raises(ValueError, match="expected cuda"):
        prb.row_beam_cuda(*prep["dev"], prep["meta"], 5)
    t = list(prep["dev"])
    t[0] = t[0].double()
    with pytest.raises(TypeError, match="float64"):
        prb.row_beam_cuda(*t, prep["meta"], 5)
    with pytest.raises(ValueError, match="W\\*\\(A\\+1\\)"):
        prb.row_beam_cuda(*prep["dev"], prep["meta"], 26)


def test_plain_route_on_the_cpu_counts_no_launch():
    before = prb.launch_count
    wls = row_pairs("ctc_merge_repeats", 5, 3, 10, 25, half_width=8)
    got = prb.pair_row_beam(wls, device="cpu", model="ctc_merge_repeats")
    assert prb.launch_count == before
    assert got == [prb.pair_row_beam([w], device="cpu",
                                     model="ctc_merge_repeats")[0]
                   for w in wls]


def test_cut_rows_are_a_prefix_of_the_search():
    """A wave cut to its first rows (the card's checks) takes the same
    beam_src on those rows as the whole wave."""
    wls = row_pairs("ctc", 6, 2, 20, 30, half_width=10)
    full = prb.prepare_rows(wls, device="cpu")
    cut = prb.prepare_rows(wls, device="cpu", n_rows=[40, 30])
    fo, co = prb.launch_prepared(full), prb.launch_prepared(cut)
    for b, n in enumerate((40, 30)):
        fr = full["meta"][b, tb.RM_ROW]
        cr = cut["meta"][b, tb.RM_ROW]
        assert torch.equal(fo[0][fr:fr + n], co[0][cr:cr + n])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def same_outputs(k, p):
    """Kernel outputs against plain outputs: beam_src rows, validity and
    the traceback equal, the final scores bit for bit."""
    src, score, valid, chars, first = (x.cpu() for x in k)
    psrc, pscore, pvalid, pchars, pfirst = (x.cpu() for x in p)
    assert torch.equal(src, psrc)
    assert torch.equal(valid, pvalid)
    assert torch.equal(score.view(torch.int32), pscore.view(torch.int32))
    assert torch.equal(chars, pchars)
    assert torch.equal(first, pfirst)


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("W", [5, 25])
def test_kernel_matches_plain_on_card(cuda_device, model, W):
    wls = row_pairs(model, 11, 3, 15, 30, half_width=12) + \
        row_pairs(model, 12, 1, 8, 12)
    prep = prb.prepare_rows(wls, beam_width=W, device=cuda_device,
                            model=model)
    k = prb.row_beam_cuda(*prep["dev"], prep["meta"], W, model_id=prep[
        "model_id"])
    torch.cuda.synchronize()
    p = tb.row_scan(*prep["dev"], prep["meta"], W, 4, prep["model_id"])
    same_outputs(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_global_storage_equals_shared(cuda_device, model):
    wls = row_pairs(model, 13, 3, 15, 30, half_width=12)
    prep = prb.prepare_rows(wls, device=cuda_device, model=model)
    assert prb.storage_path(prep) == "shared"
    args = (*prep["dev"], prep["meta"], 5, 4, prep["model_id"])
    a = prb._launch(*args)
    b = prb._launch(*args, storage="global")
    torch.cuda.synchronize()
    same_outputs(a, b)
    same_outputs(a, tb.row_scan(*prep["dev"], prep["meta"], 5, 4,
                                prep["model_id"]))


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("lo,hi,path", [(18, 26, "shared"),
                                        (40, 60, "global")])
def test_kernel_on_dense_boxes(cuda_device, model, lo, hi, path):
    """Whole lattices (no envelope: the dense boxes of ``pair-decode
    --method split|align``) of ~150-200 and ~300-500 columns: bit-equal
    to the plain version in the storage path the wave takes, and with its
    storage forced into global scratch."""
    wls = row_pairs(model, 13, 3, lo, hi)
    prep = prb.prepare_rows(wls, device=cuda_device, model=model)
    assert prb.storage_path(prep) == path
    args = (*prep["dev"], prep["meta"], 5, 4, prep["model_id"])
    want = tb.row_scan(*args)
    for storage in (None, "global"):
        same_outputs(prb._launch(*args, storage=storage), want)


@pytest.mark.cuda
def test_main_path_counts_launches(cuda_device):
    before = prb.launch_count
    wls = row_pairs("ctc", 14, 2, 10, 20, half_width=8)
    got = prb.pair_row_beam(wls, device=cuda_device)
    assert prb.launch_count == before + 1
    assert got == prb.pair_row_beam(wls, device="cpu")
