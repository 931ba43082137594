"""The single-pair entry ``beam_search_2d(method="row_col")`` on the CPU
against the JAX package's planned engine in float32 (the plain reference of
the single-pair Pallas kernel, which cannot run off a TPU), on the five
envelope cases of tests/test_pallas.py. Strings exact.
"""
import pytest
import torch

from poreover_tpu.ops import beam2d_planned as jp

from poreover_tpu_torch.ops import beam2d as tb2
from poreover_tpu_torch.ops import pair_beam_batch as pbb

from test_torch_planned import jax_f32, pallas_cases

torch.set_num_threads(1)

CASES = pallas_cases()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_row_col_entry_equals_jax_planned(i):
    y1, y2, env = CASES[i]
    with jax_f32():
        want = jp.beam_search_2d_planned(y1, y2, env, beam_width=5)
    before = (pbb.launch_count, pbb.single_launch_count)
    got = tb2.beam_search_2d(y1, y2, env, beam_width=5, method="row_col",
                             device="cpu")
    assert got == want and len(got) > 0
    # the CPU route is the plain version: no launch is counted
    assert (pbb.launch_count, pbb.single_launch_count) == before


def test_no_envelope_is_the_full_lattice():
    y1, y2, env = CASES[2]
    assert tb2.beam_search_2d(y1, y2, None, 5, method="row_col",
                              device="cpu") == \
        tb2.beam_search_2d(y1, y2, env, 5, method="row_col", device="cpu")


def test_unported_methods_and_kinds_name_their_item(monkeypatch):
    """``row`` and ``grid`` decode now (tests/test_torch_row_beam.py,
    tests/test_torch_grid.py); ``row_col_steps`` still names its item, and
    the card's entries raise without a card."""
    y1, y2, env = CASES[2]
    with pytest.raises(NotImplementedError, match="A13"):
        tb2.beam_search_2d(y1, y2, env, 5, method="row_col_steps",
                           device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        tb2.beam_search_2d(y1, y2, env, 5, method="diag", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in ("row_col", "row"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb2.beam_search_2d(y1, y2, env, 5, method=method)


@pytest.mark.parametrize("model,S", [("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
def test_bonito_and_flipflop_through_the_entry(model, S):
    """The kinds that raised before (ROADMAP A2b) go through the entry's
    plain version on the CPU, to the JAX planned engine's string."""
    y1, y2, env = pallas_cases(S)[3]
    with jax_f32():
        want = jp.beam_search_2d_planned(y1, y2, env, beam_width=5,
                                         model=model)
    before = (pbb.launch_count, pbb.single_launch_count)
    got = tb2.beam_search_2d(y1, y2, env, beam_width=5, model=model,
                             method="row_col", device="cpu")
    assert got == want and len(got) > 0
    assert (pbb.launch_count, pbb.single_launch_count) == before
