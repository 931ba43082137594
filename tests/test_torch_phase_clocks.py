"""The phase clocks of the port's instrumented kernel builds
(``-DPOREOVER_PHASE_CLOCKS``, ``csrc/common.cuh``) as the wrapper modules
name their slots (``CLOCK_PARTS``, ``CLOCK_SLOTS``) against each source's
CK_* enum; ``chip_smoke.clock_parts``, which reads the slots of any of
them; and the latency floors' chains (``chip_smoke.viterbi_floor_cycles``,
``acceptor_floor_cycles``) on given latencies."""
from __future__ import annotations

import math
import re
from pathlib import Path

import pytest

import chip_smoke
from poreover_tpu_torch.ops import acceptor, beam1d, box_beam, ctc
from poreover_tpu_torch.ops import pair_beam_batch, viterbi

CSRC = Path(__file__).resolve().parents[1] / "poreover_tpu_torch" / "csrc"
SOURCES = {"viterbi": (viterbi, "viterbi.cu"),
           "acceptor": (acceptor, "acceptor.cu"),
           "ctc": (ctc, "ctc.cu"),
           "beam1d": (beam1d, "beam1d.cu"),
           "pair_beam_batch": (pair_beam_batch, "pair_search.cuh"),
           "box_beam": (box_beam, "pair_search.cuh")}
LAT = dict(add=4.0, max=4.5, shfl_max=27.0, warp_rt=31.0, cta_rt=58.0)


def enum_of(source: str) -> list[str]:
    text = (CSRC / source).read_text()
    m = re.search(r"#ifdef POREOVER_PHASE_CLOCKS\s*enum \{([^}]*)\};", text)
    return [n.strip() for n in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_clock_parts_match_the_kernel(name):
    """Each part's phases in the enum's order, then a count per part (of
    steps or rows), CK_N the module's slot count."""
    mod, source = SOURCES[name]
    names = enum_of(source)
    assert names[-1] == "CK_N"
    assert len(names) - 1 == mod.CLOCK_SLOTS
    phases = [ph for _, phs, _ in mod.CLOCK_PARTS for ph in phs]
    assert len(phases) + len(mod.CLOCK_PARTS) <= mod.CLOCK_SLOTS
    for slot, ph in zip(names, phases):
        assert slot.endswith("_" + ph.upper()), (slot, ph)
    counts = names[len(phases):len(phases) + len(mod.CLOCK_PARTS)]
    assert all(n.endswith(("STEPS", "ROWS")) for n in counts), counts


def test_every_kernel_takes_the_shared_clocks():
    """The sources define no clock macros of their own: common.cuh's."""
    for _, source in SOURCES.values():
        text = (CSRC / source).read_text()
        assert "#define CLK_INIT" not in text and "#define CLK(" not in text
        assert "poreover::phase_clocks_copy(" in text
    assert "#define CLK_INIT" in (CSRC / "common.cuh").read_text()


def test_clock_parts_reads_each_part_per_unit():
    c = [10.0 * (i + 1) for i in range(viterbi.CLOCK_SLOTS)]
    c[9] = 0  # the pointer pass counted nothing: divided by 1
    parts = chip_smoke.clock_parts(viterbi, c)
    assert list(parts) == ["forward", "pointers", "traceback"]
    assert parts["forward"]["count"] == c[8]
    assert parts["forward"]["bcast"] == c[0] / c[8]
    assert parts["forward"]["load"] == c[3] / c[8]
    assert parts["pointers"] == dict(pointers=c[4], total=c[4], count=0)
    tb = parts["traceback"]
    assert [tb[p] for p in ("maps", "compose", "fill")] == [
        c[k] / c[10] for k in (5, 6, 7)]
    assert tb["total"] == pytest.approx(sum(c[5:8]) / c[10])


@pytest.mark.parametrize("S", range(1, 9))
def test_viterbi_floor_is_the_broadcast_two_adds_and_the_tree(S):
    want = LAT["warp_rt"] + 2 * LAT["add"] + {
        1: 0, 2: 1, 3: 2, 4: 2, 5: 3, 6: 3, 7: 3, 8: 3}[S] * LAT["max"]
    assert chip_smoke.viterbi_floor_cycles(LAT, S) == pytest.approx(want)


@pytest.mark.parametrize("W,levels", [(2, 1), (32, 5), (33, 6), (2002, 11),
                                      (2048, 11)])
def test_acceptor_floor_is_a_barrier_three_adds_and_the_scan(W, levels):
    """ceil(log2 W) scan levels, the first five across a warp's lanes."""
    assert math.ceil(math.log2(W)) == levels
    across = min(levels, 5)
    want = (LAT["cta_rt"] + 3 * LAT["add"] + across * LAT["shfl_max"]
            + (levels - across) * LAT["max"])
    assert chip_smoke.acceptor_floor_cycles(LAT, W) == pytest.approx(want)
