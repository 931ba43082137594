"""Command-line interface.

The five subcommands and the flag surface of ``poreover_tpu/cli.py`` (the
reference CLI, poreover/__main__.py:19-99), plus ``--device`` on
``train``, ``call``, ``pair-decode`` and ``decode``. ``train`` trains a
network (the CTC loss in the kernels of ``csrc/ctc.cu``), ``call`` runs
it (and, with ``--decode``, the fused decode), ``pair-decode`` decodes
pairs of all three model kinds with every flag of the JAX package
(``--method envelope|split|align``, ``--algorithm beam|prefix``, every
``--beam_search_method``, ``--single viterbi|beam``, ``--skip_matches``,
``--exact``, ``--f64``), ``decode`` all three model kinds (Viterbi, beam
and prefix search) and ``benchmark`` scores FASTA / FASTQ against a
reference on the host.
"""
from __future__ import annotations

import argparse
import logging
import sys

from . import __version__


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="poreover-tpu-torch",
        description="PoreOver on PyTorch/CUDA: Consensus Basecalling for Nanopore Sequencing on an NVIDIA GPU",
    )
    subparsers = parser.add_subparsers(dest="command")
    subparsers.required = True

    # ---- train ----
    p_train = subparsers.add_parser(
        "train",
        help="Train a neural network base calling model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p_train.set_defaults(func=_train)
    p_train.add_argument("--data", required=True, help="Training data (.npz)")
    p_train.add_argument("--name", default="run", help="Name of run")
    p_train.add_argument("--epochs", type=int, default=1)
    p_train.add_argument("--save_every", type=int, default=1000)
    p_train.add_argument("--holdout", type=float, default=0.05)
    p_train.add_argument("--loss_every", type=int, default=100)
    p_train.add_argument("--ctc_merge_repeated", action="store_true", default=False)
    p_train.add_argument(
        "--model",
        default="conv1_bigru3",
        choices=["bigru3", "conv1_bigru3", "conv2_bigru3", "conv1_gru5"],
    )
    p_train.add_argument("--restart", default=False)
    p_train.add_argument("--batch_size", type=int, default=64)
    p_train.add_argument("--learning_rate", type=float, default=0.001)
    p_train.add_argument("--seed", type=int, default=None)
    p_train.add_argument("--num_neurons", type=int, default=128)
    p_train.add_argument("--kernel_size", type=int, default=9)
    p_train.add_argument("--filters", type=int, default=256)
    p_train.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the training step runs: on the card (the CTC loss in "
        "the CUDA kernels), or its plain PyTorch version on the CPU")

    # ---- call ----
    p_call = subparsers.add_parser(
        "call",
        help="Run basecalling forward pass on set of FAST5 reads",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p_call.set_defaults(func=_call)
    p_call.add_argument("in", help="Single FAST5 file or directory of FAST5 files")
    p_call.add_argument("--weights", default=None)
    p_call.add_argument("--model", default=None, help="Model config JSON file")
    p_call.add_argument(
        "--scaling",
        default="standard",
        choices=["standard", "current", "median", "rescale"],
    )
    p_call.add_argument("--use_id", default=False, action="store_true")
    p_call.add_argument("--dir", default=".")
    p_call.add_argument("--window", type=int, default=1000)
    p_call.add_argument("--format", choices=["csv", "npy"], default="npy")
    p_call.add_argument("--no_stack", default=False, action="store_true")
    # TPU-first extension (not in the reference): fuse the network forward
    # with viterbi decode in one device program — signal in, FASTA out,
    # no [T,5] probability matrix ever crossing the host/device boundary
    p_call.add_argument(
        "--decode", choices=["viterbi", "beam"], default=None,
        help="fuse basecall+decode on device; write FASTA instead of probs")
    p_call.add_argument("--beam_width", type=int, default=25,
                        help="beam width for --decode beam")
    p_call.add_argument("--out", default=None,
                        help="output FASTA prefix for --decode")
    p_call.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the network (and a fused decode) runs: on the card, or "
        "on the CPU")

    # ---- decode ----
    p_dec = subparsers.add_parser(
        "decode", help="Decode basecaller probabilities to a FASTA file"
    )
    p_dec.set_defaults(func=_decode)
    p_dec.add_argument("in", nargs="+")
    p_dec.add_argument("--out", default="out")
    p_dec.add_argument(
        "--basecaller", choices=["poreover", "flappie", "guppy", "bonito"]
    )
    p_dec.add_argument(
        "--algorithm", default="viterbi", choices=["viterbi", "beam", "prefix"]
    )
    p_dec.add_argument("--window", type=int, default=400)
    p_dec.add_argument("--beam_width", type=int, default=25)
    p_dec.add_argument("--threads", type=int, default=1)
    p_dec.add_argument("--logging", default="info", choices=["info", "debug"])
    p_dec.add_argument(
        "--profile", default=None, metavar="DIR",
        help="dump a torch.profiler trace of the run to DIR",
    )
    p_dec.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the decoders run: on the card (beam search in the CUDA "
        "kernel), or their plain PyTorch versions on the CPU")

    # ---- pair-decode ----
    p_pair = subparsers.add_parser(
        "pair-decode",
        help="1D2 consensus decoding of two output probabilities",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p_pair.set_defaults(func=_pair_decode)
    p_pair.add_argument("in", nargs="+")
    p_pair.add_argument("--dir", default=".")
    p_pair.add_argument(
        "--basecaller", choices=["poreover", "flappie", "guppy", "bonito"]
    )
    p_pair.add_argument("--reverse_complement", default=False, action="store_true")
    p_pair.add_argument("--out", default="out")
    p_pair.add_argument("--threads", type=int, default=1)
    p_pair.add_argument(
        "--method",
        choices=["align", "split", "envelope"],
        default="envelope",
        help=argparse.SUPPRESS,
    )
    p_pair.add_argument("--single", choices=["beam", "viterbi"], default="viterbi")
    p_pair.add_argument("--logging", default="info", choices=["info", "debug"])
    p_pair.add_argument(
        "--profile", default=None, metavar="DIR",
        help="dump a torch.profiler trace of the run to DIR",
    )
    p_pair.add_argument("--debug", default=False, action="store_true")
    p_pair.add_argument(
        "--algorithm", default="beam", choices=["prefix", "beam"], help=argparse.SUPPRESS
    )
    p_pair.add_argument("--alignment", default="banded", choices=["banded", "full"])
    p_pair.add_argument("--beam_width", type=int, default=5)
    p_pair.add_argument("--debug_envelope", action="store_true", help=argparse.SUPPRESS)
    p_pair.add_argument("--diagonal_envelope", action="store_true")
    p_pair.add_argument("--diagonal_width", type=int, default=50)
    p_pair.add_argument("--padding", type=int, default=5)
    p_pair.add_argument("--skip_matches", action="store_true")
    p_pair.add_argument("--skip_threshold", type=int, default=10)
    p_pair.add_argument(
        "--exact", action="store_true",
        help="reference-exact consensus: the unbounded-memo trie's "
        "semantics, through the pair kernel's graveyard instance (evicted "
        "candidates kept for 20 prunes; slower; see docs/EXACTNESS.md); "
        "anchored boxes (--skip_matches) take it too")
    p_pair.add_argument(
        "--f64", action="store_true",
        help="run the pipeline in float64 on the CPU: the plain PyTorch "
        "versions of the kernels (this sets --device cpu) — a precision "
        "probe for near-tie positions (docs/EXACTNESS.md f32 section; not "
        "sufficient for byte-parity at true ties, use --exact for that); "
        "the flip-flop Viterbi DP stays float32")
    p_pair.add_argument(
        "--beam_search_method",
        choices=["row", "row_col", "grid"],
        default="row_col",
        help=argparse.SUPPRESS,
    )
    p_pair.add_argument("--window", type=int, default=200, help=argparse.SUPPRESS)
    p_pair.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where stage 4 runs: the CUDA kernel, or its plain PyTorch "
        "version on the CPU")

    # ---- benchmark ----
    p_bench = subparsers.add_parser(
        "benchmark", help="Assess accuracy of basecalled FASTA/FASTQ files"
    )
    p_bench.set_defaults(func=_benchmark)
    p_bench.add_argument("--fasta", default=None)
    p_bench.add_argument("--fasta_pair", default=None)
    p_bench.add_argument("--fastq", default=None)
    p_bench.add_argument("--reference", required=True)
    p_bench.add_argument("--full", action="store_true")

    parser.add_argument("-v", "--version", action="version", version=__version__)
    return parser


def _train(args):
    from .device import resolve_device

    resolve_device(args.device)
    from .network.train import train

    train(args)


def _call(args):
    from .device import resolve_device

    resolve_device(args.device)
    if args.decode:
        from .decoding.fused import call_and_decode

        call_and_decode(args)
        return
    from .network.call import call

    call(args)


def _decode(args):
    from .decoding.decode import decode

    decode(args)


def _benchmark(args):
    from .benchmark import benchmark

    benchmark(args)


def _pair_decode(args):
    if args.f64 and args.device != "cpu":
        # float64 runs the plain versions on the host, as the JAX
        # package's --f64 runs its engines there; asked for, not a fallback
        logging.getLogger("poreover_tpu_torch").info(
            "--f64: running in float64 on the CPU (--device cpu)")
        args.device = "cpu"
    from .device import resolve_device

    resolve_device(args.device)
    from .decoding.pair import pair_decode

    pair_decode(args)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = build_parser()
    args = parser.parse_args(argv)
    level = {"debug": logging.DEBUG, "info": logging.INFO}[
        getattr(args, "logging", "info")
    ]
    logging.getLogger("poreover_tpu_torch").setLevel(level)
    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        # a torch.profiler trace (chrome trace JSON) of the whole run
        import os

        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            args.func(args)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logging.getLogger("poreover_tpu_torch").info(
            "wrote torch profiler trace to %s", path)
    else:
        args.func(args)
    print(args, file=sys.stderr)
