"""Builds the port's shared libraries at first use.

Two libraries, both loaded with ctypes through a plain C interface:

- the C++ host runtime, from ``native/*.cpp`` at the repo root, with
  ``g++`` (see ``native.py``);
- the CUDA kernels, one library per ``poreover_tpu_torch/csrc/*.cu``, with
  ``nvcc`` for ``sm_90a`` (``build_kernel``; see ``ops/pair_beam_batch.py``,
  ``ops/box_beam.py``, ``ops/beam1d.py`` and ``ops/viterbi.py``). They
  share the headers ``csrc/*.cuh`` (``common.cuh``; ``pair_search.cuh``,
  the search both pair kernels run).

Outputs go to ``poreover_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. A library is written under a temporary
name and renamed into place, so concurrent builds never load a
half-written file. A missing compiler or a failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
REPO_DIR = PKG_DIR.parent
BUILD_DIR = PKG_DIR / "_build"


def find_tool(name: str, extra_dirs=()) -> str:
    """Path of a compiler, from PATH or the given directories."""
    found = shutil.which(name)
    if found:
        return found
    for d in extra_dirs:
        cand = Path(d) / name
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(
        f"{name} not found on PATH or in {list(extra_dirs)}; it is needed "
        "to build the port's shared libraries")


def build_shared(stem: str, compiler: str, flags: list[str],
                 sources: list[Path], headers: list[Path] = ()) -> Path:
    """Compile ``sources`` into ``_build/<stem>-<hash>.so``; returns the
    path. Reuses an existing library with the same hash. ``headers`` are
    files the sources include: hashed, not handed to the compiler."""
    h = hashlib.sha256()
    h.update(" ".join([os.path.basename(compiler)] + flags).encode())
    for src in [*sources, *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{stem}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"build of {stem} failed ({' '.join(cmd)}):\n{proc.stderr}")
    # the compiler's own report (e.g. ptxas registers / spills) beside it
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
CSRC_DIR = PKG_DIR / "csrc"


def build_kernel(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Build ``csrc/<name>.cu`` (with the headers ``csrc/*.cuh``) into
    ``_build/lib<name>-<hash>.so`` with nvcc for sm_90a, no fast math.
    ``defines`` are macros passed as ``-D``; they enter the hash and the
    library's name (``lib<name>_<macro>-<hash>.so``), so an instrumented
    build never replaces the normal one."""
    nvcc = find_tool("nvcc", ["/usr/local/cuda/bin"])
    stem = f"lib{name}" + "".join(f"_{d.lower()}" for d in defines)
    return build_shared(stem, nvcc, NVCC_FLAGS + [f"-D{d}" for d in defines],
                        [CSRC_DIR / f"{name}.cu"],
                        headers=sorted(CSRC_DIR.glob("*.cuh")))


def ptxas_report(name: str) -> list[str]:
    """The entry function / register / shared memory / spill lines ptxas
    printed when ``csrc/<name>.cu`` was built (the newest log of that
    kernel in ``_build/``); each kernel's (template instance's) lines
    follow its mangled name."""
    logs = sorted(BUILD_DIR.glob(f"lib{name}-*.log"),
                  key=lambda p: p.stat().st_mtime)
    if not logs:
        return []
    return [ln.strip() for ln in logs[-1].read_text().splitlines()
            if "registers" in ln or "spill" in ln
            or "Compiling entry function" in ln]
