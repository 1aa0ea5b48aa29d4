"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources compile with `nvcc` for `sm_90a`, one `nvcc -c` per source,
all started together, and link into one shared library with a plain C
interface, loaded with ctypes.  The library goes into
`trafficsimulation_tpu_torch/_build/`, named by a hash of the sources
and flags, and is built at first use: `load()` on a machine without a
build compiles it (a few seconds), later calls reuse it.  nvcc's output
(`-Xptxas=-v`: registers, stack and spills of each kernel) is kept
beside it as `libtsim_<hash>.log`.

`-fmad=false` keeps nvcc from contracting f32 multiply-adds inside the
kernels, so their float compares see the values the plain versions
compute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib = None
build_seconds = None      # wall time of the last build (None: reused)
build_log = ""            # nvcc's output of the library's build (ptxas -v)
library_path = None       # the loaded library's file

P = ctypes.c_void_p
I = ctypes.c_int
_ARGTYPES = {
    # ip[16], fp[2], sdir4, D4, wnd, pa..pe, pl, stop, rain, ped, inter,
    # dest_id, r_mal, r_side, r_reroll, r_prio, out pa..pe, out pl,
    # flags, scratch, B, H, W, inter and dest_id per world (0/1), stream
    "tsim_decide_move": [P, P, P, I, P] + [P] * 6 + [P] * 4 + [P]
    + [P] * 4 + [P] * 6 + [P, P, I, I, I, I, P],
    # the same arguments: K1's block-per-world form
    "tsim_decide_move_worlds": [P, P, P, I, P] + [P] * 6 + [P] * 4 + [P]
    + [P] * 4 + [P] * 6 + [P, P, I, I, I, I, P],
    # B, H, W, out[4]: K1's cooperative plan for B worlds on this card
    # (tiles a block, blocks, worlds a group, groups)
    "tsim_dm_plan": [I, I, I, P],
    # H, W, out[5]: the block-per-world form's plan (tiles a block, dynamic
    # and static shared memory bytes, registers, resident blocks an SM)
    "tsim_dm_worlds_plan": [I, I, P],
    # out[2]: the card's SMs and the shared memory a block may take
    "tsim_card_numbers": [P],
    # ip[16], fp[2], hier constants[10], the planes' first world row,
    # local4, LD4, then the arguments of tsim_decide_move from sdir4 to
    # scratch, H, W, stream
    "tsim_decide_move_hier": [P, P, P, I, P, I, P, I, P] + [P] * 6 + [P] * 4
    + [P] + [P] * 4 + [P] * 6 + [P, P, I, I, P],
    # the arguments of tsim_decide_move up to the out planes, then flags,
    # the windows' work area, H, W, th, tw, halo, stream
    "tsim_decide_tiled": [P, P, P, I, P] + [P] * 6 + [P] * 4 + [P]
    + [P] * 4 + [P] * 6 + [P] * 2 + [I] * 5 + [P],
    # th, tw, halo, out[5]: K7's plan (tiles a block, dynamic and static
    # shared memory bytes, registers, resident blocks an SM)
    "tsim_decide_tiled_plan": [I, I, I, P],
    # colour table, cell, stop, rain, vehicle classes, out, HW, the light
    # and controlled-road codes, the vector path (0/1), stream
    "tsim_render_planes": [P] * 6 + [I] * 4 + [P],
    # K0, pen4, legal4, out, D, HW, tp2, B, K0 and legal4 per world (0/1),
    # stream
    "tsim_build_sdir": [P, P, P, P, I, I, I, I, I, I, P],
    # K0, pen4b, legal4, out, D, HW, tp2, B, stream
    "tsim_build_sdir_batched": [P, P, P, P, I, I, I, I, P],
    # allowed, road, hard, out, k_ovt, B, H, W, geometry per world (0/1),
    # stream
    "tsim_build_wavefront": [P, P, P, P, I, I, I, I, I, P],
    # occ, outh, outv, B, H, W, stream
    "tsim_prefix_planes": [P, P, P, I, I, I, P],
    # base, idx, vals, out, work area (or null), R, T, n, stream
    "tsim_ordered_add": [P, P, P, P, P, I, I, I, P],
    # sdir4, dest, out, D4, HW, stream
    "tsim_select_rows": [P, P, P, I, I, P],
    # clouds, active, cooldown, spawn, want_cd, out seen, seen_a,
    # cooldown, B, n, R, cool, stream
    "tsim_rain_ticks": [P] * 8 + [I] * 4 + [P],
    # walk, cross, cell, stop, seeds, n_side, out walk, cross, block,
    # count, B, H, W, cell and n_side per world (0/1), lam, spawn, the
    # planes' first world row, stream
    "tsim_step_pedestrians": [P] * 10 + [I] * 4 + [ctypes.c_float, I, I,
                                                   P],
    # ip[34], fp[7], pointer table, the inputs' world strides (long), the
    # table's length, B, form, blocks, tiles a block, worlds a group,
    # stream
    "tsim_mega_segment": [P, P, P, P, I, I, I, I, I, I, P],
    # B, H, W, form (-1: by shape), out[10]: K9's plan on this card
    "tsim_mega_plan": [I, I, I, I, P],
    # out: K9's grid barriers since the last call
    "tsim_mega_syncs": [P],
}


def sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load():
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log, library_path
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"libtsim_{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu, _ = sources()
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, o in zip(cu, objs)]
        logs = [f"== {src.name}\n{p.communicate()[0]}"
                for src, p in zip(cu, procs)]
        failed = [src.name for src, p in zip(cu, procs) if p.returncode]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            logs.append(f"== link\n{res.stdout}{res.stderr}")
            if res.returncode:
                failed.append("link")
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               f"{build_log}")
        so.with_suffix(".log").write_text(build_log)
        os.replace(tmp, so)
    elif so.with_suffix(".log").exists():
        build_log = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    library_path = so
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tsim_ordered_add_work.argtypes = [I, I]
    lib.tsim_ordered_add_work.restype = ctypes.c_long
    lib.tsim_error_string.argtypes = [I]
    lib.tsim_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(rc: int) -> str:
    return load().tsim_error_string(rc).decode()
