"""Integer issue rate of the card, and the candidate-scoring kernel's place
against it.

    python -m nvbio_tpu_torch.tools.int32_rate [--out FILE]

Needs a CUDA card and the CUDA toolkit (nvcc, cuobjdump). It
  1. builds ``int32_rate.cu`` for sm_90a and times each of its modes (a
     ring of independent IADD, IMNMX, DPX VIADDMNMX, DPX VIMNMX3 or mixed
     add/max updates), counts the SASS instructions of each mode's loop with
     cuobjdump, and reports thread-instructions per SM per clock at the
     card's max SM clock, beside the issue ceiling of 4 schedulers x 32
     lanes = 128 per SM per clock;
  2. reads the SASS of the candidate-scoring kernel
     (``banded_score_cands_kernel<31, true, LOCAL>``: the single-end path's
     SEMI_GLOBAL instantiation and the local path's LOCAL one): the
     instructions per band cell of its packed loop (two cells per thread)
     and its int32 loop, and their opcode mix;
  3. times that kernel at the main path's shapes (B=32768, C=24, L=100,
     W=31) on random windows and reports the thread-instructions per SM per
     clock its packed loop retires;
  4. reads the SASS of the traceback kernel
     (``banded_traceback_kernel<31, R, LOCAL>``, every group size and both
     variants): its forward row loop per band cell and its walk step;
  5. reads the SASS of the wide traceback kernel at the full-matrix band
     W = 230 (``banded_traceback_wide_kernel<8, 230, LOCAL, true>``: 8
     cells a lane, the band compiled in, both variants, the shared-memory
     route): its forward row loop per lane-cell and per band cell, and its
     walk loop;
  6. reads the SASS of the Myers kernel (K4) at the mate-locate shapes:
     the packed-window instantiations at 4 and 5 words
     (``myers_regs_windows_kernel<NW>``, M = 100 and 150): its 16-step
     loop per word-step;
  7. reads the SASS of K3's row loop at W = 31 (``banded_score_kernel`` and
     ``banded_score_windows_kernel``, SEMI_GLOBAL): per band cell;
  8. reads the SASS of K5 (``regtile_score_blocked_kernel<W, 1, 1, 1>``,
     bench.py's flags, W = 31 and 17): per band cell of its packed loop
     (two alignments a thread) and of its int32 loop, and, from its queued
     time at bench.py's GCUPS shape (G = 4096, L = 100; ``k2_time.time_k5``),
     the thread-instructions per SM per clock its packed loop retires.
Prints one JSON object as its last line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.bowtie.params import MapParams

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "build")
ISSUE_LANES_PER_SM_CLOCK = 128   # 4 warp schedulers x 32 threads per clock
MODES = ("iadd", "imnmx", "viaddmax", "vimax3", "mix")
OPS_PER_TRIP = 16 * 8


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_probe() -> str:
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, "libint32_rate.so")
    r = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", out,
                        os.path.join(_HERE, "int32_rate.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    return out


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def _opcode(text: str, modifiers: bool = False) -> str:
    """"@P0 IMNMX.U32 R1, ..." -> "IMNMX" (or "IMNMX.U32")."""
    op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
    return op if modifiers else op.split(".")[0]


def sass_loops(lib: str, func_part: str) -> list[list[str]]:
    """Each loop (the span of a backward BRA) of the one function in ``lib``
    whose mangled name contains ``func_part``, largest first: its opcodes
    with their modifiers."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if func_part in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise RuntimeError(f"{len(funcs)} functions match {func_part}")
    insns = [(int(a, 16), text) for a, text in _INSN.findall(funcs[0])]
    loops = []
    for addr, text in insns:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            loops.append([_opcode(t, True) for a, t in insns
                          if lo <= a <= addr])
    if not loops:
        raise RuntimeError(f"no loop found in {func_part}")
    return sorted(loops, key=len, reverse=True)


def sass_loop(lib: str, func_part: str) -> list[str]:
    """Opcodes (no modifiers) of the largest loop of ``func_part``."""
    return [op.split(".")[0] for op in sass_loops(lib, func_part)[0]]


def _hist(ops: list[str], n: int = 10) -> dict:
    return dict(collections.Counter(op.split(".")[0] for op in ops)
                .most_common(n))


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def probe_rates(sms: int, hz: float) -> dict:
    lib_path = build_probe()
    lib = ctypes.CDLL(lib_path)
    fn = lib.nvbt_int32_rate
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    blocks, iters = sms * 32, 2048
    threads = blocks * 256
    out = torch.empty(threads, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    res = {}
    for mode, name in enumerate(MODES):
        ops = sass_loop(lib_path, f"int32_rate_kernelILi{mode}E")

        def run():
            rc = fn(mode, blocks, iters, 7, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"int32_rate mode {name}: CUDA error {rc}")

        ms = cuda_ms(run)
        per_clk = len(ops) * iters * threads / (ms * 1e-3) / sms / hz
        res[name] = dict(ms=ms, loop_instructions=len(ops),
                         ring_updates=OPS_PER_TRIP,
                         opcodes=dict(collections.Counter(ops).most_common(6)),
                         instructions_per_sm_clock=per_clk)
        print(f"[int32] {name:9s} {ms:8.3f} ms; {len(ops)} SASS per trip "
              f"({OPS_PER_TRIP} updates) {res[name]['opcodes']}; "
              f"{per_clk:.1f} thread-instructions per SM per clock",
              flush=True)
    return res


# rows per trip of K1's packed loop (kU in csrc/banded_score_cands.cu)
K1_ROWS_PER_TRIP = 8


def k1_loops(W: int = 31) -> dict:
    """SASS per band cell of K1's instantiations at W=31 with the
    sequential F, SEMI_GLOBAL (the main path's) and LOCAL (the local
    path's): the packed loop (the one with 16x2 instructions,
    K1_ROWS_PER_TRIP rows a trip, two cells per thread) and the masked
    int32 loop (the largest other loop, one row a trip)."""
    out = {}
    for local in (0, 1):
        loops = sass_loops(os.path.join(K._BUILD, "libbanded_score_cands.so"),
                           f"banded_score_cands_kernelILi{W}ELb1ELb{local}E")
        packed = [lp for lp in loops if any("16x2" in op.lower() for op in lp)]
        plain = [lp for lp in loops if lp not in packed]
        if not packed or not plain:
            raise RuntimeError(f"K1: {len(packed)} packed and {len(plain)} "
                               "int32 loops")
        for name, lp, n in (("packed", packed[0], 2 * K1_ROWS_PER_TRIP * W),
                            ("int32_masked", plain[0], W)):
            key = f"{name}_local" if local else name
            out[key] = dict(loop_instructions=len(lp), cells_per_trip=n,
                            instructions_per_cell=len(lp) / n,
                            loads=sum(op.startswith("LDG") for op in lp),
                            opcodes=_hist(lp, 12))
            print(f"[k1] {key}: {len(lp)} SASS for {n} cells = "
                  f"{len(lp) / n:.2f} per cell; {out[key]['opcodes']}",
                  flush=True)
    return out


def k2_loops(W: int = 31) -> dict:
    """SASS of K2's forward row loops and its walk loop, for each group size
    R and both variants. The kernel has two forward loops, one for windows
    that span every row's band (no length mask; the main path's) and one
    with the mask: the two largest loops without a 16-byte load, the
    spanning one the smaller. The walk loop is the one with the 16-byte
    direction-row load and the 16-byte op store. Per cell: the spanning
    loop over NC = ceil(W/R) cells per lane, and over W/R band cells."""
    lib = os.path.join(K._BUILD, "libbanded_traceback.so")
    out = {}
    for R in K.K2_GROUPS:
        for local in (0, 1):
            loops = sass_loops(lib, f"banded_traceback_kernelILi{W}ELi{R}E"
                                    f"Lb{local}E")
            wide = [lp for lp in loops
                    if any(op.startswith("LDG") and "128" in op for op in lp)]
            walk = [lp for lp in wide
                    if any(op.startswith("STG") and "128" in op for op in lp)]
            fwd = [lp for lp in loops if lp not in wide][:2]
            if len(fwd) < 2 or not walk:
                raise RuntimeError(f"K2 R={R} local={local}: {len(fwd)} "
                                   f"forward loops, {len(walk)} walk loops")
            span, masked = sorted(fwd, key=len)
            step = min(walk, key=len)
            nc = -(-W // R)
            key = f"R{R}{'_local' if local else ''}"
            out[key] = dict(forward_instructions=len(span),
                            masked_forward_instructions=len(masked),
                            cells_per_lane=nc,
                            per_lane_cell=len(span) / nc,
                            per_band_cell=len(span) * R / W,
                            forward_opcodes=_hist(span, 12),
                            walk_instructions=len(step),
                            walk_opcodes=_hist(step))
            print(f"[k2] {key}: forward row {len(span)} SASS for {nc} cells "
                  f"a lane = {len(span) / nc:.2f} per lane-cell, "
                  f"{len(span) * R / W:.2f} per band cell (masked row "
                  f"{len(masked)}); walk step {len(step)}; {_hist(span, 8)}",
                  flush=True)
    return out


def wide_loops(W: int = 230) -> dict:
    """SASS of K2-WIDE's forward row loop and walk loop at band W (compiled
    in), both variants, shared-memory route. The forward row is the
    smallest loop with shuffles and a shared-memory store (a larger span
    with both is the compiler's path for diverged shuffles); the walk loop
    is the smallest with a shared-memory load and a ballot, one trip of
    which takes a run of up to 32 diagonal steps and then one other step."""
    lib = os.path.join(K._BUILD, "libbanded_traceback_wide.so")
    nc = K.wide_cells(W)
    out = {}
    for local in (0, 1):
        loops = sass_loops(lib, f"banded_traceback_wide_kernelILi{nc}E"
                                f"Li{W}ELb{local}ELb1E")
        fwd = [lp for lp in loops
               if any(op.startswith("SHFL") for op in lp)
               and any(op.startswith("STS") for op in lp)]
        walk = [lp for lp in loops
                if any(op.startswith("LDS") for op in lp)
                and any(op.startswith("VOTE") for op in lp)]
        if not fwd or not walk:
            raise RuntimeError(f"K2-WIDE local={local}: {len(fwd)} forward, "
                               f"{len(walk)} walk loops")
        row, step = min(fwd, key=len), min(walk, key=len)
        key = "local" if local else "semiglobal"
        out[key] = dict(forward_instructions=len(row), cells_per_lane=nc,
                        per_lane_cell=len(row) / nc,
                        per_band_cell=len(row) * 32 / W,
                        forward_opcodes=_hist(row, 12),
                        walk_loop_instructions=len(step),
                        walk_opcodes=_hist(step))
        print(f"[wide] {key}: forward row {len(row)} SASS for {nc} cells a "
              f"lane = {len(row) / nc:.2f} per lane-cell, "
              f"{len(row) * 32 / W:.2f} per band cell at W={W}; walk loop "
              f"{len(step)}; {_hist(row, 8)}", flush=True)
    return out


def k4_loops() -> dict:
    """SASS of K4's main loop (16 text steps a trip, one stream word load):
    the largest loop of each instantiation, per word-step (16 x NW a
    trip)."""
    lib = os.path.join(K._BUILD, "libmyers_semiglobal.so")
    out = {}
    for key, part, per_trip in (
            ("regs_nw4", "myers_regs_windows_kernelILi4E", 16 * 4),
            ("regs_nw5", "myers_regs_windows_kernelILi5E", 16 * 5)):
        lp = sass_loops(lib, part)[0]
        out[key] = dict(loop_instructions=len(lp), units_per_trip=per_trip,
                        instructions_per_unit=len(lp) / per_trip,
                        loads=sum(op.startswith("LDG") for op in lp),
                        opcodes=_hist(lp, 12))
        print(f"[k4] {key}: {len(lp)} SASS for {per_trip} word-steps = "
              f"{len(lp) / per_trip:.2f}; {out[key]['opcodes']}", flush=True)
    return out


def k3_loops(W: int = 31) -> dict:
    """SASS per band cell of K3's row loop (the largest loop: one pattern
    row over the W cells of the band), SEMI_GLOBAL, in the contract form
    and the packed-window form."""
    lib = os.path.join(K._BUILD, "libbanded_score.so")
    out = {}
    for key, part in (("rows", f"banded_score_kernelILi{W}ELb0E"),
                      ("windows", f"banded_score_windows_kernelILi{W}ELb0E")):
        lp = sass_loops(lib, part)[0]
        out[key] = dict(loop_instructions=len(lp), cells_per_trip=W,
                        instructions_per_cell=len(lp) / W,
                        opcodes=_hist(lp, 12))
        print(f"[k3] {key}: {len(lp)} SASS for {W} cells = "
              f"{len(lp) / W:.2f} per cell; {out[key]['opcodes']}",
              flush=True)
    return out


def k5_rows_per_trip() -> int:
    """kU of ``csrc/regtile_score_blocked.cu``: rows per trip of K5's packed
    loop."""
    src = os.path.join(os.path.dirname(_HERE), "csrc",
                       "regtile_score_blocked.cu")
    with open(src) as f:
        m = re.search(r"constexpr int kU = (\d+);", f.read())
    if m is None:
        raise RuntimeError(f"no kU in {src}")
    return int(m.group(1))


def k5_loops(sms: int, hz: float) -> dict:
    """SASS per band cell of K5's bench instantiations at W = 31 and 17:
    the packed loop (the one with 16x2 instructions; kU rows a trip, two
    cells per thread) and the int32 loop (the largest other loop, one row a
    trip; the kernel holds two copies, one a half); then, from the queued
    time of ``k2_time.time_k5`` on bench.py's operands, the
    thread-instructions per SM per clock of its packed loop."""
    from nvbio_tpu_torch.tools.k2_time import time_k5

    lib = os.path.join(K._BUILD, "libregtile_score_blocked.so")
    rows = k5_rows_per_trip()
    timed: dict = {}
    time_k5(K, MapParams, timed)
    out = {}
    for W in (31, 17):
        loops = sass_loops(lib, f"regtile_score_blocked_kernelILi{W}ELb1E"
                                f"Lb1ELb1E")
        packed = [lp for lp in loops if any("16x2" in op.lower() for op in lp)]
        plain = [lp for lp in loops if lp not in packed]
        if not packed or not plain:
            raise RuntimeError(f"K5 W={W}: {len(packed)} packed and "
                               f"{len(plain)} int32 loops")
        res = {}
        for name, lp, n in (("packed", packed[0], 2 * rows * W),
                            ("int32", plain[0], W)):
            res[name] = dict(loop_instructions=len(lp), cells_per_trip=n,
                             instructions_per_cell=len(lp) / n,
                             loads=sum(op.startswith("LDG") for op in lp),
                             opcodes=_hist(lp, 12))
            print(f"[k5] W={W} {name}: {len(lp)} SASS for {n} cells = "
                  f"{len(lp) / n:.2f} per cell; {res[name]['opcodes']}",
                  flush=True)
        t = timed[f"k5_w{W}"]
        cells = t["G"] * 1024 * t["L"] * W
        per_clk = (cells * res["packed"]["instructions_per_cell"]
                   / (t["ms_queued"] * 1e-3) / sms / hz)
        res["rate"] = dict(ms_queued=t["ms_queued"], cells=cells,
                           instructions_per_sm_clock=per_clk)
        print(f"[k5] G={t['G']} L={t['L']} W={W}: {t['ms_queued']:.3f} ms "
              f"queued, {cells:.4g} cells, {per_clk:.1f} thread-instructions "
              f"per SM per clock (packed loop)", flush=True)
        out[f"w{W}"] = res
    return out


def k1_rate(sms: int, hz: float, per_cell: float) -> dict:
    """K1 timed at the main path's shapes (B=32768, C=24, L=100, W=31) on
    random windows, all of which take the packed path, and the
    thread-instructions per SM per clock its packed loop retires."""
    B, C, L, W, NCH = 32768, 24, 100, 31, 12
    rng = np.random.default_rng(1)
    n = 4_000_000
    words = torch.from_numpy(rng.integers(
        0, 2**32, size=n // 16, dtype=np.uint32).view(np.int32)).cuda()
    t = lambda a, dt=torch.int32: torch.from_numpy(a).to(dt).cuda()
    reads = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    mm = -(2 + rng.integers(0, 5, size=(B, L))).astype(np.int32)
    w0 = rng.integers(0, n - L - W, size=(B, C))
    args = (t(reads), t(np.ascontiguousarray((3 - reads)[:, ::-1])),
            t(np.full(B, L, np.int32)), t(w0, torch.int64),
            t(np.full((B, C), L + W - 1, np.int32)), words,
            MapParams().scoring, W, NCH, t(mm),
            t(np.ascontiguousarray(mm[:, ::-1])))
    ms = cuda_ms(lambda: K.banded_score_cands(*args), reps=7)
    cells = B * C * L * W
    per_clk = cells * per_cell / (ms * 1e-3) / sms / hz
    print(f"[k1] B={B} C={C} L={L} W={W}: {ms:.3f} ms, {cells:.4g} cells, "
          f"{per_clk:.1f} thread-instructions per SM per clock (packed "
          f"loop)", flush=True)
    return dict(ms=ms, cells=cells, instructions_per_sm_clock=per_clk)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int32_rate: needs a CUDA card")
    card = smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    hz = mhz * 1e6
    print(f"[card] {card}; {sms} SMs, max SM clock {mhz:.0f} MHz; issue "
          f"ceiling {ISSUE_LANES_PER_SM_CLOCK} per SM per clock = "
          f"{sms * ISSUE_LANES_PER_SM_CLOCK * hz:.4g} thread-instructions/s",
          flush=True)
    t0 = time.time()
    rates = probe_rates(sms, hz)
    K.build()
    k1 = k1_loops()
    k1["rate"] = k1_rate(sms, hz, k1["packed"]["instructions_per_cell"])
    k2 = k2_loops()
    wide = wide_loops()
    k4 = k4_loops()
    k3 = k3_loops()
    k5 = k5_loops(sms, hz)
    res = dict(card=card, sms=sms, max_sm_mhz=mhz,
               sm_mhz_after=smi("clocks.sm"),
               issue_ceiling_per_sm_clock=ISSUE_LANES_PER_SM_CLOCK,
               probe=rates, k1=k1, k2=k2, wide=wide, k4=k4, k3=k3, k5=k5,
               seconds=time.time() - t0)
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
