"""The port's CUDA kernels, their wrappers and their plain versions.

Each replaces a TPU kernel of ``nvbio_tpu/align/pallas_kernels.py``:
``banded_score_cands`` (K1) ``banded_score_cands_regtile`` (:963), and
with ``local=True`` the local candidates that the JAX package scores with
``banded_score_semiglobal_pallas(local=True)`` (:133) over extracted
windows;
``banded_traceback`` (K2, and K2-LOCAL with ``local=True``)
``banded_traceback_semiglobal_pallas`` (:568); ``banded_traceback_wide``
(K2-WIDE, K2-WIDE-LOCAL) the same TPU kernel at the band T+M of the
full-matrix traceback; ``banded_score`` (K3, and K3-LOCAL)
``banded_score_semiglobal_pallas`` (:133); ``myers_semiglobal`` (K4)
``myers_semiglobal_pallas`` (:1132); ``regtile_score_blocked`` (K5) the
TPU function of that name (:839). Sources: ``nvbio_tpu_torch/csrc/*.cu``, built
with nvcc for ``sm_90a`` at first use into ``csrc/build/`` (gitignored) —
one shared library per source, all compiled in parallel — and bound with
ctypes (a plain C interface; no PyTorch headers, so a build takes seconds).
The banded kernels hold the bands of ``SUPPORTED_BANDS``; any other band
builds a library of its own at its first use (``lib<name>_w<W>.so``).
K4 and K3 each have a second entry that reads its texts straight from the
packed genome (``myers_semiglobal_windows``, ``banded_score_windows``).
``fm_search.cu`` (no TPU kernel: the JAX package's FM walks are jnp scans)
holds the FM-index walks, launched by ``fm_backward_search``,
``fm_locate`` and ``fm_search_1mm_topk`` for CUDA tensors only: their
plain versions, and the routing to them, are ``fmi/search.py``'s.
``vote_reps.cu`` (no TPU kernel either: the JAX package's dedup vote is
jnp) holds the mapper's dedup vote, launched by ``vote_reps``, one warp a
row.

Each wrapper checks device, dtype, shape and contiguity, allocates outputs
and scratch with ``torch.empty``, launches on the current stream, raises if
the launch failed, and counts its launches in ``<wrapper>.launches``. For
CPU tensors it returns its plain torch version instead — the CPU tests run
that; for CUDA tensors it launches the kernel or raises. Nothing falls back.

Beside each wrapper is its plain version with the same contract; the plain
versions repeat the TPU kernels' arithmetic exactly, edge values included.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from nvbio_tpu_torch.align.types import NEG_INF, GotohScoring
from nvbio_tpu_torch.packed import extract_window

# band widths built ahead of time, in the libraries of the sources: 31 is
# the default max_dist=15, 17 is --mode ed (max_dist 8); the small ones serve
# the tests and checks. Any other band W of K1, K2, K3 and K5 compiles
# lib<name>_w<W>.so (the source with -DNVBT_EXTRA_BAND=W, that band alone)
# at its first use, or ahead of it with ``build(bands=...)``.
SUPPORTED_BANDS = (7, 9, 11, 17, 31)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
_SOURCES = {
    "banded_score_cands": "banded_score_cands.cu",
    "banded_traceback": "banded_traceback.cu",
    "banded_score": "banded_score.cu",
    "myers_semiglobal": "myers_semiglobal.cu",
    "banded_traceback_wide": "banded_traceback_wide.cu",
    "regtile_score_blocked": "regtile_score_blocked.cu",
    "fm_search": "fm_search.cu",
    "vote_reps": "vote_reps.cu",
}
# the sources compiled once for each band
_BANDED = ("banded_score_cands", "banded_traceback", "banded_score",
           "regtile_score_blocked")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str, band: int | None) -> tuple[str, tuple[str, ...]]:
    """The library key of source ``name`` built for ``band`` (None: the
    library of its precompiled instantiations) and its extra nvcc flags."""
    if band is None:
        return name, ()
    flags = (f"-DNVBT_EXTRA_BAND={band}",)
    if name == "banded_traceback_wide":
        flags += (f"-DNVBT_EXTRA_NC={wide_cells(band)}",)
    return f"{name}_w{band}", flags


def build(bands=()) -> dict:
    """Compile every kernel source, and K1, K2, K3 and K5 once more for
    each band of ``bands`` outside ``SUPPORTED_BANDS``, where the source
    (or a header) or the flags changed — all in parallel, one nvcc each —
    and load them. Returns {library key: {"seconds", "cached", "ptxas"}}
    (key: the source's name, ``<name>_w<W>`` for a band's own library):
    ptxas's -v report (registers, spills), kept beside the library so a
    cached build still gives it."""
    return _build([(n, None) for n in _SOURCES]
                  + [(n, W) for W in bands if W not in SUPPORTED_BANDS
                     for n in _BANDED])


def _build(targets) -> dict:
    with _LOCK:
        os.makedirs(_BUILD, exist_ok=True)
        headers = b"".join(
            open(os.path.join(_CSRC, h), "rb").read()
            for h in sorted(os.listdir(_CSRC)) if h.endswith(".cuh"))
        pending, info = {}, {}
        for name, band in targets:
            key, extra = _target(name, band)
            flags = (*NVCC_FLAGS, *extra)
            path = os.path.join(_CSRC, _SOURCES[name])
            with open(path, "rb") as f:
                digest = hashlib.sha256(
                    f.read() + headers + " ".join(flags).encode()).hexdigest()
            out = os.path.join(_BUILD, f"lib{key}.so")
            stamp = out + ".sha"
            if all(os.path.exists(x) for x in (out, stamp, out + ".ptxas")):
                with open(stamp) as f:
                    if f.read().strip() == digest:
                        with open(out + ".ptxas") as f:
                            info[key] = {"seconds": 0.0, "cached": True,
                                         "ptxas": f.read()}
                        continue
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", tmp, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            pending[key] = (proc, tmp, out, stamp, digest, time.time())
        for key, (proc, tmp, out, stamp, digest, t0) in pending.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{log}")
            os.replace(tmp, out)
            with open(out + ".ptxas", "w") as f:
                f.write(log)
            with open(stamp, "w") as f:
                f.write(digest)
            info[key] = {"seconds": time.time() - t0, "cached": False,
                         "ptxas": log}
        for name, band in targets:
            key, _ = _target(name, band)
            if key not in _LIBS:
                _LIBS[key] = _bind(name, ctypes.CDLL(
                    os.path.join(_BUILD, f"lib{key}.so")))
        return info


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "banded_score_cands":
        fn = lib.nvbt_banded_score_cands
        fn.argtypes = [P] * 8 + [L] + [I] * 12 + [P, P, P]
    elif name == "banded_traceback":
        fn = lib.nvbt_banded_traceback
        fn.argtypes = [P] * 5 + [I] * 12 + [P, P, P]
    elif name == "banded_score":
        fn = lib.nvbt_banded_score
        fn.argtypes = [P] * 5 + [I] * 11 + [P, P, P]
        fn.restype = ctypes.c_int
        fn = lib.nvbt_banded_score_windows
        fn.argtypes = [P] * 3 + [L] + [P] * 3 + [I] * 10 + [P, P, P]
    elif name == "banded_traceback_wide":
        fn = lib.nvbt_banded_traceback_wide
        fn.argtypes = [P] * 5 + [I] * 13 + [P, P, P]
    elif name == "regtile_score_blocked":
        fn = lib.nvbt_regtile_score_blocked
        fn.argtypes = [P] * 5 + [I] * 12 + [P] * 4
    elif name == "fm_search":
        lib.nvbt_fm_backward_search.argtypes = \
            [P, I, P, I, L, P, L, P, L, L, P, P, I, I] + [P] * 4
        lib.nvbt_fm_locate.argtypes = \
            [P, L, P, L, P, L, L, P, L, P, L, I] + [P] * 4
        fn = lib.nvbt_fm_search_1mm_topk
        fn.argtypes = [P, I, P, I, L, P, L, P, L, L, I, I] + [P] * 7
        lib.nvbt_fm_backward_search.restype = ctypes.c_int
        lib.nvbt_fm_locate.restype = ctypes.c_int
    elif name == "vote_reps":
        fn = lib.nvbt_vote_reps
        fn.argtypes = [P, P, L, I, L, I] + [P] * 4
    else:
        fn = lib.nvbt_myers_semiglobal
        fn.argtypes = [P] * 4 + [I] * 4 + [P] * 4
        fn.restype = ctypes.c_int
        fn = lib.nvbt_myers_semiglobal_windows
        fn.argtypes = [P] * 3 + [L] + [P] * 2 + [I] * 3 + [P] * 4
    fn.restype = ctypes.c_int
    return lib


def _lib(name: str, band: int | None = None) -> ctypes.CDLL:
    """The library of source ``name`` that holds ``band`` (None: a source
    without bands), built at first use."""
    if name == "banded_traceback_wide":
        band = None if band is None or band <= WIDE_MAX_BAND else band
    elif band in SUPPORTED_BANDS:
        band = None
    key, _ = _target(name, band)
    if key not in _LIBS:
        if band is None:
            build()
        else:
            _build([(name, band)])
    return _LIBS[key]


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _gaps(scoring: GotohScoring):
    return (scoring.match, scoring.pattern_gap_open, scoring.pattern_gap_ext,
            scoring.text_gap_open, scoring.text_gap_ext)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_texts(texts: torch.Tensor, B: int, device):
    if texts.device != device or texts.dtype != torch.int32 \
            or texts.dim() != 2 or texts.shape[0] != B:
        raise ValueError("texts must be a (B, T) int32 tensor on "
                         f"{device}; got {tuple(texts.shape)} {texts.dtype} "
                         f"on {texts.device}")


def _raise_if_failed(rc: int, name: str, W: int):
    if rc == -1:
        raise ValueError(f"{name}: width {W} has no compiled instantiation")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# K1: candidate scoring
# ---------------------------------------------------------------------------

# K1's packed path scores two candidates in the 16-bit halves of a register
# with NEG_INF replaced by NEG16; every finite value it meets stays within
# +-K1_PACKED_RANGE, so each comparison falls as in int32.
K1_NEG16 = -(1 << 14)
K1_PACKED_RANGE = 1 << 13


def k1_packed_limit(scoring: GotohScoring, band: int) -> int:
    """The packed path's guard: a read's pair of fast candidates (window
    spanning every row's band) keeps its 16-bit result when S, a sum over
    the rows scored, is at most this limit and so is every row's largest
    magnitude max(|mismatch_r|, |match|), which must also be at most 127
    (the per-row substitution table holds int8). -1 where no read can pass:
    positive gap scores or |match| > 127.

    SEMI_GLOBAL: S sums max(|mismatch_r|, |match|). On a fast candidate H
    after i rows lies in [-S_i, S_i]; E, F, the gap arms and the lazy F's
    H0 + to - te*k stay within S + |po| + |pe| + |to| + band*|te| of 0;
    NEG16 and the values made from it reset every row.

    LOCAL (``local=True``): S sums max(match, mismatch_r, 0), the most a
    row can add. Every H is floored at 0, so after i rows H lies in [0,
    S_i]; a diagonal H + sub is at least -max|mismatch_r|; E >= po and the
    F arms >= to + band*te are built from H >= 0; the unfloored H0 the
    kernel feeds to F is at least the diagonal. So every finite value lies
    within max(S, max|mismatch_r|) + |po| + |pe| + |to| + band*|te| of 0,
    and NEG16 - band*|te| stays below all of them.

    In both the kernel keeps S and the largest magnitude as it loads the
    penalties; a pair over the limit is rescored in int32."""
    match, po, pe, to, te = _gaps(scoring)
    if max(po, pe, to, te) > 0 or abs(match) > 127:
        return -1
    lim = K1_PACKED_RANGE - (-po - pe - to - band * te)
    return lim if lim >= 0 else -1


def banded_score_cands(reads, rc, lens, w0, wlens, genome_words,
                       scoring: GotohScoring, band: int, nch: int,
                       mm=None, mm_rc=None, local: bool = False):
    """SEMI_GLOBAL (or, ``local=True``, LOCAL) banded Gotoh score and
    first-max band index of every (read b, candidate slot c) pair.

    reads/rc/mm/mm_rc: (B, L) int32 (``mm`` = per-position mismatch scores,
    negative; None = ``scoring.mismatch``); lens: (B,) int32; w0: (B, C)
    int64 window starts; wlens: (B, C) int32 window lengths; genome_words:
    int32 tensor of the packed genome's uint32 bits. Slots c >= ``nch``
    score the reverse complement ``rc``. Returns (score, kbest), (B, C)
    int32 — the TPU kernel's slot-major (C*B) order is a TPU layout. The
    kernel scores pairs of slots in 16-bit halves where
    ``k1_packed_limit`` proves that exact, in int32 otherwise; the result
    is the same. LOCAL is ``banded_score``'s LOCAL function on the windows
    that ``extract_window`` cuts at ``w0`` (H floored at 0, the best cell
    with i <= plen and i-1+k < wlen): the local candidates of
    ``read_candidates`` with no (B*C, .) operand built.
    """
    if reads.device.type == "cpu":
        return banded_score_cands_plain(reads, rc, lens, w0, wlens,
                                        genome_words, scoring, band, nch,
                                        mm, mm_rc, local)
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    B, L = reads.shape
    C = w0.shape[1]
    dev = reads.device
    if mm is None:
        mm = torch.full((B, L), scoring.mismatch, dtype=torch.int32,
                        device=dev)
        mm_rc = mm
    for t, what in ((reads, "reads"), (rc, "rc"), (mm, "mm"),
                    (mm_rc, "mm_rc")):
        _check(t, what, torch.int32, (B, L), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w0, "w0", torch.int64, (B, C), dev)
    _check(wlens, "wlens", torch.int32, (B, C), dev)
    if genome_words.dim() != 1:
        raise ValueError("genome_words must be 1-D")
    _check(genome_words, "genome_words", torch.int32, genome_words.shape, dev)
    if not 0 <= nch <= C:
        raise ValueError(f"nch {nch} outside [0, {C}]")
    score = torch.empty((B, C), dtype=torch.int32, device=dev)
    kbest = torch.empty((B, C), dtype=torch.int32, device=dev)
    rc_code = _lib("banded_score_cands", band).nvbt_banded_score_cands(
        reads.data_ptr(), rc.data_ptr(), mm.data_ptr(), mm_rc.data_ptr(),
        lens.data_ptr(), w0.data_ptr(), wlens.data_ptr(),
        genome_words.data_ptr(), genome_words.shape[0], B, C, nch, L, band,
        *_gaps(scoring), k1_packed_limit(scoring, band), int(local),
        score.data_ptr(), kbest.data_ptr(), _stream(dev))
    _raise_if_failed(rc_code, "banded_score_cands", band)
    banded_score_cands.launches += 1
    return score, kbest


banded_score_cands.launches = 0


def banded_score_cands_plain(reads, rc, lens, w0, wlens, genome_words,
                             scoring: GotohScoring, band: int, nch: int,
                             mm=None, mm_rc=None, local: bool = False):
    """Plain torch version of ``banded_score_cands`` (same contract).

    Repeats ``_regtile_cand_kernel``'s arithmetic (pallas_kernels.py:
    909-958) over the (B*C) candidate rows (``_regtile_plain``), with the
    sequential F when te >= to, as the kernel takes it. LOCAL: the local
    branch as it was built before the kernel took it over, windows from
    ``extract_window`` and ``banded_score_plain(local=True)`` (K3-LOCAL's
    plain version) over the flattened slots.
    """
    B, L = reads.shape
    C = w0.shape[1]
    W = band
    dev = reads.device
    is_rc = (torch.arange(C, device=dev) >= nch)[None, :, None]
    pat = torch.where(is_rc, rc[:, None, :], reads[:, None, :])
    pat = pat.reshape(B * C, L).to(torch.int32)
    if mm is None:
        mmv = torch.full((B * C, L), scoring.mismatch, dtype=torch.int32,
                         device=dev)
    else:
        mmv = torch.where(is_rc, mm_rc[:, None, :], mm[:, None, :])
        mmv = mmv.reshape(B * C, L).to(torch.int32)
    plen = lens.to(torch.int32)[:, None].expand(B, C).reshape(B * C)
    tlen = wlens.to(torch.int32).reshape(B * C)
    if local:
        text = extract_window(genome_words, w0.reshape(B * C), L + W - 1, 2)
        smax, kb = banded_score_plain(pat, plen, text, tlen, scoring, W,
                                      mmv, local=True)
        return smax.reshape(B, C), kb.reshape(B, C)
    text = extract_window(genome_words, w0.reshape(B * C), L + W, 2)

    smax, kb = _regtile_plain(
        pat, mmv, text, plen, tlen, scoring, W, L,
        seq_f=scoring.text_gap_ext >= scoring.text_gap_open)
    return smax.reshape(B, C), kb.reshape(B, C)


def _regtile_plain(pat, mmv, text, plen, tlen, scoring: GotohScoring, W: int,
                   L: int, seq_f: bool, full_text: bool = False,
                   uniform_plen: bool = False):
    """The register-tiled scorers' recurrence (``_regtile_kernel``,
    pallas_kernels.py:723-787, and its candidate twin :909-958) over an
    (N, W) band plane per pattern row: patterns and penalties (N, >= L),
    texts (N, >= L+W-1), lengths (N,). Returns (score, kbest), (N,) int32.

    ``seq_f``: the sequential F[k] = max(F[k-1] + te, H0[k-1] + to) from
    F[0] = min(H0[0], NEG_INF), evaluated in closed form with a prefix max,
    F[k] = max(F[0] + te*k, te*(k-1) + max_{k'<k}(H0[k'] + to - te*k')),
    the same integer arithmetic unrolled; otherwise the lazy F with F[0] =
    min(H0[0] + to, NEG_INF). ``full_text`` drops the text-length mask;
    ``uniform_plen`` takes the last row as FIN.
    """
    N = pat.shape[0]
    dev = pat.device
    match, po, pe, to, te = _gaps(scoring)
    neg = NEG_INF
    kcol = torch.arange(W, dtype=torch.int32, device=dev)
    H = torch.zeros((N, W), dtype=torch.int32, device=dev)
    E = torch.full((N, W), neg, dtype=torch.int32, device=dev)
    FIN = torch.full((N, W), neg, dtype=torch.int32, device=dev)
    neg_col = torch.full((N, 1), neg, dtype=torch.int32, device=dev)
    for im1 in range(L):
        p = pat[:, im1:im1 + 1]
        trow = text[:, im1:im1 + W]
        sub = torch.where(p == trow, match, mmv[:, im1:im1 + 1])
        if not full_text:
            sub = torch.where((im1 + kcol)[None, :] < tlen[:, None], sub,
                              neg)
        diag = H + sub
        Erow = torch.cat([torch.maximum(E[:, 1:] + pe, H[:, 1:] + po),
                          torch.minimum(E[:, -1:], neg_col)], dim=1)
        H0 = torch.maximum(diag, Erow)
        if seq_f:
            F0 = torch.minimum(H0[:, :1], neg_col)
            if W > 1:
                cm = torch.cummax(H0[:, :-1] + (to - te * kcol[:-1]),
                                  dim=1).values
                Fk = torch.maximum(F0 + te * kcol[1:],
                                   cm + te * (kcol[1:] - 1))
                F = torch.cat([F0, Fk], dim=1)
            else:
                F = F0
        else:
            G = torch.cummax(H0 + (to - te * kcol), dim=1).values
            F = torch.cat([torch.minimum(H0[:, :1] + to, neg_col),
                           G[:, :-1] + te * (kcol[1:] - 1)], dim=1)
        Hrow = torch.maximum(H0, F)
        if not uniform_plen:
            FIN = torch.where((plen == im1 + 1)[:, None], Hrow, FIN)
        H, E = Hrow, Erow
    if uniform_plen:
        FIN = H
    smax = FIN.max(dim=1).values
    kb = torch.argmax((FIN == smax[:, None]).to(torch.int32), dim=1)
    return smax.to(torch.int32), kb.to(torch.int32)


# ---------------------------------------------------------------------------
# K2: fused forward + traceback walk
# ---------------------------------------------------------------------------


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _text_tw(texts: torch.Tensor, TW: int) -> torch.Tensor:
    """Texts cut or zero-padded to TW = M + W - 1 columns (as the TPU
    wrapper does)."""
    texts = texts.to(torch.int32)
    if texts.shape[1] < TW:
        texts = torch.nn.functional.pad(texts, (0, TW - texts.shape[1]))
    return texts[:, :TW].contiguous()


# K2 gives each read a group of 4 lanes where the batch alone would leave
# the card under K2_MIN_WARPS_PER_SM warps per SM, else one lane: on an
# H100, 4 lanes are the faster at small batches and one lane at B = 32768
# and at the --all shape (tools/k2_time.py --sweep times both at batches
# around the switch, chip_smoke.py at B = 4096 and 32768; PERF.md). A lane
# of a group holds at least two band cells, so bands under
# K2_MIN_GROUP_BAND take one lane.
K2_GROUPS = (1, 4)
K2_MIN_WARPS_PER_SM = 4
K2_MIN_GROUP_BAND = 5


def k2_group(B: int, sms: int, band: int = 31) -> int:
    """K2's lanes per read for a batch of B reads on a card of ``sms`` SMs
    at ``band``."""
    if band < K2_MIN_GROUP_BAND:
        return 1
    return 1 if B >= K2_MIN_WARPS_PER_SM * 32 * sms else 4


def k2_row_words(band: int, group: int) -> int:
    """32-bit words of K2's direction row of one read and pattern row:
    ``group`` lanes of ceil(ceil(band/group)/8) words, in whole 16-byte
    vectors (4 at every band up to 32)."""
    nwl = -(-(-(-band // group)) // 8)
    return 4 * -(-(group * nwl) // 4)


def banded_traceback(patterns, pattern_lens, texts, text_lens,
                     scoring: GotohScoring, band: int, mismatch_scores=None,
                     local: bool = False, group: int | None = None):
    """Fused banded Gotoh forward pass + traceback walk, SEMI_GLOBAL or
    (``local=True``) LOCAL.

    patterns (B, M) int32, pattern_lens (B,) int32 (<= M), texts
    (B, >= M+W-1) int32, text_lens (B,) int32, mismatch_scores (B, M)
    int32 or None. Returns (score, k_best, ops, n_ops, k_final, nm, i_end,
    i_start): ops is (B, round8(M+W)) int32 packed entries
    ``op | mism<<2 | refsym<<3`` (op 1/2/3 = M/I/D) in END->START order,
    every other output (B,) int32 — the contract of
    ``banded_traceback_semiglobal_pallas``. LOCAL: the sink is the best
    in-range cell (first row, then first k, to reach it; (0, 0, 0) when
    no cell beats 0) and the walk stops on a zero cell in the H state.
    ``group`` sets the kernel's lanes per read (``K2_GROUPS``; None =
    ``k2_group``); it changes no result.
    """
    if patterns.device.type == "cpu":
        return banded_traceback_plain(patterns, pattern_lens, texts,
                                      text_lens, scoring, band,
                                      mismatch_scores, local)
    if patterns.device.type != "cuda":
        raise ValueError(f"unsupported device {patterns.device}")
    B, M = patterns.shape
    W = band
    TW = M + W - 1
    MAXS = _round8(M + W)
    dev = patterns.device
    if mismatch_scores is None:
        mismatch_scores = torch.full((B, M), scoring.mismatch,
                                     dtype=torch.int32, device=dev)
    _check(patterns, "patterns", torch.int32, (B, M), dev)
    _check(mismatch_scores, "mismatch_scores", torch.int32, (B, M), dev)
    _check(pattern_lens, "pattern_lens", torch.int32, (B,), dev)
    _check(text_lens, "text_lens", torch.int32, (B,), dev)
    _check_texts(texts, B, dev)
    texts = _text_tw(texts, TW)
    if group is None:
        group = k2_group(B, _sm_count(dev), W)
    if group not in K2_GROUPS or (group > 1 and W < K2_MIN_GROUP_BAND):
        raise ValueError(f"group {group} not supported at band {W}: "
                         f"{K2_GROUPS}, 1 under band {K2_MIN_GROUP_BAND}")
    # 4-bit directions, a row of whole 16-byte vectors per read and pattern
    # row
    dirs = torch.empty((M, B, k2_row_words(W, group)), dtype=torch.int32,
                       device=dev)
    # the seven (B,) outputs are rows of one allocation, split after the
    # launch so the host's work overlaps the kernel
    flat = torch.empty((7, B), dtype=torch.int32, device=dev)
    ops = torch.empty((B, MAXS), dtype=torch.int32, device=dev)
    row = flat.data_ptr()
    ptrs = (ctypes.c_void_p * 8)(row, row + 4 * B, ops.data_ptr(),
                                 *[row + 4 * B * i for i in range(2, 7)])
    rc_code = _lib("banded_traceback", W).nvbt_banded_traceback(
        patterns.data_ptr(), pattern_lens.data_ptr(), texts.data_ptr(),
        text_lens.data_ptr(), mismatch_scores.data_ptr(), B, M, TW, MAXS, W,
        group, int(local), *_gaps(scoring), dirs.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), _stream(dev))
    _raise_if_failed(rc_code, "banded_traceback", W)
    banded_traceback.launches += 1
    return (flat[0], flat[1], ops, *flat[2:])


banded_traceback.launches = 0


def banded_traceback_plain(patterns, pattern_lens, texts, text_lens,
                           scoring: GotohScoring, band: int,
                           mismatch_scores=None, local: bool = False):
    """Plain torch version of ``banded_traceback`` (same contract).

    Repeats ``_banded_tb_kernel``'s forward arithmetic over a (B, W) band
    plane per row — its log-step prefix max fills with NEG_INF, so F[k] =
    te*(k-1) + max(NEG_INF, max_{k'<k}(H0[k'] + to - te*k')) and F[0] =
    NEG_INF - te — storing direction bytes (M, B, W), then walks every read
    at once, one step per iteration, until all walks end. LOCAL floors H0
    at 0, marks zero cells with direction 3 (:337-338), keeps the best
    in-range cell of the first row that reaches it (:354-365) and stops a
    walk in the H state on a zero cell (:436-443).
    """
    B, M = patterns.shape
    W = band
    TW = M + W - 1
    MAXS = _round8(M + W)
    dev = patterns.device
    match, po, pe, to, te = _gaps(scoring)
    neg = NEG_INF
    pats = patterns.to(torch.int32)
    texts = _text_tw(texts, TW)
    plen = pattern_lens.to(torch.int32)
    tlen = text_lens.to(torch.int32)
    mm = (torch.full((B, M), scoring.mismatch, dtype=torch.int32, device=dev)
          if mismatch_scores is None else mismatch_scores.to(torch.int32))

    kcol = torch.arange(W, dtype=torch.int32, device=dev)
    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    E = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    FIN = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    bst, bi, bk = zero, zero, zero
    dirs = torch.empty((M, B, W), dtype=torch.int32, device=dev)
    for im1 in range(M):
        p = pats[:, im1:im1 + 1]
        trow = texts[:, im1:im1 + W]
        in_text = (im1 + kcol)[None, :] < tlen[:, None]
        sub = torch.where(p == trow, match, mm[:, im1:im1 + 1])
        sub = torch.where(in_text, sub, neg)
        diag = H + sub
        Ep = torch.cat([E[:, 1:], neg_col], dim=1) + pe
        Hp = torch.cat([H[:, 1:], neg_col], dim=1) + po
        Erow = torch.maximum(Ep, Hp)
        e_ext = (Ep >= Hp).to(torch.int32)
        H0 = torch.maximum(diag, Erow)
        if local:
            H0 = H0.clamp(min=0)
        G = torch.cummax(H0 + (to - te * kcol), dim=1).values.clamp(min=neg)
        F = torch.cat([neg_col - te, G[:, :-1] + te * (kcol[1:] - 1)], dim=1)
        f_ext = (F == torch.cat([neg_col, F[:, :-1]], dim=1) + te)
        Hrow = torch.maximum(H0, F)
        hdir = torch.where(Hrow == diag, 0, torch.where(Hrow == Erow, 1, 2))
        if local:
            hdir = torch.where(Hrow == 0, 3, hdir)
        mism = (p != trow).to(torch.int32)
        dirs[im1] = (hdir | (e_ext << 2) | (f_ext.to(torch.int32) << 3)
                     | (mism << 4))
        if local:
            valid = in_text & (im1 + 1 <= plen)[:, None]
            masked = torch.where(valid, Hrow, neg)
            rb = masked.max(dim=1).values
            rk = torch.argmax((masked == rb[:, None]).to(torch.int32), dim=1)
            upd = rb > bst
            bst = torch.where(upd, rb, bst)
            bi = torch.where(upd, im1 + 1, bi)
            bk = torch.where(upd, rk.clamp(max=W - 1).to(torch.int32), bk)
        else:
            FIN = torch.where((plen == im1 + 1)[:, None], Hrow, FIN)
        H, E = Hrow, Erow
    if local:
        smax, i0, k0 = bst, bi, bk
        active = i0 >= 1
    else:
        smax = FIN.max(dim=1).values
        k0 = torch.argmax((FIN == smax[:, None]).to(torch.int32), dim=1)
        k0 = k0.clamp(max=W - 1).to(torch.int32)
        i0 = plen
        active = (i0 >= 1) & (plen <= M)

    # ---- the walk, all reads in lock-step (each read's own sequence) -----
    rows = torch.arange(B, device=dev)
    i = i0.clone()
    k = k0.clone()
    st = torch.zeros(B, dtype=torch.int32, device=dev)
    cursor = torch.zeros(B, dtype=torch.int32, device=dev)
    nm = torch.zeros(B, dtype=torch.int32, device=dev)
    ops = torch.zeros((B, MAXS), dtype=torch.int32, device=dev)
    for _ in range(2 * (M + W)):
        if not bool(active.any()):
            break
        r = (i - 1).clamp(0, M - 1).to(torch.int64)
        cell = dirs[r, rows, k.to(torch.int64)]
        hdir = cell & 3
        e_ext = (cell >> 2) & 1
        f_ext = (cell >> 3) & 1
        mism = (cell >> 4) & 1
        if local:
            # zero-stop: (i, k) stay at the stop cell
            active = active & ~((st == 0) & (hdir == 3))
        sym = texts[rows, (r + k).clamp(max=TW - 1)] & 15
        sel = torch.where(st == 1, 1, torch.where(st == 2, 2, hdir))
        op = torch.where(sel == 0, 1, torch.where(sel == 1, 2, 3))
        entry = op | (torch.where(sel == 0, mism, 0) << 2) | (sym << 3)
        put = active & (cursor < MAXS)
        ops[rows[put], cursor[put].to(torch.int64)] = entry[put].to(
            torch.int32)
        nm = torch.where(active, nm + torch.where(sel == 0, mism, 1), nm)
        di = torch.where(sel == 2, 0, 1)
        dk = torch.where(sel == 0, 0, torch.where(sel == 1, 1, -1))
        new_st = torch.where(
            sel == 0, 0,
            torch.where(sel == 1, torch.where(e_ext == 1, 1, 0),
                        torch.where(f_ext == 1, 2, 0)))
        cursor = torch.where(active, cursor + 1, cursor)
        i = torch.where(active, i - di, i)
        k = torch.where(active, (k + dk).clamp(0, W - 1), k)
        st = torch.where(active, new_st, st)
        active = active & (i >= 1)
    i32 = torch.int32
    return (smax.to(i32), k0.to(i32), ops, cursor.to(i32), k.to(i32),
            nm.to(i32), i0.to(i32).clone(), i.to(i32))


# ---------------------------------------------------------------------------
# K2-WIDE: K2 at bands beyond one thread's registers (the full-matrix mate
# traceback's band T+M), one warp per read
# ---------------------------------------------------------------------------

# band cells per lane with a compiled instantiation (one warp of 32 lanes per
# read), one for each band T+M of a documented read length: 230 at L = 100
# (8), 286 at 128 (12), 1054 at 512 (36, the widest); a band W takes the
# fewest that hold it. A band past WIDE_MAX_BAND (the full-matrix traceback
# of a 512-base read at max_dist > 64) builds a library of its own at first
# use: ceil(W/32) cells a lane rounded up to a multiple of 4 (whole
# half-words of direction nibbles), the band compiled in.
WIDE_CELLS_PER_LANE = (8, 12, 36)
WIDE_MAX_BAND = 32 * WIDE_CELLS_PER_LANE[-1]
# a read's rows of 4-bit directions stay in shared memory up to this size
# (two reads a block); wider bands (1054 at M = 512: 276 KB) go to a global
# scratch of the same layout
WIDE_SMEM_READ_BYTES = 64 * 1024

# any W: the plain K2 is written for every band width
banded_traceback_wide_plain = banded_traceback_plain


def wide_cells(band: int) -> int:
    """K2-WIDE's band cells per lane for a band: the fewest compiled ones
    that hold it, past ``WIDE_MAX_BAND`` ceil(band/32) rounded up to a
    multiple of 4. ValueError for a band under 1."""
    if band < 1:
        raise ValueError(f"banded_traceback_wide: band {band} < 1")
    if band > WIDE_MAX_BAND:
        return -(-(-(-band // 32)) // 4) * 4
    return next(nc for nc in WIDE_CELLS_PER_LANE if 32 * nc >= band)


def wide_row_bytes(band: int) -> int:
    """Bytes of one row of K2-WIDE's direction nibbles: the cells of the
    lanes that hold the band, four bits each."""
    nc = wide_cells(band)
    return -(-band // nc) * nc // 2


def wide_route(M: int, band: int) -> str:
    """Where K2-WIDE keeps its direction nibbles for patterns of M rows at
    ``band``: "shared" when one read's rows (M x ``wide_row_bytes``) fit
    ``WIDE_SMEM_READ_BYTES``, else "global"."""
    return ("shared" if M * wide_row_bytes(band) <= WIDE_SMEM_READ_BYTES
            else "global")


def banded_traceback_wide(patterns, pattern_lens, texts, text_lens,
                          scoring: GotohScoring, band: int,
                          mismatch_scores=None, local: bool = False):
    """``banded_traceback``'s contract (the same eight outputs, SEMI_GLOBAL
    or LOCAL) for any band W >= 1: the kernel of the full-matrix traceback,
    whose band T+M is 230 at the operating point and 1054 at a 512-base
    read (a band past ``WIDE_MAX_BAND``, 1152, builds its own library at
    first use). ``wide_route`` picks where the directions live. For CPU
    tensors: ``banded_traceback_wide_plain``."""
    nc = wide_cells(band)
    if patterns.device.type == "cpu":
        return banded_traceback_wide_plain(patterns, pattern_lens, texts,
                                           text_lens, scoring, band,
                                           mismatch_scores, local)
    if patterns.device.type != "cuda":
        raise ValueError(f"unsupported device {patterns.device}")
    B, M = patterns.shape
    W = band
    TW = M + W - 1
    MAXS = _round8(M + W)
    shared = wide_route(M, W) == "shared"
    dev = patterns.device
    if mismatch_scores is None:
        mismatch_scores = torch.full((B, M), scoring.mismatch,
                                     dtype=torch.int32, device=dev)
    _check(patterns, "patterns", torch.int32, (B, M), dev)
    _check(mismatch_scores, "mismatch_scores", torch.int32, (B, M), dev)
    _check(pattern_lens, "pattern_lens", torch.int32, (B,), dev)
    _check(text_lens, "text_lens", torch.int32, (B,), dev)
    _check_texts(texts, B, dev)
    texts = _text_tw(texts, TW)
    # four bits per band cell, a read's row contiguous: only the global
    # route has a scratch
    dirs = (None if shared else
            torch.empty((B, M, wide_row_bytes(W)), dtype=torch.uint8,
                        device=dev))
    flat = torch.empty((7, B), dtype=torch.int32, device=dev)
    ops = torch.empty((B, MAXS), dtype=torch.int32, device=dev)
    row = flat.data_ptr()
    ptrs = (ctypes.c_void_p * 8)(row, row + 4 * B, ops.data_ptr(),
                                 *[row + 4 * B * i for i in range(2, 7)])
    rc_code = _lib("banded_traceback_wide", W).nvbt_banded_traceback_wide(
        patterns.data_ptr(), pattern_lens.data_ptr(), texts.data_ptr(),
        text_lens.data_ptr(), mismatch_scores.data_ptr(), B, M, TW, MAXS, W,
        nc, int(shared), int(local), *_gaps(scoring),
        None if dirs is None else dirs.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), _stream(dev))
    _raise_if_failed(rc_code, "banded_traceback_wide", W)
    banded_traceback_wide.launches += 1
    return (flat[0], flat[1], ops, *flat[2:])


banded_traceback_wide.launches = 0


# ---------------------------------------------------------------------------
# K3: banded scoring of flat (pattern, text) pairs, SEMI_GLOBAL or LOCAL
# ---------------------------------------------------------------------------

def banded_score_plain(patterns, pattern_lens, texts, text_lens,
                       scoring: GotohScoring, band: int,
                       mismatch_scores=None, local: bool = False):
    """Plain torch version of ``banded_score`` (same contract): the flat
    batched scorer. The band state is a dense (B, W) plane updated once
    per pattern row, the within-row text-gap dependency broken by an
    exclusive prefix max ("lazy F"), floored at NEG_INF exactly as the TPU
    kernel's doubling loop (pallas_kernels.py:96-103) floors it; the JAX
    package's scan scorer (``align.batch.batch_score_banded``) leaves it
    unfloored, so the two differ only in rows whose every cell lies near
    NEG_INF (no alignment exists). ``local=True`` floors H at 0 and keeps
    a running max over the cells with i <= plen and i - 1 + k < tlen
    (pallas_kernels.py:93-94, :108-112)."""
    B, M = patterns.shape
    W = band
    TW = M + W - 1
    dev = patterns.device
    po, pe = scoring.pattern_gap_open, scoring.pattern_gap_ext
    to, te = scoring.text_gap_open, scoring.text_gap_ext
    neg = NEG_INF
    pats = patterns.to(torch.int32)
    texts = texts.to(torch.int32)
    if texts.shape[1] < TW:
        texts = torch.nn.functional.pad(texts, (0, TW - texts.shape[1]))
    plen = pattern_lens.to(torch.int32)
    tlen = text_lens.to(torch.int32)
    mm = (None if mismatch_scores is None
          else mismatch_scores.to(torch.int32))

    kcol = torch.arange(W, dtype=torch.int32, device=dev)
    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    E = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    final = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=torch.int32, device=dev)
    for im1 in range(M):
        p = pats[:, im1:im1 + 1]
        trow = texts[:, im1:im1 + W]
        mmv = scoring.mismatch if mm is None else mm[:, im1:im1 + 1]
        in_text = (im1 + kcol)[None, :] < tlen[:, None]
        sub = torch.where(p == trow, scoring.match, mmv).to(torch.int32)
        sub = torch.where(in_text, sub, neg)
        diag = H + sub
        Erow = torch.maximum(torch.cat([E[:, 1:], neg_col], dim=1) + pe,
                             torch.cat([H[:, 1:], neg_col], dim=1) + po)
        H0 = torch.maximum(diag, Erow)
        if local:
            H0 = H0.clamp(min=0)
        # F[k] = te*(k-1) + max(NEG, max_{k'<k}(H0[k'] + to - te*k'))
        G = torch.cummax(H0 + (to - te * kcol), dim=1).values.clamp(min=neg)
        F = torch.cat([neg_col, G[:, :-1]], dim=1) + te * (kcol - 1)
        Hrow = torch.maximum(H0, F)
        if local:
            valid = in_text & (im1 + 1 <= plen)[:, None]
            final = torch.maximum(final, torch.where(valid, Hrow, neg))
        else:
            final = torch.where((plen == im1 + 1)[:, None], Hrow, final)
        H, E = Hrow, Erow
    score = final.max(dim=1).values
    k_best = torch.argmax(final, dim=1).to(torch.int32)
    return score, k_best


def banded_score(patterns, pattern_lens, texts, text_lens,
                 scoring: GotohScoring, band: int, mismatch_scores=None,
                 local: bool = False):
    """Banded Gotoh score and first-max band index of each (pattern,
    text) pair: SEMI_GLOBAL (the row at ``pattern_lens``) or, with
    ``local=True``, LOCAL (H floored at 0, the best cell with i <= plen
    and i-1+k < tlen).

    patterns, mismatch_scores (B, M) int32 (``None`` = ``scoring.
    mismatch``); texts (B, T) int32, zero-padded or cut to M+W-1 columns;
    lens (B,) int32. Returns (score, k_best), (B,) int32 — the contract of
    ``banded_score_semiglobal_pallas``.
    """
    if patterns.device.type == "cpu":
        return banded_score_plain(patterns, pattern_lens, texts, text_lens,
                                  scoring, band, mismatch_scores, local)
    if patterns.device.type != "cuda":
        raise ValueError(f"unsupported device {patterns.device}")
    B, M = patterns.shape
    W = band
    TW = M + W - 1
    dev = patterns.device
    _check_k3(patterns, pattern_lens, text_lens, mismatch_scores, B, M, dev)
    _check_texts(texts, B, dev)
    texts = _text_tw(texts, TW)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    kbest = torch.empty((B,), dtype=torch.int32, device=dev)
    rc_code = _lib("banded_score", W).nvbt_banded_score(
        patterns.data_ptr(), pattern_lens.data_ptr(), texts.data_ptr(),
        text_lens.data_ptr(), _ptr(mismatch_scores), B, M, TW, W, int(local),
        scoring.match, scoring.mismatch, *_gaps(scoring)[1:],
        score.data_ptr(), kbest.data_ptr(), _stream(dev))
    _raise_if_failed(rc_code, "banded_score", W)
    banded_score.launches += 1
    return score, kbest


banded_score.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_k3(patterns, pattern_lens, text_lens, mismatch_scores, B, M, dev):
    _check(patterns, "patterns", torch.int32, (B, M), dev)
    if mismatch_scores is not None:
        _check(mismatch_scores, "mismatch_scores", torch.int32, (B, M), dev)
    _check(pattern_lens, "pattern_lens", torch.int32, (B,), dev)
    _check(text_lens, "text_lens", torch.int32, (B,), dev)


def _check_windows(genome_words, starts, B, dev):
    if genome_words.dim() != 1:
        raise ValueError("genome_words must be 1-D")
    _check(genome_words, "genome_words", torch.int32, genome_words.shape, dev)
    _check(starts, "starts", torch.int64, (B,), dev)


def banded_score_windows(patterns, pattern_lens, genome_words, starts,
                         text_lens, scoring: GotohScoring, band: int,
                         mismatch_scores=None, local: bool = False):
    """``banded_score`` over the windows of the packed genome: the text of
    pair b is the M+W-1 symbols from ``starts[b]`` that ``extract_window``
    cuts (0 past the genome's last word), read by the kernel straight from
    ``genome_words`` (int32 tensor of the packed genome's uint32 bits) with
    no window built. starts (B,) int64, >= 0; the rest as ``banded_score``
    (``mismatch_scores=None``: the scalar mismatch, no plane). For CPU
    tensors: ``banded_score_windows_plain``."""
    if patterns.device.type == "cpu":
        return banded_score_windows_plain(patterns, pattern_lens,
                                          genome_words, starts, text_lens,
                                          scoring, band, mismatch_scores,
                                          local)
    if patterns.device.type != "cuda":
        raise ValueError(f"unsupported device {patterns.device}")
    B, M = patterns.shape
    W = band
    dev = patterns.device
    _check_k3(patterns, pattern_lens, text_lens, mismatch_scores, B, M, dev)
    _check_windows(genome_words, starts, B, dev)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    kbest = torch.empty((B,), dtype=torch.int32, device=dev)
    rc_code = _lib("banded_score", W).nvbt_banded_score_windows(
        patterns.data_ptr(), pattern_lens.data_ptr(), genome_words.data_ptr(),
        genome_words.shape[0], starts.data_ptr(), text_lens.data_ptr(),
        _ptr(mismatch_scores), B, M, W, int(local), scoring.match,
        scoring.mismatch, *_gaps(scoring)[1:], score.data_ptr(),
        kbest.data_ptr(), _stream(dev))
    _raise_if_failed(rc_code, "banded_score_windows", W)
    banded_score_windows.launches += 1
    return score, kbest


banded_score_windows.launches = 0


def banded_score_windows_plain(patterns, pattern_lens, genome_words, starts,
                               text_lens, scoring: GotohScoring, band: int,
                               mismatch_scores=None, local: bool = False):
    """Plain torch version of ``banded_score_windows``: ``extract_window``
    then ``banded_score_plain``."""
    TW = patterns.shape[1] + band - 1
    return banded_score_plain(patterns, pattern_lens,
                              extract_window(genome_words, starts, TW),
                              text_lens, scoring, band, mismatch_scores,
                              local)


# ---------------------------------------------------------------------------
# K4: Myers bit-parallel semi-global edit distance
# ---------------------------------------------------------------------------

# patterns of up to MYERS_REG_WORDS words of 32 bits (M <= 512, MapParams'
# read cap) over DNA keep their state in registers, one read a thread; any
# other width or alphabet takes the generic instantiation (state in a
# global scratch)
MYERS_REG_WORDS = 16
_M32 = 0xFFFFFFFF


def myers_words(M: int) -> int:
    """32-bit words of a pattern of M columns (at least 1)."""
    return max(-(-M // 32), 1)


def myers_route(M: int, n_symbols: int = 4) -> str:
    """Where K4 keeps a read's Peq, PV and MV: "registers" for DNA patterns
    of up to ``MYERS_REG_WORDS`` words, else "generic"."""
    return ("registers" if n_symbols == 4 and myers_words(M) <= MYERS_REG_WORDS
            else "generic")


def _myers_launch(fn, args, B, M, n_symbols, dev):
    """The generic route's scratch and the launch of one K4 entry
    (``args``: its arguments before the scratch)."""
    nw = myers_words(M)
    scratch = (None if myers_route(M, n_symbols) == "registers" else
               torch.empty(((n_symbols + 2) * nw, B), dtype=torch.int32,
                           device=dev))
    dist = torch.empty((B,), dtype=torch.int32, device=dev)
    tend = torch.empty((B,), dtype=torch.int32, device=dev)
    rc_code = fn(*args, _ptr(scratch), dist.data_ptr(), tend.data_ptr(),
                 _stream(dev))
    _raise_if_failed(rc_code, "myers_semiglobal", M)
    return dist, tend


def myers_semiglobal(patterns, pattern_lens, texts, text_lens,
                     n_symbols: int = 4):
    """Semi-global edit distance (pattern global, text local) and the
    first 1-based text end at which it is reached.

    patterns (B, M) int32, any M (codes 0..n_symbols-1; others match
    nothing), texts (B, T) int32 read in place (a code outside
    1..n_symbols-1 reads as 0), lens (B,) int32. Returns (distance,
    text_end), (B,) int32 — the contract of ``myers_semiglobal_pallas``,
    including its floor arithmetic at ``plen = 0``."""
    if patterns.device.type == "cpu":
        return myers_semiglobal_plain(patterns, pattern_lens, texts,
                                      text_lens, n_symbols)
    if patterns.device.type != "cuda":
        raise ValueError(f"unsupported device {patterns.device}")
    B, M = patterns.shape
    dev = patterns.device
    _check(patterns, "patterns", torch.int32, (B, M), dev)
    _check(pattern_lens, "pattern_lens", torch.int32, (B,), dev)
    _check(text_lens, "text_lens", torch.int32, (B,), dev)
    _check_texts(texts, B, dev)
    if not texts.is_contiguous():
        raise ValueError("texts is not contiguous")
    T = texts.shape[1]
    out = _myers_launch(
        _lib("myers_semiglobal").nvbt_myers_semiglobal,
        (patterns.data_ptr(), pattern_lens.data_ptr(), texts.data_ptr(),
         text_lens.data_ptr(), B, M, T, n_symbols), B, M, n_symbols, dev)
    myers_semiglobal.launches += 1
    return out


myers_semiglobal.launches = 0


def myers_semiglobal_windows(patterns, pattern_lens, genome_words, starts,
                             text_lens, T: int):
    """``myers_semiglobal`` (DNA) over the windows of the packed genome:
    the text of read b is the T symbols from ``starts[b]`` that
    ``extract_window`` cuts (0 past the genome's last word), read by the
    kernel straight from ``genome_words`` (int32 tensor of the packed
    genome's uint32 bits) with no window built. starts (B,) int64, >= 0.
    For CPU tensors: ``myers_semiglobal_windows_plain``."""
    if patterns.device.type == "cpu":
        return myers_semiglobal_windows_plain(patterns, pattern_lens,
                                              genome_words, starts,
                                              text_lens, T)
    if patterns.device.type != "cuda":
        raise ValueError(f"unsupported device {patterns.device}")
    B, M = patterns.shape
    dev = patterns.device
    _check(patterns, "patterns", torch.int32, (B, M), dev)
    _check(pattern_lens, "pattern_lens", torch.int32, (B,), dev)
    _check(text_lens, "text_lens", torch.int32, (B,), dev)
    _check_windows(genome_words, starts, B, dev)
    out = _myers_launch(
        _lib("myers_semiglobal").nvbt_myers_semiglobal_windows,
        (patterns.data_ptr(), pattern_lens.data_ptr(),
         genome_words.data_ptr(), genome_words.shape[0], starts.data_ptr(),
         text_lens.data_ptr(), B, M, T), B, M, 4, dev)
    myers_semiglobal_windows.launches += 1
    return out


myers_semiglobal_windows.launches = 0


def myers_semiglobal_windows_plain(patterns, pattern_lens, genome_words,
                                   starts, text_lens, T: int):
    """Plain torch version of ``myers_semiglobal_windows``:
    ``extract_window`` then ``myers_semiglobal_plain``."""
    return myers_semiglobal_plain(patterns, pattern_lens,
                                  extract_window(genome_words, starts, T),
                                  text_lens)


def myers_semiglobal_plain(patterns, pattern_lens, texts, text_lens,
                           n_symbols: int = 4):
    """Plain torch version of ``myers_semiglobal`` (same contract).

    Repeats ``_myers_kernel`` (pallas_kernels.py:1047-1128) word for word.
    CPU torch has no uint32 arithmetic, so every word is an int64 holding
    32 bits, masked after each add, ``~`` and ``<<``; a carry out of an add
    is ``t < a`` on the masked values. ``plen = 0`` takes the kernel's
    floor forms: last word -1 (so word 0), last bit 31.
    """
    B, M = patterns.shape
    T = texts.shape[1]
    NW = (M + 31) // 32
    dev = patterns.device
    i64 = torch.int64
    pats = patterns.to(i64)
    plen = pattern_lens.to(i64)
    tlen = text_lens.to(i64)
    txts = texts.to(i64)
    pos = torch.arange(M, dtype=i64, device=dev)
    bit = torch.bitwise_left_shift(torch.ones_like(pos), pos % 32)[None, :]
    in_pat = pos[None, :] < plen[:, None]
    peq = []
    for c in range(n_symbols):
        hit = torch.where((pats == c) & in_pat, bit, 0)   # disjoint bits
        peq.append([hit[:, w * 32:(w + 1) * 32].sum(dim=1)
                    for w in range(NW)])
    last = plen - 1
    last_word = torch.div(last, 32, rounding_mode="floor")
    last_bit = last - 32 * last_word

    PV = [torch.full((B,), _M32, dtype=i64, device=dev)] * NW
    MV = [torch.zeros(B, dtype=i64, device=dev)] * NW
    score = plen.clone()
    best = plen.clone()
    bend = torch.zeros(B, dtype=i64, device=dev)
    for j in range(T):
        tch = txts[:, j]
        Eq = []
        for w in range(NW):
            e = peq[0][w]
            for c in range(1, n_symbols):
                e = torch.where(tch == c, peq[c][w], e)
            Eq.append(e)
        summ, carry = [], None
        for w in range(NW):
            a = Eq[w] & PV[w]
            t = (a + PV[w]) & _M32
            c1 = t < a
            if carry is None:
                s, carry = t, c1
            else:
                s = (t + carry.to(i64)) & _M32
                carry = c1 | (s < t)
            summ.append(s)
        D0 = [(summ[w] ^ PV[w]) | Eq[w] | MV[w] for w in range(NW)]
        Hp = [MV[w] | (~(D0[w] | PV[w]) & _M32) for w in range(NW)]
        Hn = [PV[w] & D0[w] for w in range(NW)]
        phl, mhl = Hp[0], Hn[0]
        for w in range(1, NW):
            phl = torch.where(last_word == w, Hp[w], phl)
            mhl = torch.where(last_word == w, Hn[w], mhl)
        score = score + ((phl >> last_bit) & 1) - ((mhl >> last_bit) & 1)
        HpS, HnS = [], []
        cp = cn = 0
        for w in range(NW):
            HpS.append(((Hp[w] << 1) & _M32) | cp)
            HnS.append(((Hn[w] << 1) & _M32) | cn)
            cp, cn = Hp[w] >> 31, Hn[w] >> 31
        PV = [HnS[w] | (~(D0[w] | HpS[w]) & _M32) for w in range(NW)]
        MV = [D0[w] & HpS[w] for w in range(NW)]
        upd = (j < tlen) & (score < best)
        best = torch.where(upd, score, best)
        bend = torch.where(upd, j + 1, bend)
    return best.to(torch.int32), bend.to(torch.int32)


# ---------------------------------------------------------------------------
# K5: the register-tiled scorer over pre-blocked (G, rows, 8, 128) operands
# ---------------------------------------------------------------------------


def regtile_score_blocked(patsb, plb, txtsb, tlb, mmb, *,
                          scoring: GotohScoring, band: int, length: int,
                          seq_f: bool = True, full_text: bool = False,
                          uniform_plen: bool = False, unroll: int = 1,
                          t_regs: bool = True, packed_count=None):
    """SEMI_GLOBAL banded Gotoh score and first-max band index of every
    alignment of a blocked batch: the contract of the TPU function of the
    same name. ``patsb``/``mmb`` (G, Lp, 8, 128) int32 with Lp >= length,
    ``txtsb`` (G, TWp, 8, 128) int32 with TWp >= length + band - 1,
    ``plb``/``tlb`` (G, 1, 8, 128) int32; alignment g*1024 + s*128 + l is
    element [g][row][s][l]. Returns (score, kbest), (G, 1, 8, 128) int32.

    ``seq_f`` takes the sequential F (switched off when text_gap_ext <
    text_gap_open, as on the TPU); ``full_text`` asserts every text spans
    the band (no length mask; the padded text is read as it is);
    ``uniform_plen`` asserts every pattern is ``length`` long (FIN is the
    last row). ``unroll`` and ``t_regs`` schedule the TPU's VLIW bundles
    and change no result: they are checked (``unroll`` must divide
    ``length``) and do nothing on the card. For CPU tensors:
    ``regtile_score_blocked_plain``.

    The kernel scores the pairs of neighbouring alignments that
    ``k5_packed_pairs`` admits in 16-bit halves, the others in int32; the
    result is the same. ``packed_count``: None, or a one-element int32
    tensor on the operands' device to which the call adds the number of
    pairs scored in 16-bit halves (on the CPU, the pairs the guard admits).
    """
    if scoring.text_gap_ext < scoring.text_gap_open:
        seq_f = False  # the sequential F needs te >= to
    G = patsb.shape[0]
    W = band
    if unroll < 1 or length % unroll:
        raise ValueError(f"unroll {unroll} must divide length {length}")
    if not isinstance(t_regs, bool):
        raise TypeError("t_regs must be a bool")
    if patsb.dim() != 4 or tuple(patsb.shape[2:]) != (8, 128) \
            or patsb.shape[1] < length or length < 1:
        raise ValueError(f"patsb must be (G, >= {length}, 8, 128); got "
                         f"{tuple(patsb.shape)}")
    if txtsb.dim() != 4 or txtsb.shape[0] != G \
            or txtsb.shape[1] < length + W - 1 \
            or tuple(txtsb.shape[2:]) != (8, 128):
        raise ValueError(f"txtsb must be (G, >= {length + W - 1}, 8, 128); "
                         f"got {tuple(txtsb.shape)}")
    if packed_count is not None:
        _check(packed_count, "packed_count", torch.int32, (1,),
               patsb.device)
    if patsb.device.type == "cpu":
        if packed_count is not None:
            packed_count += k5_packed_pairs(
                patsb, plb, txtsb, tlb, mmb, scoring=scoring, band=band,
                length=length, full_text=full_text,
                uniform_plen=uniform_plen).sum().to(torch.int32)
        return regtile_score_blocked_plain(
            patsb, plb, txtsb, tlb, mmb, scoring=scoring, band=band,
            length=length, seq_f=seq_f, full_text=full_text,
            uniform_plen=uniform_plen)
    if patsb.device.type != "cuda":
        raise ValueError(f"unsupported device {patsb.device}")
    dev = patsb.device
    Lp, TWp = patsb.shape[1], txtsb.shape[1]
    _check(patsb, "patsb", torch.int32, (G, Lp, 8, 128), dev)
    _check(mmb, "mmb", torch.int32, (G, Lp, 8, 128), dev)
    _check(txtsb, "txtsb", torch.int32, (G, TWp, 8, 128), dev)
    _check(plb, "plb", torch.int32, (G, 1, 8, 128), dev)
    _check(tlb, "tlb", torch.int32, (G, 1, 8, 128), dev)
    # the kernel reads each pair of alignments with one 8-byte load
    patsb, plb, txtsb, tlb, mmb = (x if x.data_ptr() % 8 == 0 else x.clone()
                                   for x in (patsb, plb, txtsb, tlb, mmb))
    score = torch.empty((G, 1, 8, 128), dtype=torch.int32, device=dev)
    kbest = torch.empty((G, 1, 8, 128), dtype=torch.int32, device=dev)
    flags = int(seq_f) | (int(full_text) << 1) | (int(uniform_plen) << 2)
    rc_code = _lib("regtile_score_blocked", W).nvbt_regtile_score_blocked(
        patsb.data_ptr(), plb.data_ptr(), txtsb.data_ptr(), tlb.data_ptr(),
        mmb.data_ptr(), G, Lp, TWp, length, W, flags, *_gaps(scoring),
        k1_packed_limit(scoring, W), score.data_ptr(), kbest.data_ptr(),
        None if packed_count is None else packed_count.data_ptr(),
        _stream(dev))
    _raise_if_failed(rc_code, "regtile_score_blocked", W)
    regtile_score_blocked.launches += 1
    return score, kbest


regtile_score_blocked.launches = 0


def k5_packed_pairs(patsb, plb, txtsb, tlb, mmb, *, scoring: GotohScoring,
                    band: int, length: int, full_text: bool = False,
                    uniform_plen: bool = False) -> torch.Tensor:
    """The guard of K5's packed loop: (G, 1, 8, 64) bool, True where the
    kernel scores alignments 2j and 2j+1 of a block row in the 16-bit halves
    of a register (``regtile_score_blocked.cu``), False where it scores
    them in int32. Same operands and flags as ``regtile_score_blocked``.

    A pair is admitted when ``k1_packed_limit(scoring, band)`` >= 0 and
      * both halves have a FIN row (``uniform_plen``, or 1 <= plen <=
        length; they run rows = length or plen) and a text that spans it
        (``full_text``, or tlen >= rows + band - 1);
      * over the R = max(rows_lo, rows_hi) rows the pair runs, the sum of
        max(|mm_lo[r]|, |mm_hi[r]|, |match|) is at most the limit and each
        term at most 127 (the per-half substitution tables hold int8);
      * every text code of both halves at positions < R + band - 1 lies in
        [0, 4) (the text pair selects bytes of those tables; a pattern code
        outside [0, 4) matches nothing, as in int32).
    Then every value stays within +-K1_PACKED_RANGE, as
    ``k1_packed_limit`` argues for K1, and the result equals int32's; the
    shorter half stops being read at its own FIN row, and the rows after it
    only keep its values in range."""
    W, L = band, length
    G = patsb.shape[0]
    lim = k1_packed_limit(scoring, W)
    dev = patsb.device
    plen = plb.reshape(G, 512, 2).to(torch.int64)
    tlen = tlb.reshape(G, 512, 2).to(torch.int64)
    if uniform_plen:
        fin = torch.ones_like(plen, dtype=torch.bool)
        rows = torch.full_like(plen, L)
    else:
        fin = (plen >= 1) & (plen <= L)
        rows = torch.where(fin, plen, 0)
    ok = fin.all(dim=2)
    if not full_text:
        ok &= (tlen >= rows + W - 1).all(dim=2)
    R = rows.max(dim=2).values                                  # (G, 512)
    mag = mmb[:, :L].reshape(G, L, 512, 2).to(torch.int64).abs()
    mag = torch.maximum(mag.max(dim=3).values,
                        torch.tensor(abs(scoring.match), device=dev))
    run = torch.arange(L, device=dev)[None, :, None] < R[:, None, :]
    mag = torch.where(run, mag, 0)
    ok &= (mag.sum(dim=1) <= lim) & (mag.max(dim=1).values <= 127)
    TW = L + W - 1
    txt = txtsb[:, :TW].reshape(G, TW, 512, 2)
    bad = ((txt < 0) | (txt > 3)).any(dim=3)
    read = torch.arange(TW, device=dev)[None, :, None] < (R + W - 1)[:, None]
    ok &= ~(bad & read).any(dim=1)
    return (ok & (lim >= 0)).reshape(G, 1, 8, 64)


def _unblock(x):
    """(G, rows, 8, 128) -> (G*1024, rows): alignment g*1024 + s*128 + l."""
    G, rows = x.shape[0], x.shape[1]
    return x.permute(0, 2, 3, 1).reshape(G * 1024, rows)


def regtile_score_blocked_plain(patsb, plb, txtsb, tlb, mmb, *,
                                scoring: GotohScoring, band: int,
                                length: int, seq_f: bool = True,
                                full_text: bool = False,
                                uniform_plen: bool = False, unroll: int = 1,
                                t_regs: bool = True):
    """Plain torch version of ``regtile_score_blocked`` (same contract):
    un-blocks the operands and repeats ``_regtile_kernel``'s arithmetic for
    each flag (``_regtile_plain``), F[0] = min(H0[0], NEG_INF) and the
    band-edge E = min(E, NEG_INF) included."""
    if scoring.text_gap_ext < scoring.text_gap_open:
        seq_f = False
    G = patsb.shape[0]
    score, kbest = _regtile_plain(
        _unblock(patsb.to(torch.int32)), _unblock(mmb.to(torch.int32)),
        _unblock(txtsb.to(torch.int32)), plb.reshape(G * 1024),
        tlb.reshape(G * 1024), scoring, band, length, seq_f,
        full_text=full_text, uniform_plen=uniform_plen)
    return score.reshape(G, 1, 8, 128), kbest.reshape(G, 1, 8, 128)


def banded_score_semiglobal_regtile(patterns, pattern_lens, texts,
                                    text_lens, scoring: GotohScoring,
                                    band: int, mismatch_scores=None):
    """SEMI_GLOBAL banded Gotoh (score, kbest), (B,) int32, of flat
    (pattern, text) pairs through K5: the TPU function of the same name
    (pallas_kernels.py:792), its relayout included — patterns, penalties
    and texts cut or zero-padded to Lp = round8(M) and Lp + W rows, the
    batch padded to whole blocks of 1024 with empty alignments."""
    B, M = patterns.shape
    W = band
    Lp = _round8(M)
    TWp = Lp + W
    G = (max(B, 1024) + 1023) // 1024
    Bp = G * 1024
    dev = patterns.device

    def to_blocks(x, rows):
        x = x.to(torch.int32)[:, :rows]
        x = torch.nn.functional.pad(x, (0, rows - x.shape[1], 0, Bp - B))
        return x.reshape(G, 8, 128, rows).permute(0, 3, 1, 2).contiguous()

    def lens_blocks(x):
        x = torch.nn.functional.pad(x.to(torch.int32), (0, Bp - B))
        return x.reshape(G, 1, 8, 128)

    if mismatch_scores is None:
        mmb = torch.full((G, Lp, 8, 128), scoring.mismatch, dtype=torch.int32,
                         device=dev)
    else:
        mmb = to_blocks(mismatch_scores, Lp)
    score, kbest = regtile_score_blocked(
        to_blocks(patterns, Lp), lens_blocks(pattern_lens),
        to_blocks(texts, TWp), lens_blocks(text_lens), mmb,
        scoring=scoring, band=W, length=M)
    return score.reshape(Bp)[:B], kbest.reshape(Bp)[:B]


# ---- the FM-index walks (fm_search.cu) -------------------------------------
# CUDA only: ``fmi/search.py``'s wrappers route CPU tensors to the plain
# versions beside them and compute the plain loops' trip counts.

def _check_fm_index(rank_rows, count, n: int, dev):
    _check(rank_rows, "rank_rows", torch.int32, (rank_rows.shape[0], 8), dev)
    if rank_rows.data_ptr() % 16:
        raise ValueError("rank_rows must be 16-byte aligned")
    _check(count, "count", torch.int64, (5,), dev)
    if n + 1 >= 2**32:
        raise ValueError("text too long for the FM kernels")


def _check_fm_walk(what: str, dev, lanes: int, steps, queries=None,
                   qlens=None):
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if queries is not None:
        if queries.dim() != 2:
            raise ValueError(f"{what}: queries must be (B, L), got "
                             f"{tuple(queries.shape)}")
        _check(queries, "queries", torch.int32, queries.shape, dev)
        if qlens.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"qlens has dtype {qlens.dtype}, expected "
                            f"int32 or int64")
        _check(qlens, "qlens", qlens.dtype, (lanes,), dev)
    if steps is not None:
        _check(steps, "steps", torch.int16, (lanes,), dev)


def _fm_launch(entry: str, what: str, dev, *args) -> None:
    """One launch of ``entry`` on the current stream (tensors passed as
    their pointers, None as null); raises if the launch failed."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(_lib("fm_search"), entry)(*ptrs, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


def fm_backward_search(queries, qlens, rank_rows, count, primary: int,
                       n: int, ftab_lo, ftab_hi, ftab_k: int, n_steps: int,
                       steps=None):
    """Exact-match SA intervals [lo, hi), (B,) int64, of queries (B, L)
    int32 with lengths qlens (B,) int32 or int64: lanes of length >=
    ``ftab_k`` start from their k-symbol suffix's entry of ``ftab_lo`` /
    ``ftab_hi`` (int32[4^k]; k = 0: none), the rest from the full range;
    at most ``n_steps`` steps. ``steps`` ((B,) int16 or None) receives the
    steps each lane took."""
    dev = queries.device
    B, L = queries.shape if queries.dim() == 2 else (0, 0)
    _check_fm_walk("fm_backward_search", dev, B, steps, queries, qlens)
    _check_fm_index(rank_rows, count, n, dev)
    if ftab_k:
        _check(ftab_lo, "ftab_lo", torch.int32, (4 ** ftab_k,), dev)
        _check(ftab_hi, "ftab_hi", torch.int32, (4 ** ftab_k,), dev)
    lo = torch.empty(B, dtype=torch.int64, device=dev)
    hi = torch.empty(B, dtype=torch.int64, device=dev)
    if B:
        _fm_launch("nvbt_fm_backward_search", "fm_backward_search", dev,
                   queries, L, qlens, int(qlens.dtype == torch.int64), B,
                   rank_rows, rank_rows.shape[0], count, primary, n,
                   ftab_lo if ftab_k else None, ftab_hi if ftab_k else None,
                   ftab_k, n_steps, lo, hi, steps)
        fm_backward_search.launches += 1
    return lo, hi


fm_backward_search.launches = 0


def fm_locate(rows, rank_rows, count, primary: int, n: int, ssa_rows,
              ssa_vals, sa_interval: int, steps=None):
    """SA values of SA rows (int64, any shape, clamped to [0, n]) by an LF
    walk of at most ``sa_interval`` steps to a marked row (``ssa_rows``
    (nw, 2) int32: marks word and exclusive popcount; ``ssa_vals`` int32):
    (positions int64, resolved bool), of the rows' shape. ``steps`` ((rows
    numel,) int16 or None) receives the steps each lane took."""
    dev = rows.device
    B = rows.numel()
    _check_fm_walk("fm_locate", dev, B, steps)
    _check(rows, "rows", torch.int64, rows.shape, dev)
    _check_fm_index(rank_rows, count, n, dev)
    _check(ssa_rows, "ssa_rows", torch.int32, (ssa_rows.shape[0], 2), dev)
    _check(ssa_vals, "ssa_vals", torch.int32, (ssa_vals.shape[0],), dev)
    pos = torch.empty(rows.shape, dtype=torch.int64, device=dev)
    done = torch.empty(rows.shape, dtype=torch.bool, device=dev)
    if B:
        _fm_launch("nvbt_fm_locate", "fm_locate", dev, rows, B, rank_rows,
                   rank_rows.shape[0], count, primary, n, ssa_rows,
                   ssa_rows.shape[0], ssa_vals, ssa_vals.shape[0],
                   sa_interval, pos, done, steps)
        fm_locate.launches += 1
    return pos, done


fm_locate.launches = 0


def fm_search_1mm_topk(queries, qlens, rank_rows, count, primary: int,
                       n: int, n_approx: int, K: int, steps=None):
    """Approx-hybrid 1-mismatch search with top-K survivors of queries
    (B, L) int32, lengths (B,) int32 or int64: (exact_lo, exact_hi, mm_lo,
    mm_hi), int64, mm_* (B, K) with empty slots at lo == hi == 0; the first
    K nonempty (j, delta) branches, j < ``n_approx``. Takes n_approx <= L
    and K <= 3 n_approx. ``steps`` ((B,) int16 or None) receives the steps
    each lane took."""
    dev = queries.device
    B, L = queries.shape if queries.dim() == 2 else (0, 0)
    _check_fm_walk("fm_search_1mm_topk", dev, B, steps, queries, qlens)
    _check_fm_index(rank_rows, count, n, dev)
    if not 0 <= n_approx <= L or not 0 <= K <= 3 * n_approx:
        raise ValueError(f"fm_search_1mm_topk: n_approx {n_approx} and K "
                         f"{K} out of range for L {L}")
    exact_lo = torch.empty(B, dtype=torch.int64, device=dev)
    exact_hi = torch.empty(B, dtype=torch.int64, device=dev)
    mm_lo = torch.empty((B, K), dtype=torch.int64, device=dev)
    mm_hi = torch.empty((B, K), dtype=torch.int64, device=dev)
    if B:
        # the exact walk's states at the positions j < n_approx
        states = torch.empty((max(n_approx, 1), B, 2), dtype=torch.int32,
                             device=dev)
        _fm_launch("nvbt_fm_search_1mm_topk", "fm_search_1mm_topk", dev,
                   queries, L, qlens, int(qlens.dtype == torch.int64), B,
                   rank_rows, rank_rows.shape[0], count, primary, n,
                   n_approx, K, states, exact_lo, exact_hi, mm_lo, mm_hi,
                   steps)
        fm_search_1mm_topk.launches += 1
    return exact_lo, exact_hi, mm_lo, mm_hi


fm_search_1mm_topk.launches = 0


# ---------------------------------------------------------------------------
# The dedup vote (no TPU kernel: the JAX package's dedup_half is jnp)
# ---------------------------------------------------------------------------

# the largest row the kernel takes: rows past 256 columns keep 12 bytes a
# column, in whole warps of 32, in the 227 KB of shared memory a block may
# take on an H100
VOTE_MAX_COLS = 232448 // (32 * 12) * 32
# "no position": larger than any genome position plus tolerance
_BIG = torch.iinfo(torch.int64).max


def vote_reps(pv, valid, tol: int, n_reps: int, rounds=None):
    """Evidence-ranked locus tournament over each row of (R, n) candidates
    (``vote_reps_plain``'s contract and results, bit for bit): pv (R, n)
    int64 positions, valid (R, n) bool, both contiguous. Returns (reps
    (R, n_reps) int64, rep_valid (R, n_reps) bool). CUDA tensors: one
    launch of ``csrc/vote_reps.cu`` (rows of at most ``VOTE_MAX_COLS``
    columns); ``rounds`` ((R,) int32 or None) receives the rounds each row
    played before it left. CPU tensors: the plain version (no
    ``rounds``)."""
    if pv.device.type == "cpu":
        if rounds is not None:
            raise ValueError("vote_reps: rounds are counted on cuda only")
        return vote_reps_plain(pv, valid, tol, n_reps)
    dev = pv.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if pv.dim() != 2:
        raise ValueError(f"vote_reps: pv must be (R, n), got "
                         f"{tuple(pv.shape)}")
    R, n = pv.shape
    _check(pv, "pv", torch.int64, (R, n), dev)
    _check(valid, "valid", torch.bool, (R, n), dev)
    if not 1 <= n <= VOTE_MAX_COLS:
        raise ValueError(f"vote_reps: {n} candidates a row; the kernel "
                         f"holds 1 to {VOTE_MAX_COLS} (a row past 256 "
                         f"keeps 12 bytes a candidate in shared memory)")
    if n_reps < 1 or R >= 2**31:
        raise ValueError(f"vote_reps: n_reps {n_reps} (>= 1) or {R} rows "
                         f"(< 2^31) out of range")
    if rounds is not None:
        _check(rounds, "rounds", torch.int32, (R,), dev)
    reps = torch.empty((R, n_reps), dtype=torch.int64, device=dev)
    rep_valid = torch.empty((R, n_reps), dtype=torch.bool, device=dev)
    if R:
        rc = _lib("vote_reps").nvbt_vote_reps(
            pv.data_ptr(), valid.data_ptr(), R, n, tol, n_reps,
            reps.data_ptr(), rep_valid.data_ptr(),
            None if rounds is None else rounds.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"vote_reps: kernel launch failed with CUDA "
                               f"error {rc}")
        vote_reps.launches += 1
    return reps, rep_valid


vote_reps.launches = 0


def _absdiff(a, b):
    return torch.maximum(a, b) - torch.minimum(a, b)


def vote_reps_plain(pv, valid, tol: int, n_reps: int):
    """Evidence-ranked locus tournament over the last axis.

    Each candidate's vote is the number of valid candidates within ``tol``;
    each round picks the (max votes, leftmost) cluster, emits its leftmost
    member and retires its members. Returns (reps, rep_valid) with a new
    last axis of ``n_reps``; missing reps are 0 / False."""
    pv = torch.where(valid, pv, _BIG)
    near = (_absdiff(pv[..., :, None], pv[..., None, :]) <= tol) & \
        valid[..., None, :]
    votes = torch.where(valid, near.sum(dim=-1, dtype=torch.int32), -1)
    reps, valids = [], []
    for _ in range(n_reps):
        m_v = votes.max(dim=-1).values
        any_v = m_v > 0
        picked = votes == m_v[..., None]
        sel = torch.where(picked, pv, _BIG).min(dim=-1).values
        members = (_absdiff(pv, sel[..., None]) <= tol) & (votes >= 0)
        rep = torch.where(members, pv, _BIG).min(dim=-1).values
        reps.append(torch.where(any_v, rep, _BIG))
        valids.append(any_v)
        votes = torch.where(members, -1, votes)
    rep = torch.stack(reps, dim=-1)
    rep_valid = torch.stack(valids, dim=-1) & (rep < _BIG)
    return torch.where(rep_valid, rep, 0), rep_valid
