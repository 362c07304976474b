"""Device kernels of ``-p p`` placement on a direct table.

Two parts:

* the **plain PyTorch versions**, under the names and with the semantics
  of the jitted functions of ``rappas_tpu/place/engine.py``
  (:func:`kmer_rows_packed`, :func:`kmer_rows`, :func:`accumulate`,
  :func:`finalize`, :func:`pack_wire`, :func:`alt_delta_rows`,
  :func:`ambiguous_contrib`, :func:`ambiguous_pass`).  They run on any
  device; the tests hold them against the JAX functions, and
  ``chip_smoke.py`` holds the kernels against them on the card;
* the **wrappers** of the four CUDA kernels of ``csrc/``
  (:func:`accumulate_packed`, :func:`accumulate_codes`,
  :func:`finalize_wire`, :func:`ambiguous_pass_`).  A wrapper given CPU
  tensors computes its plain composition; given CUDA tensors it launches
  its kernel on the current stream or raises -- it never falls back.
  Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import numpy as np
import torch

from rappas_tpu_torch.db import DELTA_TINY

LOG2_10 = float(np.float32(np.log2(10.0)))
INV_LOG2_10 = float(np.float32(1.0 / np.log2(10.0)))

#: kernel launches, one count per kernel, added where the wrapper
#: launches it (plain-version calls on CPU tensors do not count)
LAUNCHES = {"accumulate_packed": 0, "accumulate_codes": 0,
            "finalize_wire": 0, "ambiguous_pass": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ====================================================================== #
# plain PyTorch versions (rappas_tpu/place/engine.py names)
# ====================================================================== #

def kmer_rows(codes: torch.Tensor, k: int, n_states: int,
              n_rows: int) -> torch.Tensor:
    """[B, L] int8 codes -> [B, Q] int32 row indices into D; windows
    holding a negative code (ambiguity or padding) map to the all-zero
    miss row ``n_rows - 1``."""
    B, L = codes.shape
    Q = L - k + 1
    c = codes.to(torch.int32)
    idx = torch.zeros((B, Q), dtype=torch.int32, device=codes.device)
    valid = torch.ones((B, Q), dtype=torch.bool, device=codes.device)
    for i in range(k):
        w = c[:, i:i + Q]
        valid &= w >= 0
        idx = idx * n_states + w.clamp_min(0)
    return idx.masked_fill(~valid, n_rows - 1)


def kmer_rows_packed(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                     n_states: int, n_rows: int,
                     length: int) -> torch.Tensor:
    """2-bit packed reads (base i at bits ``2*(i%4)`` of byte ``i//4``)
    -> [B, Q] int32 row indices; windows past ``lengths[b] - k`` map to
    the miss row."""
    B = packed.shape[0]
    Q = length - k + 1
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
                          device=packed.device)
    codes = ((packed.to(torch.int32)[:, :, None] >> shifts) & 3)
    codes = codes.reshape(B, -1)[:, :length]
    idx = torch.zeros((B, Q), dtype=torch.int32, device=packed.device)
    for i in range(k):
        idx = idx * n_states + codes[:, i:i + Q]
    pos = torch.arange(Q, device=packed.device)[None, :]
    valid = pos <= (lengths.to(torch.int64)[:, None] - k)
    return idx.masked_fill(~valid, n_rows - 1)


def accumulate(D: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``sum_q D[rows[:, q], :]`` -> f32[B, E] (materialises [B, Q, E])."""
    B, Q = rows.shape
    g = D.index_select(0, rows.reshape(-1)).reshape(B, Q, D.shape[1])
    return g.to(torch.float32).sum(dim=1)


def finalize(acc: torch.Tensor, lengths: torch.Tensor, thr: torch.Tensor,
             k: int, keep_at_most: int):
    """acc [B, E] -> (top edges, top scores, LWR, |L|).

    ``S = Q*thr + acc`` with ``Q = len - k + 1``; unmatched edges
    (``acc == 0``) are excluded; top-K by a stable descending sort, so
    ties go to the lower edge index as ``lax.top_k`` does; LWR over the
    valid rows with the max shift."""
    E = acc.shape[1]
    Q = (lengths - (k - 1)).to(torch.float32)
    matched = acc > 0
    n_matched = matched.sum(dim=1).to(torch.int32)
    scores = Q[:, None] * thr + acc
    masked = torch.where(matched, scores,
                         torch.full_like(scores, float("-inf")))
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    K = min(keep_at_most, E)
    top_scores, top_idx = vals[:, :K], idx[:, :K]
    valid = torch.isfinite(top_scores)
    shift = top_scores[:, :1]
    w = torch.where(valid, torch.exp2((top_scores - shift) * LOG2_10),
                    torch.zeros_like(top_scores))
    lwr = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-30)
    top_edges = torch.where(valid, top_idx,
                            torch.full_like(top_idx, -1)).to(torch.int32)
    return top_edges, top_scores, lwr, n_matched


def pack_wire(te: torch.Tensor, ts: torch.Tensor, lwr: torch.Tensor,
              nm: torch.Tensor) -> torch.Tensor:
    """One int32 [B, K + ceil(K/2) + 1] array per batch: scores bit-cast
    from f32, edge ids two u16 per word (low half first, 65535 = no
    edge), |L|.  LWR is dropped; the host recomputes it."""
    B, K = te.shape
    edges = torch.where(te < 0, torch.full_like(te, 65535),
                        te).to(torch.int64)
    if K % 2:
        edges = torch.cat([edges, torch.full((B, 1), 65535,
                                             dtype=torch.int64,
                                             device=te.device)], dim=1)
    pairs = edges.reshape(B, -1, 2)
    word = pairs[:, :, 0] | (pairs[:, :, 1] << 16)
    ew = torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)
    sw = ts.contiguous().view(torch.int32)
    return torch.cat([sw, ew, nm.to(torch.int32)[:, None]], dim=1)


def alt_delta_rows(D: torch.Tensor, scale,
                   alt_rows: torch.Tensor) -> torch.Tensor:
    """[n_alt, E] f32 delta rows of the ambiguity alternatives."""
    return D.index_select(0, alt_rows).to(torch.float32) * scale


def ambiguous_contrib(rows: torch.Tensor, alt_win: torch.Tensor,
                      win_inv_w: torch.Tensor,
                      win_is_mean: torch.Tensor) -> torch.Tensor:
    """[n_win, E] per-window contributions: mean mode
    ``log10(sum_alt 10^delta / W)``, max mode ``max_alt delta``; an edge
    hit by any alternative is floored at DELTA_TINY, others are 0
    (``PlacementProcess.java:1129-1236``)."""
    n_win = win_is_mean.shape[0]
    E = rows.shape[1]
    ten = torch.exp2(rows * LOG2_10)
    sums = rows.new_zeros((n_win, E)).index_add_(0, alt_win, ten)
    maxs = rows.new_full((n_win, E), float("-inf")).scatter_reduce_(
        0, alt_win.to(torch.int64)[:, None].expand(-1, E), rows,
        reduce="amax")
    mean = torch.log2(torch.clamp_min(sums * win_inv_w[:, None],
                                      1e-30)) * INV_LOG2_10
    contrib = torch.where(win_is_mean.to(torch.bool)[:, None], mean, maxs)
    hit = maxs > 0
    return torch.where(hit, torch.clamp_min(contrib, float(DELTA_TINY)),
                       torch.zeros_like(contrib))


def ambiguous_pass(rows: torch.Tensor, alt_win: torch.Tensor,
                   win_read: torch.Tensor, win_inv_w: torch.Tensor,
                   win_is_mean: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """``acc`` plus the window contributions summed by read."""
    contrib = ambiguous_contrib(rows, alt_win, win_inv_w, win_is_mean)
    return acc + torch.zeros_like(acc).index_add_(0, win_read, contrib)


# ====================================================================== #
# kernel wrappers
# ====================================================================== #

def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or \
            not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"(contiguous={t.is_contiguous()})")


def _launch(name: str, fn, *args) -> None:
    from rappas_tpu_torch._kernels import lib
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib().rp_error_string(err).decode()})")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _store(acc, dest, part):
    if dest is None:
        return acc.copy_(part)
    return acc.index_copy_(0, dest.to(torch.int64), part)


def _out(D, acc, dest, B):
    if acc is None:
        if dest is not None:
            raise ValueError("dest needs acc")
        acc = torch.empty((B, D.shape[1]), dtype=torch.float32,
                          device=D.device)
    return acc


def accumulate_packed(D: torch.Tensor, packed: torch.Tensor,
                      lengths: torch.Tensor, length: int, k: int,
                      scale: float = 1.0, acc: torch.Tensor | None = None,
                      dest: torch.Tensor | None = None) -> torch.Tensor:
    """K1 (``csrc/accumulate.cu``): ``kmer_rows_packed`` + ``accumulate``
    (times ``scale``) of 2-bit packed DNA reads of padded length
    ``length``.  Writes row ``dest[b]`` of ``acc`` (row ``b`` when
    ``dest`` is None; a new [B, E] tensor when ``acc`` is None)."""
    B = packed.shape[0]
    acc = _out(D, acc, dest, B)
    opt = [t for t in (dest,) if t is not None]
    if not _on_card(D, packed, lengths, acc, *opt):
        rows = kmer_rows_packed(packed, lengths, k, 4, D.shape[0], length)
        return _store(acc, dest, accumulate(D, rows) * scale)
    E = D.shape[1]
    _check(D, "D", torch.float32, tuple(D.shape))
    _check(packed, "packed", torch.uint8, (B, -(-length // 4)))
    _check(lengths, "lengths", torch.int32, (B,))
    _check(acc, "acc", torch.float32, (acc.shape[0], E))
    if dest is not None:
        _check(dest, "dest", torch.int32, (B,))
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_packed", lib().rp_accumulate_packed,
            D.data_ptr(), E, D.shape[0] - 1, packed.data_ptr(),
            packed.stride(0), lengths.data_ptr(), B, length, k,
            float(scale), _ptr(dest), acc.data_ptr(), _stream(D))
    return acc


def accumulate_codes(D: torch.Tensor, codes: torch.Tensor, k: int,
                     n_states: int, scale: float = 1.0,
                     acc: torch.Tensor | None = None,
                     dest: torch.Tensor | None = None) -> torch.Tensor:
    """K2 (``csrc/accumulate.cu``): ``kmer_rows`` + ``accumulate`` (times
    ``scale``) of int8 state codes [B, L]; ``acc``/``dest`` as in
    :func:`accumulate_packed`."""
    B, L = codes.shape
    acc = _out(D, acc, dest, B)
    opt = [t for t in (dest,) if t is not None]
    if not _on_card(D, codes, acc, *opt):
        rows = kmer_rows(codes, k, n_states, D.shape[0])
        return _store(acc, dest, accumulate(D, rows) * scale)
    E = D.shape[1]
    _check(D, "D", torch.float32, tuple(D.shape))
    _check(codes, "codes", torch.int8, (B, L))
    _check(acc, "acc", torch.float32, (acc.shape[0], E))
    if dest is not None:
        _check(dest, "dest", torch.int32, (B,))
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_codes", lib().rp_accumulate_codes,
            D.data_ptr(), E, D.shape[0] - 1, codes.data_ptr(), B, L, k,
            n_states, float(scale), _ptr(dest), acc.data_ptr(), _stream(D))
    return acc


def finalize_wire(acc: torch.Tensor, lengths: torch.Tensor, thr: float,
                  k: int, keep_at_most: int) -> torch.Tensor:
    """K3 (``csrc/finalize.cu``): ``pack_wire(*finalize(...))`` -> int32
    [B, K + ceil(K/2) + 1] with ``K = min(keep_at_most, E)``."""
    B, E = acc.shape
    if E >= 65535:
        raise ValueError("the wire format packs edge ids as u16: "
                         f"{E} edge slots do not fit")
    K = min(keep_at_most, E)
    if not _on_card(acc, lengths):
        thr_t = torch.tensor(thr, dtype=torch.float32)
        return pack_wire(*finalize(acc, lengths, thr_t, k, keep_at_most))
    _check(acc, "acc", torch.float32, (B, E))
    _check(lengths, "lengths", torch.int32, (B,))
    wire = torch.empty((B, K + (K + 1) // 2 + 1), dtype=torch.int32,
                       device=acc.device)
    from rappas_tpu_torch._kernels import lib
    _launch("finalize_wire", lib().rp_finalize_wire, acc.data_ptr(), B, E,
            lengths.data_ptr(), float(thr), k, K, wire.data_ptr(),
            _stream(acc))
    return wire


def ambiguous_pass_(acc: torch.Tensor, D: torch.Tensor, scale: float,
                    alt_rows: torch.Tensor, win_off: torch.Tensor,
                    win_read: torch.Tensor, win_inv_w: torch.Tensor,
                    win_is_mean: torch.Tensor) -> torch.Tensor:
    """K4 (``csrc/ambiguous.cu``): ``ambiguous_pass(alt_delta_rows(D,
    scale, alt_rows), ...)`` added into ``acc`` IN PLACE; returns ``acc``.

    Window ``w`` owns alternatives ``win_off[w] .. win_off[w + 1]``
    (``alt_win`` as CSR offsets).  On the card the adds are atomic, so
    their order -- and the last bits of a read's sum over several
    windows -- varies from run to run."""
    n_win = win_read.shape[0]
    if not _on_card(acc, D, alt_rows, win_off, win_read, win_inv_w,
                    win_is_mean):
        counts = (win_off[1:] - win_off[:-1]).to(torch.int64)
        alt_win = torch.repeat_interleave(
            torch.arange(n_win, device=acc.device), counts)
        return acc.copy_(ambiguous_pass(
            alt_delta_rows(D, scale, alt_rows), alt_win, win_read,
            win_inv_w, win_is_mean, acc))
    E = D.shape[1]
    _check(acc, "acc", torch.float32, (acc.shape[0], E))
    _check(D, "D", torch.float32, tuple(D.shape))
    _check(alt_rows, "alt_rows", torch.int32, (alt_rows.shape[0],))
    _check(win_off, "win_off", torch.int32, (n_win + 1,))
    _check(win_read, "win_read", torch.int32, (n_win,))
    _check(win_inv_w, "win_inv_w", torch.float32, (n_win,))
    _check(win_is_mean, "win_is_mean", torch.uint8, (n_win,))
    from rappas_tpu_torch._kernels import lib
    _launch("ambiguous_pass", lib().rp_ambiguous_pass, D.data_ptr(), E,
            float(scale), alt_rows.data_ptr(), win_off.data_ptr(),
            win_read.data_ptr(), win_inv_w.data_ptr(),
            win_is_mean.data_ptr(), n_win, acc.data_ptr(), _stream(acc))
    return acc
