"""Decode attention over a paged KV pool, the paged serving engine's
attention: the CUDA kernel (``csrc/paged_attn.cu``) and its plain PyTorch
version.

The engine keeps each slot's K/V as fixed-size pages scattered through a
shared pool, and each row's page table names its pages.  For row ``b`` the
function gathers the pages ``page_table[b]`` names into one contiguous
(NP·page) KV view and runs the single-chunk masked softmax of
:func:`repro_torch.models.common.single_chunk_attention` over it:

* a −1 entry of the page table is a hole: it gathers zero K and V, so its
  positions score exactly 0 and take part in the softmax;
* positions ``j >= lengths[b]`` score ``MASK_VALUE``, whose
  ``exp(MASK - m)`` is exactly 0.

The plain version gathers every page of the row, as the reference does; on
the same inputs it computes the dense decode path's op sequence, so the
port's paged serve is bitwise equal to its dense serve on the CPU.  The
kernel reads only the pages a row's live length reaches (the same values
unless a skipped V holds inf or NaN, as 0·inf is NaN), and sums in
another order: normwise within ~1e-6 of the plain version in fp32 and
within a few bf16 units in bf16.

The wrapper runs the plain version for tensors on the CPU; for tensors on
the card it launches the kernel, once per call, and adds one to
``paged_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..models.common import single_chunk_attention

__all__ = ["paged_decode_attention", "paged_decode_attention_plain", "SCORE_SMEM_BYTES",
           "MAX_REP_X_DH", "MAX_DH", "scores_in_shared_memory"]

#: dynamic shared memory a block may give its rows' scores; longer rows keep
#: their scores in a device-memory scratch instead (the same single launch)
SCORE_SMEM_BYTES = 96 * 1024
#: query heads x head width one block accumulates (16 outputs a thread)
MAX_REP_X_DH = 16 * 256
MAX_DH = 256  # a staged tile of 64 positions holds 64 x (Dh + 1) floats


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths) -> torch.Tensor:
    """Plain version: gather every page of each row (holes zeroed), then the
    single-chunk masked softmax.  q (B, H, Dh); pools (P, page, KV, Dh);
    page_table (B, NP) int32; lengths (B,) int32.  Returns (B, H·Dh)."""
    b, h, dh = q.shape
    np_ = page_table.shape[1]
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    safe = page_table.clamp(0, k_pages.shape[0] - 1).long()  # the reference's gather clamps
    hole = (page_table < 0)[..., None, None, None]
    ks = k_pages[safe].masked_fill(hole, 0).reshape(b, np_ * page, kvh, dh)
    vs = v_pages[safe].masked_fill(hole, 0).reshape(b, np_ * page, kvh, dh)
    live = torch.arange(np_ * page, device=q.device) < lengths.to(q.device)[:, None]  # (B, S)
    qg = q.reshape(b, kvh, h // kvh, 1, dh)
    out = single_chunk_attention(qg, ks, vs, live[:, None, None, None, :])
    return out.reshape(b, h * dh).to(q.dtype)


def scores_in_shared_memory(rep: int, np_: int, page: int) -> bool:
    """Whether a block keeps its ``rep`` heads' scores over the row's
    ``np_ * page`` positions in shared memory (else in device memory)."""
    return rep * np_ * page * 4 <= SCORE_SMEM_BYTES


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q (B, H, Dh) current-token queries; k_pages/v_pages (P, page, KV, Dh)
    the shared pool; page_table (B, NP) int32, −1 a hole; lengths (B,)
    int32, the live tokens of each row.  Returns (B, H·Dh) in q's dtype
    (fp32 or bf16, the pool's dtype).  On the card: one block per (row,
    KV head), one launch."""
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape or page_table.ndim != 2 \
            or lengths.shape != (q.shape[0],) or page_table.shape[0] != q.shape[0] \
            or q.shape[2] != k_pages.shape[3] or q.shape[1] % k_pages.shape[2]:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pools {tuple(k_pages.shape)} "
                         f"and {tuple(v_pages.shape)}, page table {tuple(page_table.shape)} and "
                         f"lengths {tuple(lengths.shape)} do not fit together")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths)
    name = "paged_decode_attention"
    for t in (k_pages, v_pages, page_table, lengths):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors lie on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q and the pools must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and lengths must be int32")
    b, h, dh = q.shape
    p, page, kvh, _ = k_pages.shape
    np_ = page_table.shape[1]
    rep = h // kvh
    if dh * q.element_size() % 16 or dh > MAX_DH or rep * dh > MAX_REP_X_DH:
        raise ValueError(f"{name}: head width {dh} must be a multiple of 16 bytes and at most "
                         f"{MAX_DH}, and (H/KV)·Dh = {rep * dh} at most {MAX_REP_X_DH}")
    out = torch.empty((b, h * dh), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    smem = scores_in_shared_memory(rep, np_, page)
    scratch = out if smem else torch.empty((b, kvh, rep, np_ * page), dtype=torch.float32,
                                           device=q.device)
    qc, kc, vc = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    pt, ln = page_table.contiguous(), lengths.contiguous()
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must start on a 16-byte boundary (16-byte loads)")
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.ebv_paged_decode_attention(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), pt.data_ptr(), ln.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), int(smem), b, h, kvh, dh, p, page, np_,
            ctypes.c_float(dh ** -0.5), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ebv_paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
