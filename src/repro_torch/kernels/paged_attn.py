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
the card it launches the kernel, once per call, on clusters of CTAs that
split each row's pages (:func:`paged_plan`, from the shapes alone, so the
launch reads nothing back from the card), and adds one to
``paged_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ..models.common import single_chunk_attention

__all__ = ["paged_decode_attention", "paged_decode_attention_plain", "PagedPlan", "paged_plan",
           "MAX_DH", "MAX_CTAS"]

SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
SM_SMEM_BYTES = 233_472  # shared memory of an H100 SM, 1 KB of it reserved for each resident block
STAGES, TILE_BYTES, HEADS = 3, 16384, 4  # kStages, kTileBytes, kHeads in csrc/paged_attn.cu
MAX_DH = 256  # a lane holds at most 8 of a row's Dh elements
#: the largest cluster :func:`paged_plan` picks (a forced plan may take 16)
MAX_CTAS = 8


class PagedPlan(NamedTuple):
    """The launch of :func:`paged_decode_attention`: clusters of ``ctas``
    (K) CTAs, one per (row, KV head, group of at most 4 of its query
    heads; ``groups`` a KV head), CTA r taking the row's ``pages`` pages
    from r · ``pages``; its scores in shared memory (``smem_scores``) or a
    device-memory scratch, and its shared-memory ``bytes``."""
    ctas: int
    groups: int
    pages: int
    smem_scores: bool
    bytes: int


def _cta_bytes(dh: int, es: int, rep: int, page: int, ppc: int, k: int, smem_scores: bool) -> int:
    """A CTA's shared memory (``paged_layout`` in ``csrc/paged_attn.cu``):
    the ring of staged tiles, the share's page ids, its scores where they
    stay on chip, the cluster's maxima and sums, and the K shares' outputs
    the leader adds."""
    a16 = lambda n: -(-n // 16) * 16
    scores = a16(min(rep, HEADS) * ppc * page * 4) if smem_scores else 0
    return STAGES * TILE_BYTES + a16(ppc * 4) + scores + 512 + k * (HEADS * dh + HEADS) * 4


@functools.lru_cache(maxsize=256)
def paged_plan(b: int, h: int, kvh: int, dh: int, np_: int, page: int, es: int, sms: int, *,
               ctas: int | None = None) -> PagedPlan:
    """The clusters of :func:`paged_decode_attention` from the shapes alone
    (no length is read): ``ctas`` where given, else the largest power of
    two K <= :data:`MAX_CTAS` and <= NP whose B·KV·groups·K CTAs fit the
    card's ``sms`` SMs once, doubled while a CTA is too large for two to
    share an SM (two keep twice the loads in flight): K = 4 at B = 4,
    KV = 8, K = 2 at 32 rows of 256 pages (``launch/time_kernels.py:
    paged_sweep``).  The scores stay in shared memory where they fit
    beside the ring."""
    rep = h // kvh
    groups = -(-rep // HEADS)
    if ctas is None:
        k = 1
        while 2 * k <= MAX_CTAS and 2 * k <= np_ and b * kvh * groups * 2 * k <= sms:
            k *= 2
        while 2 * k <= MAX_CTAS and 2 * k <= np_ and \
                2 * (_cta_bytes(dh, es, rep, page, -(-np_ // k), k, True) + 1024) > SM_SMEM_BYTES:
            k *= 2
    elif ctas in (1, 2, 4, 8, 16):
        k = ctas
    else:
        raise ValueError(f"paged_plan: clusters of {ctas} CTAs; 1, 2, 4, 8 or 16")
    ppc = -(-np_ // k)
    smem = _cta_bytes(dh, es, rep, page, ppc, k, True) <= SMEM_BYTES
    nbytes = _cta_bytes(dh, es, rep, page, ppc, k, smem)
    if nbytes > SMEM_BYTES:
        raise ValueError(f"paged_plan: a CTA of clusters of {k} needs {nbytes} bytes of shared memory")
    return PagedPlan(k, groups, ppc, smem, nbytes)


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


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q (B, H, Dh) current-token queries; k_pages/v_pages (P, page, KV, Dh)
    the shared pool; page_table (B, NP) int32, −1 a hole; lengths (B,)
    int32, the live tokens of each row.  Returns (B, H·Dh) in q's dtype
    (fp32 or bf16, the pool's dtype).  On the card: one launch of clusters
    of CTAs over each row's pages (:func:`paged_plan`)."""
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
    if dh * q.element_size() % 16 or dh > MAX_DH:
        raise ValueError(f"{name}: head width {dh} must be a multiple of 16 bytes and at most {MAX_DH}")
    plan = paged_plan(b, h, kvh, dh, page_table.shape[1], page, q.element_size(),
                      _build.sm_count(q.device.index if q.device.index is not None
                                      else torch.cuda.current_device()))
    return _attend(q, k_pages, v_pages, page_table, lengths, plan)


def _attend(q, k_pages, v_pages, page_table, lengths, plan: PagedPlan) -> torch.Tensor:
    """:func:`paged_decode_attention` on the card by ``plan`` (one launch),
    so that the tests and the sweeps can launch any cluster size; the C
    entry's report (K, groups, pages a CTA, scores in shared memory,
    shared-memory bytes a CTA, clusters the card holds at once) in
    ``paged_decode_attention.last_plan``."""
    name = "paged_decode_attention"
    b, h, dh = q.shape
    p, page, kvh, _ = k_pages.shape
    np_ = page_table.shape[1]
    out = torch.empty((b, h * dh), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    scratch = out if plan.smem_scores else torch.empty(
        b * kvh * plan.groups * plan.ctas * min(h // kvh, HEADS) * plan.pages * page,
        dtype=torch.float32, device=q.device)
    qc, kc, vc = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    pt, ln = page_table.contiguous(), lengths.contiguous()
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must start on a 16-byte boundary (16-byte loads)")
    lib = _build.library()
    got = (ctypes.c_int * 6)()
    try:
        with _build.device_guard(q.device):
            code = lib.ebv_paged_decode_attention(
                qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), pt.data_ptr(), ln.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), int(plan.smem_scores), b, h, kvh, dh, p, page,
                np_, plan.ctas, ctypes.c_float(dh ** -0.5), int(q.dtype == torch.bfloat16), got,
                torch.cuda.current_stream().cuda_stream)
    finally:
        paged_decode_attention.last_plan = tuple(got)
    _build.check(code, "ebv_paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.last_plan = None
