"""Paged decode attention: a hand-written Hopper kernel and its plain
version.

The port's own kernel (no TPU counterpart): the JAX decode step gathers a
row's whole paged context and attends with einsums and a masked softmax
(``mxnet_tpu/serving/decode/model.py:113-155`` ``_kv_gather``, the
``attend`` of ``step_math`` :303-315 and ``verify_math`` :374-384).
``csrc/paged_attention.cu`` reads the page table and the pools in place,
dequantises int8 and fp8 pools after the copy, and stops at the row's last
live position.  It splits each row's context into chunks of 64 keys fixed
in absolute position, one block a (chunk, head, row), and folds each
query's chunk partials in chunk order inside the same launch, so a
query's bits depend on its position alone (see the source).  The partials
and the fold's tickets are the wrapper's: allocated per (device, stream)
at its first call, grown when a call needs more, and kept (the kernel
leaves the tickets at zero).

The new K/V rows are scattered into the pools before the call (the
caller's ``index_put_``, as ``_kv_scatter`` does).  On a CUDA tensor
:func:`paged_attention` launches the kernel or raises; it never falls back.
On a CPU tensor it runs :func:`_reference`: ``_kv_gather``, the einsums and
the masked softmax, as the JAX step has them.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["paged_attention", "gather_pages", "pool_bytes"]

_NEG = -1e30

# scratch a (device, stream) keeps (``_build.stream_scratch``): at least
# 4 MB of chunk partials and 4096 tickets, grown to a power of two
_PARTIAL_MIN = 1 << 20
_TICKET_MIN = 1 << 12
_scratch = {}
_lib = None
_chunk = None


def pool_bytes(t):
    """A pool (or fp8 codes) as a tensor that torch indexes, scatters and
    copies on every device: fp8 through its bytes, anything else as it
    is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _dequantize(vals, pool_dtype, sides):
    """Gathered pool values ``(B, L, H, D)`` to fp32 through the gathered
    sidecars ``(B, L)``: ``q * scale + mid`` (int8), ``q * scale`` (fp8)."""
    if pool_dtype == torch.float8_e4m3fn:
        q = vals.view(torch.float8_e4m3fn).float()
        return q * sides[0][..., None, None]
    if pool_dtype == torch.int8:
        return (vals.float() * sides[0][..., None, None]
                + sides[1][..., None, None])
    return vals


def gather_pages(k_pool, v_pool, tables, quant=None):
    """One layer's whole paged context ``(B, n_tab * page_size, H, D)`` for
    K and V in fp32 (``_kv_gather``).  ``quant`` is ``None``, ``(k_scale,
    k_mid, v_scale, v_mid)`` (int8) or ``(k_scale, v_scale)`` (fp8), each
    ``(pages, page_size)``."""
    b = tables.shape[0]
    ps, h, d = k_pool.shape[1:]
    lctx = tables.shape[1] * ps

    def g(pool):
        return pool_bytes(pool)[tables].reshape(b, lctx, h, d)

    def side(t):
        return t[tables].reshape(b, lctx)

    if quant is None:
        return g(k_pool), g(v_pool)
    half = len(quant) // 2
    return (_dequantize(g(k_pool), k_pool.dtype,
                        [side(t) for t in quant[:half]]),
            _dequantize(g(v_pool), v_pool.dtype,
                        [side(t) for t in quant[half:]]))


def _reference(q, k_pool, v_pool, tables, positions, quant=None):
    """``_kv_gather`` + ``einsum`` + masked softmax + ``einsum``: query ``j``
    of row ``b`` sees context positions ``<= positions[b] + j``."""
    b, nq = q.shape[:2]
    kg, vg = gather_pages(k_pool, v_pool, tables, quant)
    lctx = kg.shape[1]
    pos = positions.long()[:, None] + torch.arange(nq, device=q.device)
    mask = torch.arange(lctx, device=q.device)[None, None, :] <= \
        pos[:, :, None]
    s = torch.einsum("bqhd,blhd->bhql", q, kg)
    s = torch.where(mask[:, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhql,blhd->bqhd", p, vg)


def _quant_code(pool, quant):
    if quant is None:
        if pool.dtype != torch.float32:
            raise TypeError(f"an unquantised pool must be float32, got "
                            f"{pool.dtype}")
        return 0
    if pool.dtype == torch.int8 and len(quant) == 4:
        return 1
    if pool.dtype == torch.float8_e4m3fn and len(quant) == 2:
        return 2
    raise TypeError(f"pool {pool.dtype} with {len(quant)} sidecars: want "
                    f"int8 with 4 or float8_e4m3fn with 2")


def _grown(need, least):
    """``need`` rounded up to a power of two, at least ``least``."""
    return max(least, 1 << max(need - 1, 0).bit_length())


def _library():
    """The kernel library and the kernel's chunk length, loaded once."""
    global _lib, _chunk
    if _lib is None:
        lib = _build.load()
        _chunk = lib.mxt_paged_attention_chunk()
        _lib = lib
    return _lib


def paged_attention(q, k_pool, v_pool, tables, positions, quant=None):
    """Attention of ``q (B, Q, H, D)`` (scaled) over each row's paged
    context: ``k_pool``/``v_pool`` are one layer's ``(pages, page_size, H,
    D)`` pools, ``tables (B, n_tab)`` the page tables, ``positions (B,)``
    the position of each row's first query (query ``j`` sits at
    ``positions + j``); ``quant`` as in :func:`gather_pages`.  Returns
    ``(B, Q, H, D)`` fp32.  ``paged_attention.launches`` counts kernel
    launches (CPU calls are not counted)."""
    tensors = [q, k_pool, v_pool, tables, positions] + list(quant or ())
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return _reference(q, k_pool, v_pool, tables, positions, quant)
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"paged_attention's tensors must lie on one CUDA "
                         f"device or all on the CPU, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    code = _quant_code(k_pool, quant)
    if v_pool.dtype != k_pool.dtype or q.dtype != torch.float32:
        raise TypeError(f"q must be float32 and the pools of one dtype, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    b, nq, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape[2:] != (h, d) or \
            v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= d <= 128:
        raise ValueError(f"head width D={d} outside 1..128")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32 or \
            tables.shape[0] != b or positions.shape != (b,):
        raise ValueError("tables (B, n_tab) and positions (B,) must be "
                         "int32")
    pages, ps = k_pool.shape[:2]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("paged_attention's tensors must be contiguous")
    for t in quant or ():
        if t.dtype != torch.float32 or t.shape != (pages, ps):
            raise ValueError(f"sidecars must be float32 ({pages}, {ps})")
    sides = list(quant or ())
    if code == 2:
        sides = [sides[0], None, sides[1], None]
    elif code == 0:
        sides = [None] * 4
    out = torch.empty_like(q)
    n_tab = tables.shape[1]
    device = q.get_device()
    lib = _library()
    stream = _build.raw_stream(device)
    slots = -(-n_tab * ps // _chunk)
    scratch = _build.stream_scratch(
        _scratch, device, stream,
        _grown(b * nq * h * slots * (d + 2), _PARTIAL_MIN),
        _grown(b * h, _TICKET_MIN))
    rc = lib.mxt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *[None if t is None else t.data_ptr() for t in sides],
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        b, nq, h, d, ps, n_tab, code, scratch[2], scratch[0].numel(),
        scratch[3], scratch[4], device, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{lib.mxt_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
