"""Paged decode attention over block tables: CUDA kernel + plain twin.

Port of ``repro/kernels/paged_attention.py``.  Layouts (G = query heads per
KV head):

    q        (B, H_kv, G, D)                bf16 | f32
    kp, vp   (n_pages, page_size, H_kv, D)  bf16 | int8
    k_scale, v_scale  (n_pages, page_size, H_kv) f32 (int8 pools)
    tables   (B, P) int32 physical page ids
    lengths  (B,)   int32 valid rows per lane (pos + 1 at decode; >= 1)
    out      (B, H_kv, G, D) f32

:func:`paged_attention` launches ``csrc/paged_attention.cu`` for CUDA
tensors and runs :func:`paged_attention_plain` for CPU tensors; there is
no fallback between the two.  ``LAUNCHES`` counts kernel launches,
``PLAIN_CALLS`` calls of the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# the kernel splits each lane's table at most this many ways (MAX_CLUSTER in
# csrc/paged_attention.cu; split r takes pages r, r + S, ...)
MAX_SPLITS = 8

LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global LAUNCHES, PLAIN_CALLS
    LAUNCHES = 0
    PLAIN_CALLS = 0


def paged_attention_plain(q, kp, vp, tables, lengths, *, k_scale=None,
                          v_scale=None):
    """Gather twin with an exact f32 softmax —
    ``repro/kernels/paged_attention.py:paged_attention_ref``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    b, hkv, g, d = q.shape
    page_size = kp.shape[1]
    smax = tables.shape[1] * page_size
    idx = tables.long()

    def gather(pool):
        return pool[idx].reshape((b, smax) + tuple(pool.shape[2:]))

    k_all, v_all = gather(kp), gather(vp)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k_all.float())
    scores = scores * (d ** -0.5)
    if k_scale is not None:
        scores = scores * gather(k_scale).permute(0, 2, 1)[:, :, None, :]
    valid = torch.arange(smax, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * gather(v_scale).permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bhgs,bshd->bhgd", probs, v_all.float())


def _check(q, kp, vp, tables, lengths, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 paged attention needs both k_scale and v_scale")
    if q.ndim != 4 or kp.ndim != 4 or kp.shape != vp.shape:
        raise ValueError(f"expected q (B, Hkv, G, D) and equal kp/vp (n_pages, "
                         f"page_size, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(kp.shape)}, {tuple(vp.shape)}")
    b, hkv, _, d = q.shape
    if kp.shape[2] != hkv or kp.shape[3] != d:
        raise ValueError(f"pool heads/dim {tuple(kp.shape[2:])} do not match "
                         f"q's ({hkv}, {d})")
    if tables.ndim != 2 or tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"expected tables ({b}, P) and lengths ({b},), got "
                         f"{tuple(tables.shape)} and {tuple(lengths.shape)}")
    if k_scale is not None and (tuple(k_scale.shape) != tuple(kp.shape[:3])
                                or tuple(v_scale.shape) != tuple(kp.shape[:3])):
        raise ValueError(f"scales must be {tuple(kp.shape[:3])}")
    tensors = [q, kp, vp, tables, lengths] + ([k_scale, v_scale] if k_scale is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    return tensors


def paged_attention(q, kp, vp, tables, lengths, *, k_scale=None, v_scale=None):
    """Flash decode attention over paged KV; see the module docstring for
    layouts.  ``k_scale``/``v_scale`` select the int8 variant."""
    global LAUNCHES
    tensors = _check(q, kp, vp, tables, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, kp, vp, tables, lengths,
                                     k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, got {q.device}")
    int8 = k_scale is not None
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    want = torch.int8 if int8 else torch.bfloat16
    if kp.dtype != want or vp.dtype != want:
        raise TypeError(f"{'int8' if int8 else 'bf16'} pools expected, got "
                        f"{kp.dtype}, {vp.dtype}")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("k_scale and v_scale must be float32")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention's kernel takes contiguous tensors")
    b, hkv, g, d = q.shape
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    err = _build.library().paged_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        kp.data_ptr(), vp.data_ptr(), int(int8),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, d, kp.shape[1], tables.shape[1],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    LAUNCHES += 1
    return out
