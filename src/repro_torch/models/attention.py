"""Attention variants: GQA (+QKV bias), MLA (DeepSeek kv-LoRA), gated
cross-attention (VLM, enc-dec), the blockwise ("flash") attention of prefill
and encode, and the KV-cache decode path.

The port's copy of the reference's ``models/attention.py``.  Numerics follow
it step by step: scores are float32 products of the (possibly bf16) inputs,
probabilities are cast to the value dtype before the PV product, which
accumulates in float32, and ``NEG_INF`` is an additive bias.  A bf16
``torch.matmul`` would round its output to bf16, so each such product
upcasts its operands to float32 first.  Under autograd (training) each
tile of the blockwise attention is checkpointed, as the reference wraps
each k-block in ``jax.checkpoint``: backward recomputes the tile's f32
scores and probabilities instead of saving them.

Decode KV caches hold the head/feature dims flattened (``Hkv*head_dim``), as
the reference's do, and are preallocated to a capacity: a decode step writes
its token in place at the cache's ``length`` and raises when the capacity is
used up (the reference's ``dynamic_update_slice`` would clamp the index and
overwrite the last slot).  The specs are plain data (``common.py``):
``gqa_param_specs``, ``mla_param_specs`` and ``cross_attn_param_specs`` are
the spec halves of the reference's ``init_gqa``, ``init_mla`` and
``init_cross_attn``; ``gqa_cache_spec`` and ``mla_cache_spec`` its per-layer
cache axes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import DP, TP, Dense, TensorSpec, apply_rope, dense_spec, join_specs, rope_freqs

__all__ = ["NEG_INF", "flash_attention", "decode_attention", "GQA", "MLA",
           "CrossAttention", "cache_write", "gqa_param_specs", "mla_param_specs",
           "cross_attn_param_specs", "gqa_cache_spec", "mla_cache_spec"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# blockwise attention (prefill / encode)
# ---------------------------------------------------------------------------


def _tile(qblk, kblk, vblk, m, l, acc, q0: int, q1: int, k0: int, k1: int,
          causal: bool, kv_len: Optional[int], scale: float, v_dtype: torch.dtype):
    """One (q-block, k-block) tile of the online softmax: the running max
    ``m``, sum ``l`` and f32 accumulator ``acc`` rescaled by the new max."""
    dev = qblk.device
    s = torch.matmul(qblk, kblk.float().transpose(-1, -2)) * scale
    ik = torch.arange(k0, k1, device=dev)
    if causal:
        iq = torch.arange(q0, q1, device=dev)
        s = s + torch.where(iq[:, None] >= ik[None, :], 0.0, NEG_INF)
    if kv_len is not None:
        s = s + torch.where(ik < kv_len, 0.0, NEG_INF)
    mn = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - mn[..., None])
    corr = torch.exp(m - mn)
    l = l * corr + p.sum(dim=-1)
    pv = torch.matmul(p.to(v_dtype).float(), vblk.float())
    return mn, l, acc * corr[..., None] + pv


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    q_chunk: int = 2048,
    k_chunk: int = 2048,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,  # mask k positions >= kv_len
) -> torch.Tensor:
    """Online-softmax blockwise attention (O(S) memory, exact), tile by tile
    in the reference's order: the running max, sum and f32 accumulator are
    rescaled per k block, so the result rounds as the reference's does.

    Two departures, neither of which changes a value the reference computes:
    a length that is not a multiple of its chunk gets a shorter last tile
    (the reference asserts; a 2,049-token replay of a 2,048-token prompt
    needs it), and causal tiles that lie wholly above the diagonal are
    skipped (in the reference they add exp(NEG_INF - m) = 0 and rescale by
    exp(0) = 1).  When autograd records (any input requires grad), each tile
    runs under ``torch.utils.checkpoint``: only its inputs are saved, and
    backward recomputes the same values."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    dev = q.device
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    # (B, Hkv, G, S, D): one batched matmul per tile
    qh = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).unsqueeze(2)  # (B, Hkv, 1, Sk, D)
    vh = v.permute(0, 2, 1, 3).unsqueeze(2)  # (B, Hkv, 1, Sk, Dv)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q1 = min(q0 + q_chunk, Sq)
        qblk = qh[:, :, :, q0:q1]
        m = torch.full((B, Hkv, G, q1 - q0), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, q1 - q0), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, q1 - q0, Dv), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, k_chunk):
            if causal and k0 > q1 - 1:
                break
            k1 = min(k0 + k_chunk, Sk)
            args = (qblk, kh[:, :, :, k0:k1], vh[:, :, :, k0:k1], m, l, acc,
                    q0, q1, k0, k1, causal, kv_len, scale, v.dtype)
            if remat:
                m, l, acc = checkpoint(_tile, *args, use_reentrant=False)
            else:
                m, l, acc = _tile(*args)
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]  # (B, Hkv, G, Sq, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, Dv)
    length: int,  # valid cache length (every row of the batch)
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, _, H, D = q.shape
    S, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    kc = k_cache.permute(0, 2, 3, 1).float()  # (B, Hkv, D, S)
    s = torch.matmul(qg, kc) * scale  # (B, Hkv, G, S)
    mask = torch.arange(S, device=q.device) < length
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vc = v_cache.permute(0, 2, 1, 3).float()  # (B, Hkv, S, Dv)
    o = torch.matmul(p.to(v_cache.dtype).float(), vc)  # (B, Hkv, G, Dv)
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def cache_write(buf: torch.Tensor, new: torch.Tensor, idx: int) -> None:
    """Write ``new`` (B, 1, F) into ``buf`` (B, capacity, F) at ``idx`` in
    place; raise at capacity instead of clamping."""
    if idx >= buf.shape[1]:
        raise IndexError(f"KV cache full: position {idx} past its capacity "
                         f"{buf.shape[1]}")
    buf[:, idx:idx + 1] = new


def _alloc(x: torch.Tensor, capacity: Optional[int]) -> torch.Tensor:
    """A prefill's cache tensor (B, S, F), preallocated to ``capacity``
    positions (zeros past S, as the reference's padded cache)."""
    B, S, F = x.shape
    cap = S if capacity is None else capacity
    if cap < S:
        raise ValueError(f"cache capacity {cap} below the prompt's {S} positions")
    if cap == S:
        return x.contiguous()
    buf = torch.zeros((B, cap, F), dtype=x.dtype, device=x.device)
    buf[:, :S] = x
    return buf


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


class GQA(nn.Module):
    """Grouped-query attention: ``q``, ``k``, ``v`` (with ``cfg.qkv_bias``)
    and ``o``, as the reference's ``init_gqa`` / ``gqa_apply``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.q = Dense(d, H * hd, dtype, device, bias=cfg.qkv_bias)
        self.k = Dense(d, Hkv * hd, dtype, device, bias=cfg.qkv_bias)
        self.v = Dense(d, Hkv * hd, dtype, device, bias=cfg.qkv_bias)
        self.o = Dense(H * hd, d, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, mode: str,
                cache: Optional[Dict] = None, length: int = 0,
                capacity: Optional[int] = None):
        """mode prefill | train | encode | decode.  Prefill returns a new
        cache ``{"k", "v"}`` of ``capacity`` positions; decode writes
        ``cache`` in place at ``length`` and returns it; train and encode
        return none."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.q(x).reshape(B, S, H, hd)
        k = self.k(x).reshape(B, S, Hkv, hd)
        v = self.v(x).reshape(B, S, Hkv, hd)
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)  # (B,S,hd/2)
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
        k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])

        new_cache = None
        if mode == "decode":
            if cache is None or S != 1:
                raise ValueError("decode takes one token and a cache")
            cache_write(cache["k"], k.reshape(B, 1, Hkv * hd), length)
            cache_write(cache["v"], v.reshape(B, 1, Hkv * hd), length)
            o = decode_attention(q, cache["k"].view(B, -1, Hkv, hd),
                                 cache["v"].view(B, -1, Hkv, hd), length + 1)
            new_cache = cache
        else:
            # mode "encode" (enc-dec encoder) is bidirectional
            o = flash_attention(q, k, v, causal=(mode != "encode"))
            if mode == "prefill":
                new_cache = {"k": _alloc(k.reshape(B, S, Hkv * hd), capacity),
                             "v": _alloc(v.reshape(B, S, Hkv * hd), capacity)}
        return torch.matmul(o.reshape(B, S, H * hd), self.o.w), new_cache


def gqa_param_specs(cfg, dtype):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv = lambda: dense_spec(d, Hkv * hd, dtype, bias=cfg.qkv_bias, in_axis=DP)  # noqa: E731
    return join_specs(q=dense_spec(d, H * hd, dtype, bias=cfg.qkv_bias, in_axis=DP),
                      k=kv(), v=kv(), o=dense_spec(H * hd, d, dtype, in_axis=TP, out_axis=DP))


def gqa_cache_spec(cfg, batch_sharded: bool):
    """Axes of the per-layer KV cache (stacked later): batch over DP, or,
    for a long-context single request, the sequence over ``data`` (SP)."""
    bs = (DP, None, TP) if batch_sharded else (None, "data", TP)
    return {"k": bs, "v": bs}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """Multi-head latent attention, as the reference's ``init_mla`` /
    ``mla_apply``: the cache holds the compressed ``ckv`` and the roped
    ``kpe``; decode uses the absorbed form in float32."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
        self.cfg = cfg
        self.q = Dense(d, H * (dn + dr), dtype, device)
        self.dkv = Dense(d, r + dr, dtype, device)
        self.uk = Dense(r, H * dn, dtype, device)
        self.uv = Dense(r, H * dv, dtype, device)
        self.o = Dense(H * dv, d, dtype, device)

    def forward(self, x, positions, mode, cache=None, length: int = 0,
                capacity: Optional[int] = None):
        cfg, m = self.cfg, self.cfg.mla
        B, S, _ = x.shape
        H = cfg.n_heads
        dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
        q = self.q(x).reshape(B, S, H, dn + dr)
        qn, qr = q[..., :dn], q[..., dn:]
        ckv_pe = self.dkv(x)  # (B, S, r + dr)
        ckv, kpe = ckv_pe[..., :r], ckv_pe[..., r:]
        cos, sin = rope_freqs(dr, cfg.rope_theta, positions)
        qr = apply_rope(qr, cos[:, :, None, :], sin[:, :, None, :])
        kpe = apply_rope(kpe[:, :, None, :], cos[:, :, None, :], sin[:, :, None, :])[:, :, 0]

        wuk = self.uk.w.reshape(r, H, dn)
        wuv = self.uv.w.reshape(r, H, dv)
        scale = (dn + dr) ** -0.5

        if mode == "decode":
            if cache is None or S != 1:
                raise ValueError("decode takes one token and a cache")
            cache_write(cache["ckv"], ckv, length)
            cache_write(cache["kpe"], kpe, length)
            ckv_c, kpe_c = cache["ckv"].float(), cache["kpe"].float()
            Sc = ckv_c.shape[1]
            # absorbed form: score = (qn . Wuk) . ckv + qr . kpe
            q_abs = torch.einsum("bhn,rhn->bhr", qn[:, 0].float(), wuk.float())
            s = (torch.einsum("bhr,bsr->bhs", q_abs, ckv_c)
                 + torch.einsum("bhe,bse->bhs", qr[:, 0].float(), kpe_c)) * scale
            mask = torch.arange(Sc, device=x.device) < (length + 1)
            s = torch.where(mask, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            o_c = torch.einsum("bhs,bsr->bhr", p, ckv_c)
            o = torch.einsum("bhr,rhv->bhv", o_c, wuv.float())
            o = o.reshape(B, 1, H * dv).to(x.dtype)
            new_cache = cache
        else:
            kn = torch.einsum("bsr,rhn->bshn", ckv, wuk)
            vv = torch.einsum("bsr,rhv->bshv", ckv, wuv)
            qcat = torch.cat([qn, qr], dim=-1)
            kcat = torch.cat([kn, kpe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
            o = flash_attention(qcat, kcat, vv, causal=(mode != "encode"), scale=scale)
            o = o.reshape(B, S, H * dv)
            new_cache = ({"ckv": _alloc(ckv, capacity), "kpe": _alloc(kpe, capacity)}
                         if mode == "prefill" else None)
        return torch.matmul(o, self.o.w), new_cache


def mla_param_specs(cfg, dtype):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    return join_specs(q=dense_spec(d, H * (dn + dr), dtype, in_axis=DP),
                      dkv=dense_spec(d, r + dr, dtype, in_axis=DP, out_axis=None),
                      uk=dense_spec(r, H * dn, dtype, in_axis=None, out_axis=TP),
                      uv=dense_spec(r, H * dv, dtype, in_axis=None, out_axis=TP),
                      o=dense_spec(H * dv, d, dtype, in_axis=TP, out_axis=DP))


def mla_cache_spec(cfg, batch_sharded: bool):
    if batch_sharded:
        return {"ckv": (DP, None, None), "kpe": (DP, None, None)}
    return {"ckv": (None, "data", None), "kpe": (None, "data", None)}


# ---------------------------------------------------------------------------
# Gated cross-attention (Llama-3.2-Vision style; the enc-dec decoder's too)
# ---------------------------------------------------------------------------


class CrossAttention(nn.Module):
    """Cross-attention over a fixed memory (vision tokens or the encoder's
    output), scaled by ``tanh(gate)``: the reference's ``init_cross_attn`` /
    ``cross_attn_apply``.  ``gate`` is a float32 scalar, zero at init."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.q = Dense(d, H * hd, dtype, device)
        self.k = Dense(d, Hkv * hd, dtype, device)
        self.v = Dense(d, Hkv * hd, dtype, device)
        self.o = Dense(H * hd, d, dtype, device)
        self.gate = nn.Parameter(torch.empty((), dtype=torch.float32, device=device),
                                 requires_grad=False)

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gate.zero_()

    def forward(self, x, memory, mode, cache=None):
        """x: (B, S, d) text; memory: (B, Nv, d).  Decode reads the cached
        ``k``/``v`` of the memory and returns the cache unchanged."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.q(x).reshape(B, S, H, hd)
        if cache is not None and mode == "decode":
            k = cache["k"].view(B, -1, Hkv, hd)
            v = cache["v"].view(B, -1, Hkv, hd)
            new_cache = cache
        else:
            k = self.k(memory).reshape(B, -1, Hkv, hd)
            v = self.v(memory).reshape(B, -1, Hkv, hd)
            Nv = k.shape[1]
            new_cache = {"k": k.reshape(B, Nv, Hkv * hd), "v": v.reshape(B, Nv, Hkv * hd)}
        # pad the memory axis up to a tile multiple and mask
        Nv = k.shape[1]
        pad = (-Nv) % 128
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        o = flash_attention(q, k, v, causal=False, q_chunk=2048, k_chunk=128, kv_len=Nv)
        o = torch.matmul(o.reshape(B, S, H * hd), self.o.w)
        gate = torch.tanh(self.gate).to(x.dtype)
        return o * gate, new_cache


def cross_attn_param_specs(cfg, dtype):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes, axes = join_specs(q=dense_spec(d, H * hd, dtype, in_axis=DP),
                              k=dense_spec(d, Hkv * hd, dtype, in_axis=DP),
                              v=dense_spec(d, Hkv * hd, dtype, in_axis=DP),
                              o=dense_spec(H * hd, d, dtype, in_axis=TP, out_axis=DP))
    shapes["gate"], axes["gate"] = TensorSpec((), torch.float32), ()
    return shapes, axes
