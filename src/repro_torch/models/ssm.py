"""Mamba2 (SSD — state-space duality) sequence mixer.

The port's copy of the reference's ``models/ssm.py``: the chunked SSD
algorithm (arXiv:2405.21060) for prefill — within chunks of length Q an
attention-like quadratic form with a decay mask, across chunks a linear
recurrence carrying the (H, N, P) state, in chunk order — and a single-step
state update for decode.  The "KV cache" of an SSM is its fixed-width state
plus the causal conv's last K-1 inputs, so it needs no capacity.  Projections
are split (z/x/B/C/dt) as in the reference; the cumulative decays are
float32.  ``mamba2_param_specs`` and ``mamba2_cache_spec`` are the
reference's parameter and cache specs as plain data (``common.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .common import DP, TP, Dense, RMSNorm, TensorSpec, dense_spec, join_specs, normal_

__all__ = ["Mamba2", "causal_conv", "ssd_chunked", "mamba2_param_specs", "mamba2_cache_spec"]


class _Conv(nn.Module):
    """Depthwise causal conv weights: ``w`` (K, C), ``b`` (C)."""

    def __init__(self, K: int, C: int, dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(K, C, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.empty(C, dtype=dtype, device=device),
                              requires_grad=False)

    def init_(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, 0.1)
        with torch.no_grad():
            self.b.zero_()


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  x (B,S,C); w (K,C).  Returns (y, new
    state (B,K-1,C)); the K taps are summed in index order, in x's dtype."""
    K = w.shape[0]
    if state is not None:
        xin = torch.cat([state, x], dim=1)  # (B, K-1+S, C)
    else:
        xin = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    new_state = xin[:, -(K - 1):, :]
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xin[:, i:i + S, :] * w[i][None, None, :]
    return torch.nn.functional.silu(y + b), new_state


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan (the reference's ``_ssd_chunked``).

    xh (B,S,H,P); dt (B,S,H) f32 post-softplus; A (H,) f32 negative;
    Bm/Cm (B,S,G,N).  Heads share B/C within a group (G divides H).  Returns
    y (B,S,H,P) f32 and the final state (B,H,N,P) f32.

    One deliberate difference, in gradients only: the reference takes
    exp of every within-chunk log-decay and masks after, so a decay past
    float32's exp range above the diagonal makes its backward 0 * inf =
    NaN; the port exponentiates the masked log-decay, the same values with
    finite gradients.
    """
    B_, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt=0 entries: they contribute nothing to the state
        # (x·dt = 0) and decay exp(0)=1, so the scan is exact.
        pad = Q - S % Q
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    rep = H // G
    dtA = dt * A[None, None, :]  # (B,S,H) negative
    xdt = xh.float() * dt[..., None]

    xc = xdt.reshape(B_, nc, Q, H, Pd)
    dc = dtA.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, G, N).float()
    Cc = Cm.reshape(B_, nc, Q, G, N).float()
    # broadcast groups to heads
    Bh = torch.repeat_interleave(Bc, rep, dim=3)  # (B,nc,Q,H,N)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)

    cs = torch.cumsum(dc, dim=2)  # (B,nc,Q,H) cumulative log-decay
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    iq = torch.arange(Q, device=xh.device)
    causal = iq[:, None] >= iq[None, :]
    # exp of the masked log-decay: the values of where(causal, exp(seg), 0)
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk-final states: S_c = sum_j exp(cs_end - cs_j) B_j (x dt)_j
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # (B,nc,Q,H)
    S_c = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bh, decay_to_end, xc)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B,nc,H)

    state = torch.zeros((B_, H, N, Pd), dtype=torch.float32, device=xh.device)
    prevs = []
    for t in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, t][:, :, None, None] + S_c[:, t]
    S_prevs = torch.stack(prevs, dim=1)  # (B,nc,H,N,P)
    y_inter = torch.einsum("bcihn,bcih,bchnp->bcihp", Ch, torch.exp(cs), S_prevs)

    y = (y_intra + y_inter).reshape(B_, S, H, Pd)[:, :S_orig]
    return y, state


class Mamba2(nn.Module):
    """The reference's ``init_mamba2`` / ``mamba2_apply``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        s = cfg.ssm
        d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        GN = s.n_groups * s.d_state
        self.cfg = cfg
        self.in_z = Dense(d, di, dtype, device)
        self.in_x = Dense(d, di, dtype, device)
        self.in_B = Dense(d, GN, dtype, device)
        self.in_C = Dense(d, GN, dtype, device)
        self.in_dt = Dense(d, H, dtype, device)
        self.out = Dense(di, d, dtype, device)
        self.conv_x = _Conv(s.d_conv, di, dtype, device)
        self.conv_B = _Conv(s.d_conv, GN, dtype, device)
        self.conv_C = _Conv(s.d_conv, GN, dtype, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = nn.Parameter(torch.empty(H, **f32), requires_grad=False)
        self.D = nn.Parameter(torch.empty(H, **f32), requires_grad=False)
        self.dt_bias = nn.Parameter(torch.empty(H, **f32), requires_grad=False)
        self.norm = RMSNorm(di, dtype, device)  # the gated norm's scale

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.zero_()

    def forward(self, x: torch.Tensor, mode: str, cache: Optional[Dict] = None):
        """mode prefill | decode | train.  Prefill returns the cache
        ``{"state", "conv": {"x", "B", "C"}}``; decode updates it in place;
        train runs the prefill's chunked scan and returns no cache."""
        cfg, s = self.cfg, self.cfg.ssm
        B, S, _ = x.shape
        di, H, Pd = cfg.d_inner, cfg.ssm_heads, s.head_dim
        G, N = s.n_groups, s.d_state

        z = torch.matmul(x, self.in_z.w)
        xr = torch.matmul(x, self.in_x.w)
        Braw = torch.matmul(x, self.in_B.w)
        Craw = torch.matmul(x, self.in_C.w)
        dt_raw = torch.matmul(x, self.in_dt.w)

        conv = cache["conv"] if mode == "decode" else {"x": None, "B": None, "C": None}
        xr, cx = causal_conv(xr, self.conv_x.w, self.conv_x.b, conv["x"])
        Braw, cB = causal_conv(Braw, self.conv_B.w, self.conv_B.b, conv["B"])
        Craw, cC = causal_conv(Craw, self.conv_C.w, self.conv_C.b, conv["C"])

        dt = torch.logaddexp(dt_raw.float() + self.dt_bias, torch.zeros((), device=x.device))
        A = -torch.exp(self.A_log)
        xh = xr.reshape(B, S, H, Pd)
        Bm = Braw.reshape(B, S, G, N)
        Cm = Craw.reshape(B, S, G, N)

        if mode == "decode":
            if S != 1:
                raise ValueError("decode takes one token")
            state = cache["state"]  # (B,H,N,P) f32
            dtA = torch.exp(dt[:, 0] * A[None, :])  # (B,H)
            Bh = torch.repeat_interleave(Bm[:, 0].float(), H // G, dim=1)  # (B,H,N)
            Ch = torch.repeat_interleave(Cm[:, 0].float(), H // G, dim=1)
            xdt = xh[:, 0].float() * dt[:, 0][..., None]  # (B,H,P)
            new_state = state * dtA[:, :, None, None] + torch.einsum("bhn,bhp->bhnp", Bh, xdt)
            y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)[:, None]  # (B,1,H,P)
            state.copy_(new_state)
            for key, new in (("x", cx), ("B", cB), ("C", cC)):
                cache["conv"][key].copy_(new)
            new_cache = cache
        else:
            y, S_last = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
            new_cache = None if mode == "train" else {
                "state": S_last, "conv": {"x": cx.clone(), "B": cB.clone(), "C": cC.clone()}}

        y = y + self.D[None, None, :, None] * xh.float()
        y = y.reshape(B, S, di).to(x.dtype)
        # gated RMSNorm (mamba2)
        g = y * torch.nn.functional.silu(z)
        gf = g.float()
        var = torch.mean(gf * gf, dim=-1, keepdim=True)
        g = (gf * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * self.norm.scale
        return torch.matmul(g, self.out.w), new_cache


def mamba2_param_specs(cfg, dtype):
    """The spec half of the reference's ``init_mamba2``."""
    s = cfg.ssm
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    GN = s.n_groups * s.d_state
    f32 = torch.float32
    shapes, axes = join_specs(in_z=dense_spec(d, di, dtype, in_axis=DP),
                              in_x=dense_spec(d, di, dtype, in_axis=DP),
                              in_B=dense_spec(d, GN, dtype, in_axis=DP, out_axis=None),
                              in_C=dense_spec(d, GN, dtype, in_axis=DP, out_axis=None),
                              in_dt=dense_spec(d, H, dtype, in_axis=DP, out_axis=TP),
                              out=dense_spec(di, d, dtype, in_axis=TP, out_axis=DP))
    for name, C, ax in (("conv_x", di, TP), ("conv_B", GN, None), ("conv_C", GN, None)):
        shapes[name] = {"w": TensorSpec((s.d_conv, C), dtype), "b": TensorSpec((C,), dtype)}
        axes[name] = {"w": (None, ax), "b": (ax,)}
    for name in ("A_log", "D", "dt_bias"):
        shapes[name], axes[name] = TensorSpec((H,), f32), (TP,)
    shapes["norm"], axes["norm"] = {"scale": TensorSpec((di,), dtype)}, {"scale": (TP,)}
    return shapes, axes


def mamba2_cache_spec(cfg, batch_sharded: bool):
    bs = DP if batch_sharded else None
    return {"state": (bs, TP, None, None),
            "conv": {"x": (bs, None, TP), "B": (bs, None, None), "C": (bs, None, None)}}
