"""Model assembly for every assigned architecture family.

The port's copy of the reference's ``models/transformer.py``: one generic LM
covering dense / MoE / MLA attention, Mamba2 (SSM), the Zamba2-style hybrid
(mamba backbone + one weight-tied shared attention block), Llama-3.2-Vision
style gated cross-attention layers and a Seamless-style encoder-decoder.

Where the reference stacks each family's layers on a leading ``(L, ...)``
axis and runs them with ``lax.scan``, the port keeps one ``nn.Module`` per
layer in an ``nn.ModuleList`` and loops over them; the vlm's
``(n_cross, period - 1, ...)`` self layers are a list of lists.  Parameter
names mirror the reference's tree (``layers.3.attn.q.w``, ``embed.w``;
``models/convert.py`` maps one onto the other).

Caches mirror the reference's too, with per-layer lists in place of stacked
arrays: ``{"layers": [{"k", "v"}, ...], "length": int}`` for dense and moe
(``{"ckv", "kpe"}`` under MLA, ``{"state", "conv"}`` for ssm), ``{"mamba",
"shared", "length"}`` for hybrid and ``{"self", "cross", "length"}`` for vlm
and audio.  ``length`` is a host int, the global decode position.  A prefill
preallocates each attention cache to ``capacity`` positions (the reference's
engine pads its cache after the prefill instead); ``decode_step`` writes into
the cache in place and returns it, the way the reference's jitted step
donates its cache.

API (used by serve/engine and launch/serve):

* ``init(generator)``                       -> self (the reference's distributions)
* ``loss_fn(batch)``                       -> (loss, {"nll", "aux"}), under autograd
* ``prefill(batch, capacity=None)``        -> (last_logits, cache)
* ``decode_step(cache, tokens)``           -> (last_logits, cache)
* ``model(batch)``                         -> every position's logits

Parameters are created with ``requires_grad=False``: serving records no
graph.  Training makes them trainable (``model.requires_grad_(True)``, which
``train.train_loop.make_train_step`` does) and calls ``loss_fn`` with
autograd on.  ``prefill``, ``decode_step`` and ``forward`` run under
``torch.inference_mode`` whatever the parameters' flag.

``param_specs(cfg, data_size)`` is the spec tree the reference's ``init``
returns beside its params, as plain data (``common.TensorSpec`` shapes and
axes tuples, in the reference's nested, layer-stacked layout; nothing is
allocated).

With ``use_sharded_moe`` and a ``mesh`` (``launch/mesh.py``), the MoE layers
run ``moe.moe_apply_sharded`` on this rank's expert slices, as the
reference's ``_moe_ffn`` runs it under ``shard_map``.  Each rank runs the
model on its own batch shard: the port splits the batch by process, where
the reference splits one global batch over ``batch_axes``.  The flag can be
turned off and on again on the same weights.  ``loss_fn`` is then this
rank's loss on its shard, and its gradient this rank's share;
``train.train_loop.loss_and_grads`` and ``make_train_step`` bring both to
the reference's global values on every rank.

Per-layer remat follows ``cfg.remat`` in train mode, as the reference's
``_remat``: ``"full"`` runs each layer under ``torch.utils.checkpoint``
(non-reentrant), so backward recomputes its activations; ``"dots"`` (the
reference's ``dots_with_no_batch_dims_saveable`` policy, which saves the
weight products) maps to the same full recompute here.  Either way the
values are those of ``"none"``; only memory and time differ.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from .attention import (GQA, MLA, CrossAttention, cross_attn_param_specs, gqa_param_specs,
                        mla_param_specs)
from .common import (DP, MLP, TP, Dense, Embed, RMSNorm, dense_spec, dtype_of, embed_spec,
                     join_specs, mlp_apply, rmsnorm_spec, stack_specs)
from .moe import MoE, moe_param_specs
from .ssm import Mamba2, mamba2_param_specs

__all__ = ["LMModel", "MLP", "mlp_apply", "param_specs"]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class DenseLayer(nn.Module):
    """``n1``, ``attn`` (GQA, MLA or gated cross-attention), ``n2``, ``mlp``."""

    def __init__(self, cfg, dtype, device, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.n1 = RMSNorm(cfg.d_model, dtype, device)
        if cross:
            self.attn = CrossAttention(cfg, dtype, device)
        elif cfg.mla is not None:
            self.attn = MLA(cfg, dtype, device)
        else:
            self.attn = GQA(cfg, dtype, device)
        self.n2 = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, positions, mode, cache=None, length=0, capacity=None):
        eps = self.cfg.norm_eps
        h, nc = self.attn(self.n1(x, eps), positions, mode, cache, length, capacity)
        x = x + h
        x = x + self.mlp(self.n2(x, eps))
        return x, nc

    def apply_cross(self, x, memory, mode, cache=None):
        """A cross-attention layer (vlm): attend to ``memory``."""
        eps = self.cfg.norm_eps
        h, nc = self.attn(self.n1(x, eps), memory, mode, cache)
        x = x + h
        x = x + self.mlp(self.n2(x, eps))
        return x, nc


class MoELayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.n1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = (MLA if cfg.mla is not None else GQA)(cfg, dtype, device)
        self.n2 = RMSNorm(cfg.d_model, dtype, device)
        self.moe = MoE(cfg, dtype, device)

    def forward(self, x, positions, mode, cache=None, length=0, capacity=None):
        """-> (x, new cache, the router's aux loss): the other layers return
        (x, new cache) only."""
        eps = self.cfg.norm_eps
        h, nc = self.attn(self.n1(x, eps), positions, mode, cache, length, capacity)
        x = x + h
        m, aux = self.moe(self.n2(x, eps))
        return x + m, nc, aux["aux"]


class SSMLayer(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.n1 = RMSNorm(cfg.d_model, dtype, device)
        self.mamba = Mamba2(cfg, dtype, device)

    def forward(self, x, positions, mode, cache=None, length=0, capacity=None):
        h, nc = self.mamba(self.n1(x, self.cfg.norm_eps), mode, cache)
        return x + h, nc


class DecoderLayer(DenseLayer):
    """The enc-dec decoder layer: self-attention, ``cross`` attention to the
    encoder's output (normed by ``nc``), then the FFN."""

    def __init__(self, cfg, dtype, device):
        super().__init__(cfg, dtype, device)
        self.cross = CrossAttention(cfg, dtype, device)
        self.nc = RMSNorm(cfg.d_model, dtype, device)

    def forward(self, x, positions, mode, enc_out=None, self_cache=None,
                cross_cache=None, length=0, capacity=None):
        eps = self.cfg.norm_eps
        a, ncs = self.attn(self.n1(x, eps), positions, mode, self_cache, length, capacity)
        x = x + a
        c, ncc = self.cross(self.nc(x, eps), enc_out, mode, cross_cache)
        x = x + c
        x = x + self.mlp(self.n2(x, eps))
        return x, ncs, ncc


# ---------------------------------------------------------------------------
# specs: the reference's init spec tree, as plain data
# ---------------------------------------------------------------------------


def _mlp_specs(d, ff, dtype):
    return join_specs(wi=dense_spec(d, ff, dtype, in_axis=DP),
                      wg=dense_spec(d, ff, dtype, in_axis=DP),
                      wo=dense_spec(ff, d, dtype, in_axis=TP, out_axis=DP))


def _dense_layer_specs(cfg, dtype, cross: bool = False, use_mla: bool = False):
    if cross:
        attn = cross_attn_param_specs(cfg, dtype)
    else:
        attn = (mla_param_specs if use_mla else gqa_param_specs)(cfg, dtype)
    return join_specs(n1=rmsnorm_spec(cfg.d_model, dtype), attn=attn,
                      n2=rmsnorm_spec(cfg.d_model, dtype),
                      mlp=_mlp_specs(cfg.d_model, cfg.d_ff, dtype))


def param_specs(cfg: ModelConfig, data_size: int = 16):
    """-> (``TensorSpec`` tree, axes tree) of the reference's ``LMModel.init``
    (``models/transformer.py:131``): its nested layout, layers stacked on
    leading axes with a ``None`` axis each, MoE experts
    ``expert_slots(n_experts, data_size)`` deep."""
    dtype = dtype_of(cfg)
    d = cfg.d_model
    named = {"embed": embed_spec(cfg.vocab, d, dtype), "final_norm": rmsnorm_spec(d, dtype)}
    if not cfg.tie_embeddings:
        named["unembed"] = dense_spec(d, cfg.vocab, dtype, in_axis=DP)
    fam = cfg.family
    if fam == "dense":
        named["layers"] = stack_specs(_dense_layer_specs(cfg, dtype, use_mla=cfg.mla is not None),
                                      cfg.n_layers)
    elif fam == "moe":
        attn = (mla_param_specs if cfg.mla is not None else gqa_param_specs)(cfg, dtype)
        layer = join_specs(n1=rmsnorm_spec(d, dtype), attn=attn, n2=rmsnorm_spec(d, dtype),
                           moe=moe_param_specs(cfg, dtype, data_size))
        named["layers"] = stack_specs(layer, cfg.n_layers)
    elif fam in ("ssm", "hybrid"):
        layer = join_specs(n1=rmsnorm_spec(d, dtype), mamba=mamba2_param_specs(cfg, dtype))
        named["layers"] = stack_specs(layer, cfg.n_layers)
        if fam == "hybrid":
            named["shared"] = _dense_layer_specs(cfg, dtype)
    elif fam == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        named["self_layers"] = stack_specs(_dense_layer_specs(cfg, dtype), n_cross,
                                           cfg.cross_attn_every - 1)
        named["cross_layers"] = stack_specs(_dense_layer_specs(cfg, dtype, cross=True), n_cross)
        named["vis_proj"] = dense_spec(cfg.d_vision, d, dtype, in_axis=None, out_axis=None)
    elif fam == "audio":
        named["enc_layers"] = stack_specs(_dense_layer_specs(cfg, dtype), cfg.n_enc_layers)
        shapes, axes = _dense_layer_specs(cfg, dtype)
        shapes["cross"], axes["cross"] = cross_attn_param_specs(cfg, dtype)
        shapes["nc"], axes["nc"] = rmsnorm_spec(d, dtype)
        named["dec_layers"] = stack_specs((shapes, axes), cfg.n_dec_layers)
        named["audio_proj"] = dense_spec(cfg.d_audio, d, dtype, in_axis=None, out_axis=None)
    else:
        raise ValueError(fam)
    return join_specs(**named)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class LMModel(nn.Module):
    """One family's LM on ``device`` (CUDA unless the caller names the CPU;
    raises without a card).  Parameters are allocated uninitialised: call
    :meth:`init` with a ``torch.Generator``, or load a state dict.

    ``mesh`` (a ``DeviceMesh`` of dims ``("data", "model")``), ``data_size``
    (its data extent; the reference's expert slotting) and ``batch_axes``
    (the mesh dims the batch is split over) are the reference's;
    ``use_sharded_moe`` runs the MoE layers expert-parallel over ``mesh``."""

    def __init__(self, cfg: ModelConfig, device=None, *, mesh=None,
                 use_sharded_moe: bool = False, data_size: int = 16,
                 batch_axes=("data",)):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.data_size = data_size
        self.batch_axes = tuple(batch_axes)
        self.device = ops.resolve_device(device)
        dev, dtype = self.device, dtype_of(cfg)
        d = cfg.d_model
        self.embed = Embed(cfg.vocab, d, dtype, dev)
        self.unembed = None if cfg.tie_embeddings else Dense(d, cfg.vocab, dtype, dev)
        self.final_norm = RMSNorm(d, dtype, dev)

        fam = cfg.family
        if fam == "dense":
            self.layers = nn.ModuleList(DenseLayer(cfg, dtype, dev) for _ in range(cfg.n_layers))
        elif fam == "moe":
            self.layers = nn.ModuleList(MoELayer(cfg, dtype, dev) for _ in range(cfg.n_layers))
        elif fam in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(SSMLayer(cfg, dtype, dev) for _ in range(cfg.n_layers))
            if fam == "hybrid":
                self.shared = DenseLayer(cfg, dtype, dev)
        elif fam == "vlm":
            period = cfg.cross_attn_every
            n_cross = cfg.n_layers // period
            self.self_layers = nn.ModuleList(
                nn.ModuleList(DenseLayer(cfg, dtype, dev) for _ in range(period - 1))
                for _ in range(n_cross))
            self.cross_layers = nn.ModuleList(
                DenseLayer(cfg, dtype, dev, cross=True) for _ in range(n_cross))
            self.vis_proj = Dense(cfg.d_vision, d, dtype, dev)
        elif fam == "audio":
            self.enc_layers = nn.ModuleList(
                DenseLayer(cfg, dtype, dev) for _ in range(cfg.n_enc_layers))
            self.dec_layers = nn.ModuleList(
                DecoderLayer(cfg, dtype, dev) for _ in range(cfg.n_dec_layers))
            self.audio_proj = Dense(cfg.d_audio, d, dtype, dev)
        else:
            raise ValueError(fam)
        self.use_sharded_moe = use_sharded_moe

    @property
    def use_sharded_moe(self) -> bool:
        return any(layer.moe.mesh is not None for layer in self._moe_layers())

    @use_sharded_moe.setter
    def use_sharded_moe(self, on: bool) -> None:
        """Point every MoE layer at the mesh (on) or at none (off)."""
        if on:
            if self.mesh is None:
                raise ValueError("use_sharded_moe needs a mesh")
            names = self.mesh.mesh_dim_names or ()
            if not set(self.batch_axes) <= set(names):
                raise ValueError(f"batch_axes {self.batch_axes} are not dims of the mesh {names}")
            if self.mesh.size(names.index("data")) != self.data_size:
                raise ValueError(f"data_size {self.data_size} is not the mesh's data extent "
                                 f"{self.mesh.size(names.index('data'))}")
        for layer in self._moe_layers():
            layer.moe.mesh = self.mesh if on else None

    def _moe_layers(self):
        return [layer for layer in self.layers if isinstance(layer, MoELayer)] \
            if self.cfg.family == "moe" else []

    def init(self, generator: torch.Generator) -> "LMModel":
        """Draw every parameter from ``generator`` with the reference's
        distributions (module by module, in registration order)."""
        for mod in self.modules():
            if hasattr(mod, "init_"):
                mod.init_(generator)
        return self

    # ------------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def _positions(self, B: int, S: int, mode: str, length: int) -> torch.Tensor:
        if mode == "decode":
            return torch.full((B, 1), length, dtype=torch.int64, device=self.device)
        return torch.arange(S, device=self.device).expand(B, S)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.matmul(x, self.embed.w.t())
        return torch.matmul(x, self.unembed.w)

    def _remat(self, fn, mode: str):
        """``fn`` under ``torch.utils.checkpoint`` in train mode when the
        config asks for remat (see the module docstring), else ``fn``."""
        if mode == "train" and self.cfg.remat != "none" and torch.is_grad_enabled():
            return lambda *args: checkpoint(fn, *args, use_reentrant=False)
        return fn

    def _full_forward(self, batch: Dict, mode: str, cache: Optional[Dict] = None,
                      capacity: Optional[int] = None, last_only: bool = False):
        """-> (logits, cache, aux).  mode prefill | decode | train.  Train
        returns no cache and the MoE layers' summed aux loss (float32 0 for
        the other families).  ``last_only`` takes the logits of the last
        position only (a prefill's answer): the final norm and the
        unembedding are row-wise, so those rows equal the full forward's."""
        if mode not in ("prefill", "decode", "train"):
            raise ValueError(mode)
        if mode == "decode" and cache is None:
            raise ValueError("decode needs the prefill's cache")
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        length = cache["length"] if mode == "decode" else 0
        positions = self._positions(B, S, mode, length)
        x = self.embed(tokens)
        fam = cfg.family
        aux = None
        if fam in ("dense", "moe", "ssm"):
            x, new, aux = self._stack(x, positions, mode, cache, capacity)
        elif fam == "hybrid":
            x, new = self._hybrid_backbone(x, positions, mode, cache, capacity)
        elif fam == "vlm":
            x, new = self._vlm_forward(x, batch, positions, mode, cache, capacity)
        else:
            x, new = self._audio_forward(x, batch, positions, mode, cache, capacity)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if last_only:
            x = x[:, -1:]
        x = self.final_norm(x, cfg.norm_eps)
        logits = self._logits(x)
        if mode == "train":
            return logits, None, aux
        if mode == "decode":
            cache["length"] = length + 1
            return logits, cache, aux
        new["length"] = S
        return logits, new, aux

    # -- dense / moe / ssm ------------------------------------------------
    def _stack(self, x, positions, mode, cache, capacity):
        """-> (x, {"layers": caches}, the MoE layers' aux summed, or None)."""
        length = cache["length"] if mode == "decode" else 0
        caches, aux = [], None
        for i, layer in enumerate(self.layers):
            lc = cache["layers"][i] if mode == "decode" else None
            out = self._remat(layer, mode)(x, positions, mode, lc, length, capacity)
            x, nc = out[:2]
            caches.append(nc)
            if len(out) == 3:  # a MoE layer's aux loss
                aux = out[2] if aux is None else aux + out[2]
        return x, {"layers": caches}, aux

    # -- hybrid (zamba2) --------------------------------------------------
    def _hybrid_backbone(self, x, positions, mode, cache, capacity):
        """``period`` mamba layers, then the one shared attention block (its
        own KV cache per application), ``n_shared`` times; then the tail."""
        period = self.cfg.shared_attn_every
        n_shared = self.cfg.n_layers // period
        length = cache["length"] if mode == "decode" else 0
        mamba, shared = [], []
        for i, layer in enumerate(self.layers):
            lc = cache["mamba"][i] if mode == "decode" else None
            x, nc = self._remat(layer, mode)(x, positions, mode, lc)
            mamba.append(nc)
            j = i // period
            if (i + 1) % period == 0 and j < n_shared:
                sc = cache["shared"][j] if mode == "decode" else None
                x, nsc = self._remat(self.shared, mode)(x, positions, mode, sc, length,
                                                        capacity)
                shared.append(nsc)
        return x, {"mamba": mamba, "shared": shared}

    # -- vlm --------------------------------------------------------------
    def _vlm_forward(self, x, batch, positions, mode, cache, capacity):
        length = cache["length"] if mode == "decode" else 0
        vis = None
        if mode != "decode":
            emb = torch.as_tensor(batch["vision_embeds"], device=self.device)
            vis = torch.matmul(emb, self.vis_proj.w)
        selfc, crossc = [], []
        for g, (group, cross) in enumerate(zip(self.self_layers, self.cross_layers)):
            row = []
            for j, layer in enumerate(group):
                lc = cache["self"][g][j] if mode == "decode" else None
                x, nc = self._remat(layer, mode)(x, positions, mode, lc, length, capacity)
                row.append(nc)
            selfc.append(row)
            cc = cache["cross"][g] if mode == "decode" else None
            x, ncc = self._remat(cross.apply_cross, mode)(x, vis, mode, cc)
            crossc.append(ncc)
        return x, {"self": selfc, "cross": crossc}

    # -- audio (enc-dec) ----------------------------------------------------
    def _audio_forward(self, x, batch, positions, mode, cache, capacity):
        length = cache["length"] if mode == "decode" else 0
        enc_out = None
        if mode != "decode":
            frames = torch.as_tensor(batch["frames"], device=self.device)
            B, Sa = frames.shape[:2]
            h = torch.matmul(frames, self.audio_proj.w)
            pos_enc = torch.arange(Sa, device=self.device).expand(B, Sa)
            for layer in self.enc_layers:
                h, _ = self._remat(layer, mode)(h, pos_enc, "encode")
            enc_out = h
        selfc, crossc = [], []
        for i, layer in enumerate(self.dec_layers):
            cs = cache["self"][i] if mode == "decode" else None
            cc = cache["cross"][i] if mode == "decode" else None
            x, ncs, ncc = self._remat(layer, mode)(x, positions, mode, enc_out, cs, cc, length,
                                                   capacity)
            selfc.append(ncs)
            crossc.append(ncc)
        return x, {"self": selfc, "cross": crossc}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def loss_fn(self, batch: Dict):
        """-> (loss, {"nll", "aux"}): next-token cross-entropy over
        ``batch["tokens"]`` (B, S + 1), the reference's ``loss_fn``.  The
        input is ``tokens[:, :-1]``; the logits are upcast to float32, the
        nll is ``logsumexp`` minus the gold logit, averaged, plus
        ``router_aux_coef`` times the summed aux for MoE.  Records autograd
        when the parameters require grad."""
        tokens = self._tokens(batch["tokens"])
        inp = {**batch, "tokens": tokens[:, :-1]}
        logits, _, aux = self._full_forward(inp, "train")
        targets = tokens[:, 1:].long()
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = (lse - gold).mean()
        loss = nll + self.cfg.moe.router_aux_coef * aux if self.cfg.moe else nll
        return loss, {"nll": nll, "aux": aux}

    @torch.inference_mode()
    def prefill(self, batch: Dict, capacity: Optional[int] = None):
        """-> (last-position logits (B, V), cache preallocated to
        ``capacity`` positions, the prompt's length by default)."""
        logits, cache, _ = self._full_forward(batch, "prefill", capacity=capacity,
                                              last_only=True)
        return logits[:, -1], cache

    @torch.inference_mode()
    def decode_step(self, cache: Dict, tokens):
        """One token per request (tokens (B, 1)): -> (logits (B, V), the
        same cache, updated in place)."""
        logits, cache, _ = self._full_forward({"tokens": tokens}, "decode", cache)
        return logits[:, -1], cache

    @torch.inference_mode()
    def forward(self, batch: Dict) -> torch.Tensor:
        """Every position's logits of a full prefill (B, S, V): the
        reference's ``_full_forward(params, batch, "prefill")[0]``."""
        return self._full_forward(batch, "prefill")[0]
