"""The decoder of superblocks (counterpart of ``repro.models.model``):
a ``block_pattern`` of attention, Mamba2 and cross-attention blocks,
each followed by a SwiGLU or, at the MoE positions (``_moe_at``), a
routed MoE FFN; with ``cfg.mla`` every attention position is latent
attention, and ``cfg.mtp_depth`` > 0 adds the multi-token prediction
head.  The dense family, musicgen's, arctic (MoE), mamba2 (Mamba2
alone), jamba (both in one 8-position superblock), deepseek-v3 (latent
attention, MoE with a shared expert, MTP) and llama-3.2-vision (four
attention blocks and one cross-attention block a superblock).

Params keep the reference's tree: ``{"embed": {"w"}, "final_norm":
{"scale"}, "blocks": {"p0": {"mixer": ..., ["ffn": ...]}, "p1": ...},
["lm_head"], ["mtp": {"proj", "norm_h", "norm_e", "block"}]}`` with
every block leaf stacked along a leading ``n_blocks`` axis per pattern
position (the MTP block is one position, unstacked), so the flat
gradient has the reference's layout.  ``loss`` remats each superblock
and each cross-entropy chunk (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does; the MoE layers' aux losses are
summed into the loss and into ``metrics["aux_loss"]`` in the
reference's order (the MTP block's is discarded, as there).  Attention
keeps no (S, S) matrix (``flash``), so training lengths reach the
reference's ``train_4k``.  A batch may carry ``"encoder_embeds"`` (B,
num_encoder_tokens, encoder_dim), which the cross-attention blocks read.
Serving: ``init_cache``, ``prefill`` (the prompt's last-token logits and
the filled cache) and ``decode_step`` (one token from the cache, which
it updates in place; MoE dropless, as the reference's decode), with the
cache tree ``{"p{i}": ...}`` stacked over the blocks as the reference
stacks it: attention ``{"k", "v": (n_blocks, B, S, KH, hd), "pos":
(n_blocks, S)}``, latent attention ``{"c_kv": (n_blocks, B, S, r),
"k_rope": (n_blocks, B, S, rope), "pos"}``, Mamba2 ``{"conv":
(n_blocks, B, d_conv - 1, conv_dim), "ssm": (n_blocks, B, H, N, P)}``,
cross-attention ``{"k", "v": (n_blocks, B, T, KH, hd)}`` in f32, the
dtype the prefill computes them in from the f32 embeddings (the
reference's ``init_cache`` declares the model dtype there, but its
prefill returns f32).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, CROSS, MAMBA, MLA, ModelConfig
from repro_torch.dist import sharding as SH
from repro_torch.dist import tp as TP
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.utils.tree import (keystr_path, tree_count_params,
                                    tree_leaves_with_path, tree_map,
                                    tree_unflatten)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig):
    return _DTYPES[cfg.dtype]


def _moe_at(cfg: ModelConfig, pos: int) -> bool:
    if cfg.moe is None:
        return False
    n = cfg.moe.every_n_layers
    return pos % n == n - 1


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # a sharded forward (``dist.tp.Shards``): each process holds its
    # shards of the params and computes on them with explicit collectives
    tp: Optional[TP.Shards] = None

    def __post_init__(self):
        cfg = self.cfg
        for kind in cfg.block_pattern:
            if kind == MLA:
                # the reference builds this kind's params, but its loss,
                # prefill and decode skip the mixer and its init_cache
                # raises; latent attention is cfg.mla on ATTN positions
                raise ValueError(
                    f"{cfg.name}: block kind {MLA!r} is not run by the "
                    "reference's forward (a reference fault, ROADMAP.md "
                    "Queue 3): set cfg.mla and use 'attn' positions")
            if kind not in (ATTN, MAMBA, CROSS):
                raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
        if MAMBA in cfg.block_pattern and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a mamba block needs cfg.ssm")
        if CROSS in cfg.block_pattern and not (cfg.num_encoder_tokens
                                               and cfg.encoder_dim):
            raise ValueError(f"{cfg.name}: a cross block needs "
                             "num_encoder_tokens and encoder_dim")

    @property
    def mp(self) -> int:
        return self.tp.mp if self.tp is not None else 1

    def _tpm(self):
        """The Shards when the heads are split over ``model``, else None."""
        return self.tp if self.mp > 1 else None

    def _w(self, params, path: str):
        """The leaf at ``path``, its data-sharded dims gathered."""
        x = params
        for key in path.split("/"):
            x = x[key]
        return x if self.tp is None else self.tp.leaf(path, x)

    def _sub(self, params, prefix: str):
        """The subtree at ``prefix``, every leaf gathered."""
        if self.tp is None:
            return params[prefix]
        return tree_unflatten(params[prefix], [
            self.tp.leaf(f"{prefix}/{keystr_path(path)}", x)
            for path, x in tree_leaves_with_path(params[prefix])])

    def _block(self, params, i: int):
        if self.tp is None:
            return _block(params, i)
        return self.tp.block(params["blocks"], i)

    def _embed(self, params, tokens):
        """The embedding rows of ``tokens``; over a vocab-sharded table,
        each shard's own rows (zero elsewhere) summed over ``model``."""
        w = self._w(params, "embed/w")
        if w.shape[0] == self.cfg.vocab_size:
            return w[tokens]
        Vl = w.shape[0]
        ids = tokens - self.tp.m * Vl
        mine = (ids >= 0) & (ids < Vl)
        h = w[ids.clamp(0, Vl - 1)].masked_fill(~mine[..., None], 0)
        return self.tp.reduce(h)

    def _logits(self, h, w):
        """(h @ w) in f32, a vocab-sharded head's columns gathered."""
        logits = (h @ w).float()
        if w.shape[-1] != self.cfg.vocab_size:
            logits = self.tp.model.all_gather(logits, -1)
        return logits

    def _init_position(self, gen, pos: int, device, lead):
        """Params of pattern position ``pos``, stacked over ``lead``."""
        cfg, dtype = self.cfg, _dtype(self.cfg)
        kind = cfg.block_pattern[pos]
        if kind == ATTN:
            init = L.init_mla if cfg.mla is not None else L.init_attention
        elif kind == MAMBA:
            init = M.init_mamba
        else:
            init = L.init_cross_attention
        p: Dict[str, Any] = {"mixer": init(gen, cfg, dtype, device, lead)}
        if _has_ffn(cfg):
            p["ffn"] = (L.init_moe(gen, cfg, dtype, device, lead)
                        if _moe_at(cfg, pos) else
                        L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype,
                                      device, lead))
        return p

    def init(self, gen: torch.Generator, device="cpu",
             place=None) -> Dict[str, Any]:
        """The seeded weights.  ``place(path, part)``, where given, takes
        each part as soon as it is drawn (a top-level entry, each pattern
        position's blocks, each entry of the MTP block) and returns what
        is kept of it: a caller that keeps a block of each leaf holds one
        whole part at a time, not the whole model.  The draws are the same
        either way."""
        cfg, dtype = self.cfg, _dtype(self.cfg)
        put = place or (lambda path, part: part)
        lead = (cfg.n_blocks,)
        params: Dict[str, Any] = {
            "embed": put("embed", {"w": L._dense_init(
                gen, (cfg.vocab_size, cfg.d_model), dtype, device,
                scale=0.02)}),
            "final_norm": put("final_norm",
                              L.init_rmsnorm(cfg.d_model, dtype, device)),
            "blocks": {f"p{i}": put(f"blocks/p{i}", self._init_position(
                gen, i, device, lead))
                for i in range(len(cfg.block_pattern))},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = put("lm_head", L.init_linear(
                gen, cfg.d_model, cfg.vocab_size, dtype, device))
        if cfg.mtp_depth > 0:
            # one block, whatever the depth, as the reference builds it:
            # [norm_h(h_t); norm_e(embed(token_t+1))] projected to
            # d_model, then pattern position 0's mixer and FFN
            params["mtp"] = {
                "proj": put("mtp/proj", L.init_linear(
                    gen, 2 * cfg.d_model, cfg.d_model, dtype, device)),
                "norm_h": put("mtp/norm_h",
                              L.init_rmsnorm(cfg.d_model, dtype, device)),
                "norm_e": put("mtp/norm_e",
                              L.init_rmsnorm(cfg.d_model, dtype, device)),
                "block": put("mtp/block",
                             self._init_position(gen, 0, device, ())),
            }
        return params

    def _lm_head_w(self, params):
        if self.cfg.tie_embeddings:
            return self._w(params, "embed/w").T
        return self._w(params, "lm_head/w")

    def _mixer(self, p, kind: str, h, positions, enc):
        """One position's mixer, for training (and the MTP block)."""
        cfg, tp = self.cfg, self._tpm()
        if kind == ATTN:
            if cfg.mla is not None:
                return L.mla_fwd(p, cfg, h, positions, tp)[0]
            return L.attention_fwd(p, cfg, h, positions, tp)[0]
        if kind == MAMBA:
            return M.mamba_fwd(p, cfg, h, tp=tp)
        return L.cross_attention_fwd(p, cfg, h,
                                     L.cross_attention_kv(p, cfg, enc, tp),
                                     tp)

    def _ffn(self, p, pos: int, h, aux=None, dropless: bool = False):
        """Position ``pos``'s FFN, if it has one; a MoE layer's aux loss
        is added to ``aux`` (when given; else it is left this member's,
        its collectives under ``tp.batch`` saved).  A MoE layer reads the
        whole Shards: its experts over ``model``, its batch over
        ``batch``."""
        if "ffn" not in p:
            return h, aux
        if _moe_at(self.cfg, pos):
            h, a = L.moe_fwd(p["ffn"], self.cfg, h, dropless=dropless,
                             tp=self.tp, whole_aux=aux is not None)
            return h, (None if aux is None else aux + a)
        return L.swiglu_fwd(p["ffn"], h, self.cfg.rms_norm_eps,
                            tp=self._ffn_tp(p["ffn"])), aux

    def _ffn_tp(self, p):
        """The Shards when this SwiGLU's hidden dim is split over
        ``model`` (its spec put ``model`` there), else None."""
        if self.mp > 1 and p["w_gate"]["w"].shape[-1] != self.cfg.d_ff:
            return self.tp
        return None

    def _block_fn(self, params, i: int, h, aux, positions, enc):
        """Superblock i, every pattern position in order: (h, aux)."""
        blk = self._block(params, i)
        for pos, kind in enumerate(self.cfg.block_pattern):
            p = blk[f"p{pos}"]
            h = self._mixer(p["mixer"], kind, h, positions, enc)
            h, aux = self._ffn(p, pos, h, aux)
        return h, aux

    def _trunk(self, params, tokens, enc=None, remat: bool = False):
        """Embedding and superblocks: the hidden states (B, S, D) before
        the final norm, and the summed aux loss (f32 scalar).  ``enc``:
        the encoder embeddings of the cross blocks.  ``remat``: each
        superblock under ``checkpoint``, which keeps only its inputs and
        recomputes the rest in the backward."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(self.cfg.n_blocks):
            if remat:
                # non-reentrant: the params reach the block through the
                # closure, and node_grads differentiates with respect to
                # them; the blocks draw no random numbers
                h, aux = checkpoint(self._block_fn, params, i, h, aux,
                                    positions, enc, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                h, aux = self._block_fn(params, i, h, aux, positions, enc)
        return h, aux

    def _nb(self) -> int:
        return self.tp.nb if self.tp is not None else 1

    def loss(self, params, batch, remat: Optional[bool] = None):
        """batch: {"tokens": (B, S), "labels": (B, S) (-1 = pad),
        ["encoder_embeds": (B, T, encoder_dim)]} on the params' device.
        ``remat`` None or True recomputes each block and each
        cross-entropy chunk in the backward (the reference's default):
        the same operations on the same inputs, so the same values (bit
        for bit where the embedding's backward sums in a fixed order).
        The loss is (the mean cross-entropy + 0.3 x the MTP loss) + the
        MoE layers' aux, in the reference's order.  Returns (loss,
        metrics).

        With ``tp.batch`` (n members, each holding a block of the batch's
        rows) the loss is this member's share of the whole batch's: its
        cross-entropy sums over the whole batch's valid tokens (and the
        MTP head's), and 1/n of the aux, which the MoE layers compute
        from the whole batch; so the members' losses, metrics and
        gradients sum to the whole batch's."""
        cfg = self.cfg
        remat = True if remat is None else remat
        tokens, labels = batch["tokens"], batch["labels"]
        h, aux = self._trunk(params, tokens, batch.get("encoder_embeds"),
                             remat=remat)
        h = L.rmsnorm(self._sub(params, "final_norm"), h, cfg.rms_norm_eps)
        xent, n_tok = self._xent(h, self._lm_head_w(params), labels, remat)
        loss = xent / torch.clamp(self._count(n_tok), min=1.0)
        if self._nb() > 1:
            aux = aux / self._nb()
        metrics = {"xent": loss, "aux_loss": aux, "tokens": n_tok}
        if cfg.mtp_depth > 0:
            mtp = self._mtp_loss(params, h, tokens, labels, remat)
            metrics["mtp_loss"] = mtp
            loss = loss + 0.3 * mtp
        loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    def _count(self, n_tok):
        """The valid tokens of the whole batch (``tp.batch``'s sum)."""
        if self._nb() == 1:
            return n_tok
        return self.tp.batch.all_reduce(n_tok.detach())

    def _mtp_loss(self, params, h, tokens, labels, remat: bool):
        """The multi-token prediction head (depth 1): from h after the
        final norm, [norm_h(h_t); norm_e(embed(token_t+1))] projected,
        position 0's block at length S - 1 (its MoE aux discarded, as
        in the reference), the final norm again, and the cross-entropy
        against labels[:, 1:] (token t + 2).  S - 1 is odd at the usual
        lengths (127, 4095), where the reference's chunk rules collapse
        (flash's ``_chunks`` to 1-row query chunks past 512 rows, the
        cross-entropy's halving to 1-row chunks); ``flash.chunk_plan``
        and ``xent_chunk_plan`` pad instead, with the same values up to
        the order of f32 sums.  Under tensor parallelism ``proj`` is a
        column shard, its output gathered (or, where its columns do not
        divide, a replicated weight every shard applies alike), the next
        token's embedding is the vocab-parallel one and the block runs
        sharded."""
        cfg, tp = self.cfg, self._tpm()
        p = self._sub(params, "mtp")
        e_next = self._embed(params, tokens[:, 1:])
        hh = torch.cat([L.rmsnorm(p["norm_h"], h[:, :-1], cfg.rms_norm_eps),
                        L.rmsnorm(p["norm_e"], e_next, cfg.rms_norm_eps)],
                       dim=-1)
        hm = L._latent(p["proj"], hh, hh if tp is None else tp.copy(hh),
                       cfg.d_model, tp)
        positions = torch.arange(tokens.shape[1] - 1, device=tokens.device)
        hm = self._mixer(p["block"]["mixer"], cfg.block_pattern[0], hm,
                         positions, None)
        hm, _ = self._ffn(p["block"], 0, hm)
        hm = L.rmsnorm(self._sub(params, "final_norm"), hm, cfg.rms_norm_eps)
        xent, n_tok = self._xent(hm, self._lm_head_w(params), labels[:, 1:],
                                 remat)
        return xent / torch.clamp(self._count(n_tok), min=1.0)

    def _xent(self, h, w, labels, remat: bool):
        """(sum of xent, valid tokens); over a vocab-sharded head, the
        vocab-parallel cross-entropy on the full vocabulary's chunk
        plan."""
        if w.shape[-1] == self.cfg.vocab_size:
            return _chunked_xent(h, w, labels, remat=remat)
        return _chunked_xent(self.tp.copy(h), w, labels, remat=remat,
                             group=self.tp.model,
                             vocab=self.cfg.vocab_size)

    def param_count(self) -> int:
        return tree_count_params(self.init(torch.Generator(), "meta"))

    # -- inference ------------------------------------------------------------

    def _seq(self):
        return self.tp.seq if self.tp is not None else None

    def init_cache(self, batch: int, seq_len: int, device="cpu"):
        """An empty cache for ``seq_len`` positions (the window under a
        sliding window), per pattern position, stacked over the blocks.
        A cross position's k, v are f32 (see the module docstring).
        Sharded, each leaf is this process's block under the reference's
        cache rule (``dist.sharding.cache_pspecs``): dim 3 over ``model``
        where it divides (attention's and cross-attention's kv heads, the
        latent's and the rope key's last dim, Mamba2's conv channels and
        its state's N); split along the sequence (``tp.seq``), dim 2 over
        it where ``tp.seq_dp`` (pod x data) divides it (the slots, the
        encoder tokens, the state's heads, the conv state's rows) and a
        position ring's slots."""
        cfg, dtype = self.cfg, _dtype(self.cfg)
        seq = self._seq()
        if self.mp == 1 and seq is None:
            return self._cache_tree(batch, seq_len, dtype, device)
        full = self._cache_tree(batch, seq_len, dtype, "meta")
        n = seq.size if seq is not None else 1
        specs = SH.cache_pspecs(
            full, dp_axes=("data",) if seq is not None else (),
            dp_size=self.tp.seq_dp or n, model_size=self.mp,
            seq_shard_axis="data" if seq else None)
        sizes = {"data": n, "model": self.mp}
        leaves = []
        for path, x in tree_leaves_with_path(full):
            key = keystr_path(path)
            shape = SH.local_shape(tuple(x.shape), specs[key], sizes)
            if key.endswith("/pos"):
                leaves.append(torch.full(shape, L.INT32_MAX, dtype=x.dtype,
                                         device=device))
            else:
                leaves.append(torch.zeros(shape, dtype=x.dtype,
                                          device=device))
        return tree_unflatten(full, leaves)

    def _cache_tree(self, batch: int, seq_len: int, dtype, device):
        cfg = self.cfg
        lead = (cfg.n_blocks,)

        def one_position(kind):
            if kind == ATTN:
                if cfg.mla is not None:
                    return L.init_mla_cache(cfg, batch, seq_len, dtype,
                                            device, lead)
                return L.init_attention_cache(cfg, batch, seq_len, dtype,
                                              device, lead)
            if kind == MAMBA:
                return M.init_mamba_cache(cfg, batch, dtype, device, lead)
            shape = lead + (batch, cfg.num_encoder_tokens, cfg.n_kv_heads,
                            cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=torch.float32,
                                     device=device),
                    "v": torch.zeros(shape, dtype=torch.float32,
                                     device=device)}
        return {f"p{i}": one_position(kind)
                for i, kind in enumerate(cfg.block_pattern)}

    def _held(self, full, like):
        """The block of ``full`` (one superblock's leaf, whole) that this
        process's cache leaf ``like`` holds: dim 1 (the slots, encoder
        tokens or state heads) split along the sequence group, dim 2 (the
        kv heads, latent, rope key, conv channels or N) over ``model``."""
        seq = self._seq()
        for d, idx in ((1, seq.index if seq is not None else 0),
                       (2, self.tp.m if self.tp is not None else 0)):
            if full.dim() > d and full.shape[d] != like.shape[d]:
                full = full.narrow(d, idx * like.shape[d], like.shape[d])
        return full

    def _prompt_slots(self, S: int, n_slots: int, device):
        """(positions, slots): which of an S-token prompt's positions this
        process's ``n_slots`` cache slots keep, and where.  The cache's
        slots, split along the sequence over ``tp.seq`` (member i holding
        [i·n_slots, (i+1)·n_slots) of R = n_slots·n) or whole (R =
        n_slots), keep the last R positions of the prompt at slot pos %
        R: the reference's ``_window_cache`` ring under a sliding window
        (R the window), slot = pos otherwise (R >= S)."""
        seq = self._seq()
        n, i = (seq.size, seq.index) if seq is not None else (1, 0)
        R = n_slots * n
        start = max(0, S - R)
        pos = start + (i * n_slots + torch.arange(n_slots) - start) % R
        mine = pos < S
        return pos[mine].to(device), torch.arange(n_slots)[mine].to(device)

    @torch.no_grad()
    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Process a whole prompt (no gradient, no remat; MoE with its
        capacity, as the reference's prefill).  batch: {"tokens": (B,
        S), ["encoder_embeds"]} on the params' device; cache_len: the
        attention caches' capacity (>= S, default S).  Returns (last-token
        logits (B, 1, V) f32, the filled cache: under a sliding window, a
        prompt longer than the window keeps its last ``window`` positions
        in ring order, slot = pos % window; a Mamba2 position keeps its
        conv and SSM state, a cross position the encoder tokens' k, v).
        Sharded, every process computes the whole prompt of its rows and
        keeps its block of the cache (``init_cache``)."""
        cfg, tp = self.cfg, self._tpm()
        tokens = batch["tokens"]
        enc = batch.get("encoder_embeds")
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        cache = self.init_cache(B, cache_len or S, tokens.device)
        ring = None
        h = self._embed(params, tokens)
        for i in range(cfg.n_blocks):
            blk = self._block(params, i)
            for pos, kind in enumerate(cfg.block_pattern):
                p, c = blk[f"p{pos}"], cache[f"p{pos}"]
                if kind == ATTN:
                    if cfg.mla is not None:
                        h, kv = L.mla_fwd(p["mixer"], cfg, h, positions, tp)
                        names = ("c_kv", "k_rope")
                    else:
                        h, kv = L.attention_fwd(p["mixer"], cfg, h,
                                                positions, tp)
                        names = ("k", "v")
                    if ring is None:
                        ring = self._prompt_slots(S, c["pos"].shape[1],
                                                  tokens.device)
                    keep, slots = ring
                    for name, x in zip(names, kv):
                        dst = c[name][i]
                        if x.shape[-1] != dst.shape[-1]:
                            # the latent's or rope key's model block
                            x = x.narrow(-1, tp.m * dst.shape[-1],
                                         dst.shape[-1])
                        dst[:, slots] = x[:, keep]
                    c["pos"][i, slots] = keep.to(torch.int32)
                elif kind == MAMBA:
                    h, st = M.mamba_fwd(p["mixer"], cfg, h, with_state=True,
                                        tp=tp)
                    for name in ("conv", "ssm"):
                        c[name][i].copy_(self._held(st[name], c[name][i]))
                else:
                    k, v = L.cross_attention_kv(p["mixer"], cfg, enc, tp)
                    h = L.cross_attention_fwd(p["mixer"], cfg, h, (k, v), tp)
                    c["k"][i].copy_(self._held(k, c["k"][i]))
                    c["v"][i].copy_(self._held(v, c["v"][i]))
                h, _ = self._ffn(p, pos, h)
        h = L.rmsnorm(self._sub(params, "final_norm"), h[:, -1:],
                      cfg.rms_norm_eps)
        return self._logits(h, self._lm_head_w(params)), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos: int):
        """One decode step.  tokens: (B, 1); pos: the current absolute
        position.  Writes the token's k, v (attention), its latent and
        rope key (latent attention) and the new conv and SSM states
        (Mamba2) into the cache in place; a cross position reads its
        cached k, v.  Returns (logits (B, 1, V) f32, the cache).  MoE
        runs dropless: few tokens a step, so capacity would drop them."""
        cfg, tp = self.cfg, self._tpm()
        seq = self._seq()
        h = self._embed(params, tokens)
        for i in range(cfg.n_blocks):
            blk = self._block(params, i)
            for j, kind in enumerate(cfg.block_pattern):
                p = blk[f"p{j}"]
                c = {key: x[i] for key, x in cache[f"p{j}"].items()}  # views
                if kind == ATTN and cfg.mla is not None:
                    h, _ = L.mla_decode(p["mixer"], cfg, h, c, pos, tp, seq)
                elif kind == ATTN:
                    h, _ = L.attention_decode(p["mixer"], cfg, h, c, pos,
                                              tp, seq)
                elif kind == MAMBA:
                    h, _ = M.mamba_decode(p["mixer"], cfg, h, c, tp, seq)
                else:
                    h = L.cross_attention_fwd(
                        p["mixer"], cfg, h, (c["k"], c["v"]), tp,
                        seq if c["k"].shape[1] != cfg.num_encoder_tokens
                        else None)
                h, _ = self._ffn(p, j, h, dropless=True)
        h = L.rmsnorm(self._sub(params, "final_norm"), h, cfg.rms_norm_eps)
        return self._logits(h, self._lm_head_w(params)), cache


def _block(params, i: int):
    """Superblock i's params, {"p{pos}": ...}: a view of each stacked
    leaf."""
    return tree_map(lambda t: t[i], params["blocks"])


def _xent_chunk(hc, w, lb):
    """One chunk's (sum of xent, valid tokens)."""
    V = w.shape[-1]
    logits = (hc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb.clamp(0, V - 1).long()[..., None])[..., 0]
    valid = (lb >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def xent_chunk_plan(S: int, target: int):
    """(chunk, padded length) of the cross-entropy: the reference's chunk
    (halved from ``target`` until it divides S) where that is at least
    min(target, 32) rows or the whole length.  Else the reference's rule
    has collapsed (vocab 50280 at batch 4: 333 -> 166 -> 83 -> ... -> 2
    rows at S = 128 or 4096, a chunk's matmul per 2 tokens): the whole
    length when S <= target, otherwise the largest power of two <=
    target, S padded up to a multiple of it."""
    chunk = target
    while S % chunk:
        chunk //= 2
    if chunk >= min(target, 32) or chunk == S:
        return chunk, S
    if S <= target:
        return S, S
    chunk = 1 << (target.bit_length() - 1)
    return chunk, -(-S // chunk) * chunk


def _xent_chunk_vp(hc, w, lb, group, lo: int):
    """One chunk's (sum of xent, valid tokens) over this shard's vocab
    columns [lo, lo + w.shape[-1]): the max and the sum of exponentials
    all-reduced over ``group``, the target logit from the shard that
    holds it."""
    Vl = w.shape[-1]
    logits = (hc @ w).float()
    mx = TP.all_reduce_max(logits.amax(-1), group)
    se = TP.reduce_from(torch.exp(logits - mx[..., None]).sum(-1), group)
    lse = mx + torch.log(se)
    ids = lb.long() - lo
    mine = (ids >= 0) & (ids < Vl)
    gold = logits.gather(-1, ids.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = TP.reduce_from(torch.where(mine, gold, 0.0), group)
    valid = (lb >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _chunked_xent(h, w, labels, target_chunk_bytes: int = 2 ** 28,
                  remat: bool = False, group=None, vocab: int = 0):
    """Cross-entropy in sequence chunks, summed in order, so the (B,
    chunk, V) logits, not (B, S, V), bound the memory; with ``remat`` each
    chunk is recomputed in the backward, as the reference's
    ``jax.checkpoint`` body is, so no chunk's softmax is kept.  The chunks
    are the reference's unless its rule collapses (``xent_chunk_plan``);
    padded rows have label -1 and add exactly 0.  h: (B, S, D); w: (D,
    V); labels: (B, S), -1 = ignore.  Returns (sum_xent, n_tokens), f32
    scalars.  ``group``: w is this process's vocab shard of ``vocab``
    columns over that model group (the vocab-parallel cross-entropy, the
    full vocabulary's chunk plan)."""
    B, S, _ = h.shape
    V = vocab or w.shape[-1]
    chunk, Sp = xent_chunk_plan(
        S, max(8, min(512, target_chunk_bytes // max(1, 4 * B * V))))
    if Sp != S:
        h = torch.nn.functional.pad(h, (0, 0, 0, Sp - S))
        labels = torch.nn.functional.pad(labels, (0, Sp - S), value=-1)
    xent = torch.zeros((), dtype=torch.float32, device=h.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=h.device)
    fn = _xent_chunk
    args = ()
    if group is not None:
        fn, args = _xent_chunk_vp, (group, group.index * w.shape[-1])
    for c in range(0, Sp, chunk):
        a = (h[:, c:c + chunk], w, labels[:, c:c + chunk]) + args
        if remat:
            x, n = checkpoint(fn, *a, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, n = fn(*a)
        xent = xent + x
        n_tok = n_tok + n
    return xent, n_tok


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
