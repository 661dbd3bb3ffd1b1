"""One training step of K data-parallel nodes under a gradient
compressor of the LGC paper (Section V), in plain PyTorch and float32:
``none`` (the dense mean), ``dgc`` (top-k with momentum correction) and
``lgc_rar`` (top-k, then the autoencoder of the ring-allreduce pattern).

The flat gradient is every weight raveled, in sorted path order (the
order in which JAX flattens a tree of dicts).  A weight whose path has
an ``embed`` segment is exempt and sent dense; one with ``lm_head`` or
``fc`` is sent as its own top-k without the autoencoder; every other is
compressed, its k = max(1, round(size * sparsity)).  Per node the error
feedback accumulates u <- m u + g, v <- v + u, each leaf's k entries of
largest |v| are selected, and u, v are zeroed where they were sent.
``lgc_rar`` ships the rotating leader's (step mod K) sorted index set
(padded with the sentinel n to a multiple of 16); every node gathers its
v there; while the autoencoder trains (phase ``topk_ae``) the node mean
of those values is the update and the autoencoder takes one SGD step on
them (global-norm clip 1, momentum 0.9); in phase ``compressed`` each
node encodes its values, the encodings are averaged and decoded.  On the
``ring_packed`` wire ``dgc``'s pairs travel as int8 values, one scale
per 256 of the index-sorted pairs.  AdamW then updates the weights with
the decoded gradient, after a clip of its global norm, and stores them
in their configured dtype.

``fault`` breaks the step as a faulty program would: ``frozen`` returns
the weights and the optimizer's state unchanged, ``half_batch`` gives
every node node 0's rows (the mean over half of the batch), and
``no_exchange`` leaves out every exchange between the nodes (each takes
its own values; the result is node 0's)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from lgcref import ae as AE
from lgcref import common

FAULTS = ("frozen", "half_batch", "no_exchange")
SCALE_BLOCK = 256


@dataclass(frozen=True)
class Leaf:
    path: str
    offset: int
    size: int
    role: str                   # dense | topk_only | compressed
    k: int


def layout(spec, sparsity: float) -> List[Leaf]:
    """The flat gradient's leaves, in sorted path order."""
    out, off = [], 0
    for path, shape, _dt, _init in sorted(spec,
                                         key=lambda s: s[0].split("/")):
        size = math.prod(shape)
        segs = path.split("/")
        role = "dense" if "embed" in segs else \
            "topk_only" if ("lm_head" in segs or "fc" in segs) else \
            "compressed"
        k = 0 if role == "dense" else max(1, int(round(size * sparsity)))
        out.append(Leaf(path, off, size, role, k))
        off += size
    return out


def cosine_lr(base: float, total: int, step: int) -> float:
    """Linear warm-up over min(100, total // 10) steps, then a cosine to 0
    at ``total``."""
    warm = min(100, total // 10)
    if step < warm:
        return base * min(step / max(warm, 1), 1.0)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * 0.5 * (1.0 + math.cos(math.pi * t))


def _int8_wire(vals, idx):
    """Pairs as the packed wire delivers them: sorted by index, values
    rounded to int8 with one f32 scale per 256 (amax / 127, half to
    even)."""
    order = torch.argsort(idx, stable=True)
    vals, idx = vals[order], idx[order]
    k = vals.shape[0]
    xb = torch.nn.functional.pad(vals, (0, (-k) % SCALE_BLOCK)) \
        .view(-1, SCALE_BLOCK)
    scale = xb.abs().amax(1, keepdim=True).clamp(min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale), -127, 127)
    return (q * scale).reshape(-1)[:k], idx


class Reference:
    """K nodes' training state and step.  ``model``: the family module
    (``lgcref.dense_decoder``, ``lgcref.mamba2``); ``cfg`` its
    configuration; ``train`` {optimizer "adamw", learning_rate,
    total_steps, adam_b1, adam_b2, adam_eps, weight_decay,
    grad_clip_norm}; ``comp`` {method, transport, sparsity,
    momentum_correction, ae_lr}."""

    def __init__(self, model, cfg: Dict, train: Dict, comp: Dict, K: int,
                 device, mm=common.f32_mm, fault: Optional[str] = None):
        assert fault in (None,) + FAULTS, fault
        assert train["optimizer"] == "adamw", train["optimizer"]
        assert comp["method"] in ("none", "dgc", "lgc_rar"), comp["method"]
        self.model, self.cfg, self.train, self.comp = model, cfg, train, comp
        self.K, self.device, self.mm, self.fault = K, device, mm, fault
        # float32 means float32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec = model.params_spec(cfg)
        self.leaves = layout(self.spec, comp["sparsity"])
        self.n = sum(l.size for l in self.leaves)
        self.dtypes = {p: getattr(torch, dt) for p, _s, dt, _i in self.spec}

    # -- state -----------------------------------------------------------

    def init(self, weights: Dict[str, torch.Tensor],
             ae: Optional[Dict[str, torch.Tensor]] = None):
        """The weights as drawn (their stored dtypes) and, for lgc, the
        autoencoder's; every other state starts at zero."""
        dev, K, n = self.device, self.K, self.n
        self.params = {p: w.to(dev, self.dtypes[p]).clone()
                       for p, w in weights.items()}
        self.m = {p: torch.zeros(w.shape, device=dev)
                  for p, w in self.params.items()}
        self.v = {p: torch.zeros(w.shape, device=dev)
                  for p, w in self.params.items()}
        if self.comp["method"] != "none":
            self.u_ef = torch.zeros((K, n), device=dev)
            self.v_ef = torch.zeros((K, n), device=dev)
        if ae is not None:
            self.ae = {p: w.to(dev, torch.float32).clone()
                       for p, w in ae.items()}
            self.ae_mom = {p: torch.zeros_like(w)
                           for p, w in self.ae.items()}

    # -- the step --------------------------------------------------------

    def _node_grads(self, tokens, labels):
        """(K, n) gradients and the node-mean loss."""
        K, B = self.K, tokens.shape[0]
        rows = B // K
        W = {p: w.float().requires_grad_(True)
             for p, w in self.params.items()}
        G = torch.empty((K, self.n), device=self.device)
        losses = []
        for k in range(K):
            r = 0 if self.fault == "half_batch" else k
            sl = slice(r * rows, (r + 1) * rows)
            loss = common.loss(self.model, self.cfg, W, tokens[sl],
                               labels[sl], self.mm)
            grads = torch.autograd.grad(loss, [W[l.path]
                                               for l in self.leaves])
            for leaf, g in zip(self.leaves, grads):
                G[k, leaf.offset:leaf.offset + leaf.size] = g.reshape(-1)
            del grads
            losses.append(float(loss.detach()))
        return G, sum(losses) / K

    def _mean(self, x):
        """The node mean of (K, ...) values; node 0's own without an
        exchange."""
        return x[0] if self.fault == "no_exchange" else x.mean(0)

    def _select(self, k: int, roles):
        """Node k's top-k pairs over the leaves of ``roles``: (vals, idx)
        in leaf order, each leaf's by |v| descending."""
        v = self.v_ef[k]
        vals, idx = [], []
        for leaf in self.leaves:
            if leaf.role not in roles:
                continue
            seg = v[leaf.offset:leaf.offset + leaf.size]
            i = torch.topk(seg.abs(), leaf.k, sorted=True).indices
            vals.append(seg[i])
            idx.append(i + leaf.offset)
        if not vals:
            return (torch.zeros(0, device=self.device),
                    torch.zeros(0, dtype=torch.long, device=self.device))
        return torch.cat(vals), torch.cat(idx)

    def _sparse_mean(self, pairs):
        """Node mean of each node's pairs scattered densely."""
        n, packed = self.n, self.comp["transport"] == "ring_packed"
        rows = []
        for vals, idx in pairs:
            if packed and vals.numel():
                vals, idx = _int8_wire(vals, idx)
            row = torch.zeros(n + 1, device=self.device)
            row.index_add_(0, idx.clamp(max=n), vals)
            rows.append(row[:n])
        return self._mean(torch.stack(rows))

    def _clear(self, k: int, idx):
        idx = idx[idx < self.n]
        self.u_ef[k, idx] = 0.0
        self.v_ef[k, idx] = 0.0

    def _dense_part(self, G):
        out = torch.zeros(self.n, device=self.device)
        for leaf in self.leaves:
            if leaf.role == "dense":
                sl = slice(leaf.offset, leaf.offset + leaf.size)
                out[sl] = self._mean(G[:, sl])
        return out

    def _compress(self, G, step: int, phase: str):
        """The decoded global gradient (n,) of this step."""
        method, K, n = self.comp["method"], self.K, self.n
        if method == "none" or phase == "warmup":
            return self._mean(G)
        m = self.comp["momentum_correction"]
        self.u_ef.mul_(m).add_(G)
        self.v_ef.add_(self.u_ef)
        last = [self._select(k, ("topk_only",)) for k in range(K)]
        out = self._dense_part(G) + self._sparse_mean(last)
        if method == "dgc":
            own = [self._select(k, ("compressed",)) for k in range(K)]
            out += self._sparse_mean(own)
            for k in range(K):
                self._clear(k, torch.cat([own[k][1], last[k][1]]))
            return out
        # lgc_rar: the leader's sorted support, padded to a multiple of 16
        mu = sum(l.k for l in self.leaves if l.role == "compressed")
        pad = (-mu) % AE.ALIGN
        leader = 0 if self.fault == "no_exchange" else step % K
        support = torch.sort(self._select(leader, ("compressed",))[1])[0]
        support = torch.cat([support, torch.full((pad,), n, dtype=torch.long,
                                                 device=self.device)])
        safe = support.clamp(max=n - 1)
        vals = torch.stack([torch.where(support < n, self.v_ef[k, safe], 0.0)
                            for k in range(K)])
        if phase == "topk_ae":
            sent = self._mean(vals)
            self._train_ae(vals[:1] if self.fault == "no_exchange" else vals)
        else:
            z = self._mean(AE.encode(self.ae, vals))
            sent = AE.decode(self.ae, z[None])[0]
        row = torch.zeros(n + 1, device=self.device)
        row.index_add_(0, support, sent)
        out += row[:n]
        for k in range(K):
            self._clear(k, torch.cat([support, last[k][1]]))
        return out

    def _train_ae(self, vals):
        paths = list(self.ae)
        ws = [self.ae[p].requires_grad_(True) for p in paths]
        with torch.enable_grad():
            loss = AE.loss(dict(zip(paths, ws)), vals)
            grads = torch.autograd.grad(loss, ws)
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(1.0 / gnorm.clamp(min=1e-12), max=1.0)
        lr = self.comp["ae_lr"]
        for p, w, g in zip(paths, ws, grads):
            self.ae_mom[p] = 0.9 * self.ae_mom[p] + g * scale
            self.ae[p] = (w.detach() - lr * self.ae_mom[p])

    def _adamw(self, g_flat, step: int):
        tr = self.train
        b1, b2, eps = tr["adam_b1"], tr["adam_b2"], tr["adam_eps"]
        clip = tr["grad_clip_norm"]
        if clip:
            gnorm = float(torch.sqrt((g_flat * g_flat).sum()))
            g_flat = g_flat * min(1.0, clip / max(gnorm, 1e-12))
        lr = cosine_lr(tr["learning_rate"], tr["total_steps"], step)
        t = step + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for leaf in self.leaves:
            p = leaf.path
            g = g_flat[leaf.offset:leaf.offset + leaf.size].view(
                self.params[p].shape)
            self.m[p] = b1 * self.m[p] + (1 - b1) * g
            self.v[p] = b2 * self.v[p] + (1 - b2) * g * g
            d = (self.m[p] / c1) / (torch.sqrt(self.v[p] / c2) + eps)
            w = self.params[p].float()
            d = d + tr["weight_decay"] * w
            self.params[p] = (w - lr * d).to(self.dtypes[p])

    def step(self, tokens, labels, step: int, phase: str) -> float:
        """One step on the (K·rows, S) batch; returns the node-mean loss."""
        G, loss = self._node_grads(tokens, labels)
        with torch.no_grad():
            g = self._compress(G, step, phase)
            del G
            if self.fault != "frozen":
                self._adamw(g, step)
        return loss

    # -- what the comparison reads -----------------------------------------

    def grad_norms(self) -> Dict[str, float]:
        """Each leaf's norm of the gradient AdamW took, from its first
        moment after one step: m / (1 - b1)."""
        b1 = self.train["adam_b1"]
        return {p: float(torch.linalg.vector_norm(m)) / (1 - b1)
                for p, m in self.m.items()}


def phase(method: str, step: int, warmup_steps: int,
          ae_train_steps: int) -> str:
    """The paper's three-phase schedule (Section V-B): dense warm-up, then
    top-k while the autoencoder trains, then compressed; top-k methods
    stay in the second phase, ``none`` in the first."""
    if method == "none" or step < warmup_steps:
        return "warmup"
    if method.startswith("lgc"):
        return "topk_ae" if step < warmup_steps + ae_train_steps \
            else "compressed"
    return "topk_ae"
