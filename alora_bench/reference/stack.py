"""The plain reference of the ``stack`` family (``families/stack.py``):
the repo's attention and Mamba2 layers, listed by ``dims["kinds"]``.

One pass teacher-forces whole sequences (a prompt and the tokens the
program served after it) layer by layer over all of them, upcasting
each layer's weights once, and returns the logits at the positions
asked for.

* attention layer: ``x += (attn(rope(q), rope(k), v)) @ wo`` over
  ``h = rmsnorm(x) * ln1``, with q/k/v = ``h @ w`` plus, at and after an
  aLoRA request's activation position, the adapter's ``(h @ A) @ B``;
  causal softmax attention with grouped K/V heads; then a SwiGLU MLP
  ``x += (silu(h2 @ w_gate) * (h2 @ w_up)) @ w_down``;
* Mamba2 layer: ``h = rmsnorm(x) * ln``; ``[z | xBC | dt] = h @ in_*``
  (plus the adapter's delta on the fused width); a causal depthwise conv
  of width W with bias and SiLU over xBC; the SSD recurrence
  ``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t s_t + D x_t``
  with ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the gated
  RMSNorm ``rmsnorm(y * silu(z)) * norm_w``; ``x += y @ out_proj``;
* final ``rmsnorm`` and the logits over the (padded) embedding rows.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from alora_bench.reference.common import (Plain, Seq, causal_attention,
                                          rmsnorm, rope, ssd_scan)


class Reference(Plain):
    """The reference over ``weights`` (the harness's tree: {"embed":
    {"tok"[, "unembed"]}, "final_norm", "layers": [...]}, any dtype) and
    ``adapters`` (per layer, per adapter: {"q"/"k"/"v": (A, B)} or
    {"in": (A, B)})."""

    @torch.no_grad()
    def logits(self, seqs: Sequence[Seq]) -> List[torch.Tensor]:
        """(len(want), padded vocab) float32 logits of each sequence."""
        dims, dev = self.dims, self.device
        emb = self.w["embed"]["tok"].to(dev, torch.float32)
        xs = [emb[torch.tensor(s.tokens, device=dev)] for s in seqs]
        for li, kind in enumerate(dims["kinds"]):
            lp = self.w["layers"][li]
            if kind == "attn":
                layer = {k: self._weight(v) for k, v in lp["attn"].items()}
                layer.update({k: self._weight(v)
                              for k, v in lp["mlp"].items()})
                norms = (lp["ln1"].to(dev, torch.float32),
                         lp["ln2"].to(dev, torch.float32))
                xs = [self._attn_layer(x, s, li, layer, norms)
                      for x, s in zip(xs, seqs)]
            else:
                p = lp["ssm"]
                layer = {k: self._weight(p[k]) for k in
                         ("in_z", "in_xbc", "in_dt", "out_proj")}
                layer.update({k: p[k].to(dev, torch.float32) for k in
                              ("conv_w", "conv_b", "A_log", "dt_bias", "D",
                               "norm_w")})
                ln = lp["ln"].to(dev, torch.float32)
                xs = [self._ssm_layer(x, s, li, layer, ln)
                      for x, s in zip(xs, seqs)]
            del layer
        fn = self.w["final_norm"].to(dev, torch.float32)
        head = emb.T if dims["tie_embeddings"] \
            else self.w["embed"]["unembed"].to(dev, torch.float32)
        if self.round:
            head = self._weight(head)
        out = []
        for x, s in zip(xs, seqs):
            h = rmsnorm(x[torch.tensor(s.want, device=dev)], fn,
                        dims["norm_eps"])
            out.append(self._lin(h, head))
        return out

    def _attn_layer(self, x, s: Seq, li: int, w, norms):
        d = self.dims
        S = x.shape[0]
        H, KV, hd = d["num_heads"], d["num_kv_heads"], d["head_dim"]
        h = rmsnorm(x, norms[0], d["norm_eps"])
        proj = {}
        for n, heads in (("q", H), ("k", KV), ("v", KV)):
            y = self._lin(h, w["w" + n])
            delta = self._adapted(h, s, li, n)
            if delta is not None:
                y = y + delta
            proj[n] = y.reshape(S, heads, hd)
        q = rope(proj["q"], d["rope_theta"])
        k = rope(proj["k"], d["rope_theta"])
        o = causal_attention(q, k, proj["v"]).reshape(S, H * hd)
        x = x + self._lin(o, w["wo"])
        h2 = rmsnorm(x, norms[1], d["norm_eps"])
        up = F.silu(self._lin(h2, w["w_gate"])) * self._lin(h2, w["w_up"])
        return x + self._lin(up, w["w_down"])

    def _ssm_layer(self, x, s: Seq, li: int, w, ln):
        d = self.dims
        S = x.shape[0]
        sd = d["ssm"]
        N, P, G = sd["state_dim"], sd["head_dim"], sd["ngroups"]
        di, ch, nh = d["d_inner"], d["conv_ch"], d["ssm_heads"]
        h = rmsnorm(x, ln, d["norm_eps"])
        z = self._lin(h, w["in_z"])
        xbc = self._lin(h, w["in_xbc"])
        dt = self._lin(h, w["in_dt"])
        delta = self._adapted(h, s, li, "in")
        if delta is not None:
            z = z + delta[:, :di]
            xbc = xbc + delta[:, di:di + ch]
            dt = dt + delta[:, di + ch:di + ch + nh]
        W = w["conv_w"].shape[0]
        full = torch.cat([torch.zeros((W - 1, ch), device=x.device), xbc])
        conv = sum(full[j:j + S] * w["conv_w"][j] for j in range(W))
        conv = F.silu(conv + w["conv_b"])
        xs = conv[:, :di].reshape(S, nh, P)
        Bm = conv[:, di:di + G * N].reshape(S, G, N) \
            .repeat_interleave(nh // G, dim=1)
        Cm = conv[:, di + G * N:].reshape(S, G, N) \
            .repeat_interleave(nh // G, dim=1)
        dt = F.softplus(dt + w["dt_bias"])
        y = ssd_scan(xs, Bm, Cm, dt, -torch.exp(w["A_log"]))
        y = (y + w["D"][:, None] * xs).reshape(S, di) * F.silu(z)
        y = rmsnorm(y, w["norm_w"], d["norm_eps"])
        return x + self._lin(y, w["out_proj"])
