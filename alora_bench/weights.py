"""The model's weights and adapters, drawn by the harness on the device
from the seed, in the type they are served in and in a few large calls:
one flat buffer per standard deviation class, filled in slices of 2**30
elements, of which every weight matrix is a view.  The same tensors go
to the program (in its parameter layout) and to the reference (layer by
layer), which upcasts them itself."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

FILL_CHUNK = 1 << 30
PAD_VOCAB = 512          # the port's embedding rows, rounded up


def dims_of(cfg) -> Dict[str, Any]:
    """Plain numbers of a ``repro_torch`` ``ModelConfig``: what the
    reference, the yardstick and the generators are given."""
    kinds = ["ssm" if k == "ssm" else "attn" for k in cfg.pattern()]
    d = {"d_model": cfg.d_model, "num_heads": cfg.num_heads,
         "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
         "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
         "padded_vocab": -(-cfg.vocab_size // PAD_VOCAB) * PAD_VOCAB,
         "activation": cfg.activation, "norm_eps": cfg.norm_eps,
         "rope_theta": cfg.rope_theta, "tie_embeddings": cfg.tie_embeddings,
         "dtype": cfg.dtype, "kinds": kinds, "num_layers": len(kinds)}
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        d["ssm"] = {"state_dim": s.state_dim, "head_dim": s.head_dim,
                    "expand": s.expand, "conv_width": s.conv_width,
                    "ngroups": s.ngroups}
        d["d_inner"] = d_inner
        d["ssm_heads"] = d_inner // s.head_dim
        d["conv_ch"] = d_inner + 2 * s.ngroups * s.state_dim
    return d


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class _Flat:
    """Shapes laid out back to back in one buffer, by class of standard
    deviation, drawn from N(0, 1) and scaled per class."""

    def __init__(self):
        self.items: List[Tuple[Tuple[int, ...], float]] = []

    def add(self, shape: Sequence[int], std: float) -> int:
        self.items.append((tuple(shape), std))
        return len(self.items) - 1

    def draw(self, gen: torch.Generator, dtype, device) -> List[torch.Tensor]:
        order = sorted(range(len(self.items)), key=lambda i: self.items[i][1])
        sizes = [math.prod(self.items[i][0]) for i in order]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        for lo in range(0, buf.numel(), FILL_CHUNK):
            buf[lo:lo + FILL_CHUNK].normal_(generator=gen)
        out: List[Optional[torch.Tensor]] = [None] * len(self.items)
        off, run_lo, run_std = 0, 0, None
        for i, n in zip(order, sizes):
            std = self.items[i][1]
            if std != run_std:
                if run_std is not None:
                    buf[run_lo:off].mul_(run_std)
                run_lo, run_std = off, std
            out[i] = buf[off:off + n].view(self.items[i][0])
            off += n
        if run_std is not None:
            buf[run_lo:off].mul_(run_std)
        return out


def draw(dims: Dict[str, Any], adapters: Dict[str, Any], seed: int,
         device: torch.device, segments: Tuple[int, List[Tuple[str, int]]]
         ) -> Dict[str, Any]:
    """Weights and adapters for ``dims`` from ``seed``.

    ``segments``: the program's ``period_segments`` of the layer pattern,
    (repeats, [(kind, count), ...]), the layout of its adapter trees.
    Returns {"params": the program's parameter tree, "adapters": [(name,
    invocation ids, segment-stacked weights)], "layers": per layer the
    reference's view of each adapter ([{"q": (A, B), ...}] or [{"in":
    (A, B)}])}."""
    dtype = _dtype(dims["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    d, H, KV, hd = (dims["d_model"], dims["num_heads"], dims["num_kv_heads"],
                    dims["head_dim"])
    L, V, Vp = dims["num_layers"], dims["vocab_size"], dims["padded_vocab"]
    std, out_std = 0.02, 0.02 / math.sqrt(2 * L)
    flat = _Flat()
    emb = flat.add((Vp, d), std)
    unemb = None if dims["tie_embeddings"] else flat.add((d, Vp), std)
    plan = []
    for kind in dims["kinds"]:
        if kind == "attn":
            plan.append({
                "wq": flat.add((d, H * hd), std),
                "wk": flat.add((d, KV * hd), std),
                "wv": flat.add((d, KV * hd), std),
                "wo": flat.add((H * hd, d), out_std),
                "w_gate": flat.add((d, dims["d_ff"]), std),
                "w_up": flat.add((d, dims["d_ff"]), std),
                "w_down": flat.add((dims["d_ff"], d), out_std)})
        else:
            s = dims["ssm"]
            plan.append({
                "in_z": flat.add((d, dims["d_inner"]), std),
                "in_xbc": flat.add((d, dims["conv_ch"]), std),
                "in_dt": flat.add((d, dims["ssm_heads"]), std),
                "conv_w": flat.add((s["conv_width"], dims["conv_ch"]), std),
                "out_proj": flat.add((dims["d_inner"], d), out_std)})
    # adapters: (adapter, layer, leaf) -> A or B
    n_ad, r = adapters["count"], adapters["rank"]
    b_std = float(adapters["b_std"])
    ad_plan: List[List[Dict[str, int]]] = []
    for _ in range(n_ad):
        per = []
        for kind in dims["kinds"]:
            if kind == "attn":
                per.append({"aq": flat.add((d, r), 1 / math.sqrt(d)),
                            "bq": flat.add((r, H * hd), b_std),
                            "ak": flat.add((d, r), 1 / math.sqrt(d)),
                            "bk": flat.add((r, KV * hd), b_std),
                            "av": flat.add((d, r), 1 / math.sqrt(d)),
                            "bv": flat.add((r, KV * hd), b_std)})
            else:
                width = dims["d_inner"] + dims["conv_ch"] + dims["ssm_heads"]
                per.append({"a": flat.add((d, r), 1 / math.sqrt(d)),
                            "b": flat.add((r, width), b_std)})
        ad_plan.append(per)
    t = flat.draw(gen, dtype, device)

    def ones(n, dt=dtype):
        return torch.ones((n,), dtype=dt, device=device)

    t[emb][V:].zero_()
    embed = {"tok": t[emb]}
    if unemb is not None:
        t[unemb][:, V:].zero_()
        embed["unembed"] = t[unemb]
    layers = []
    n_ssm = dims["kinds"].count("ssm")
    dt_bias = None
    if n_ssm:
        nh = dims["ssm_heads"]
        u = torch.rand((n_ssm, nh), generator=gen, dtype=torch.float32,
                       device=device)
        dtv = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
        dt_bias = dtv + torch.log(-torch.expm1(-dtv))
    si = 0
    for kind, p in zip(dims["kinds"], plan):
        if kind == "attn":
            layers.append({
                "ln1": ones(d),
                "attn": {k: t[p[k]] for k in ("wq", "wk", "wv", "wo")},
                "ln2": ones(d),
                "mlp": {k: t[p[k]] for k in ("w_gate", "w_up", "w_down")}})
        else:
            nh = dims["ssm_heads"]
            ssm = {k: t[p[k]] for k in ("in_z", "in_xbc", "in_dt", "conv_w",
                                         "out_proj")}
            ssm["conv_b"] = torch.zeros((dims["conv_ch"],), dtype=dtype,
                                        device=device)
            ssm["A_log"] = torch.log(torch.arange(1, nh + 1,
                                                  dtype=torch.float32,
                                                  device=device))
            ssm["dt_bias"] = dt_bias[si].contiguous()
            ssm["D"] = ones(nh, torch.float32)
            ssm["norm_w"] = ones(dims["d_inner"])
            layers.append({"ln": ones(d), "ssm": ssm})
            si += 1
    params = {"embed": embed, "final_norm": ones(d), "layers": layers}

    # the program's segment-stacked adapter trees, and the reference's
    # per-layer views of the same tensors
    repeats, segs = segments
    period = sum(c for _, c in segs)
    ref_layers: List[List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]] = \
        [[] for _ in dims["kinds"]]
    trees = []
    for a, per in enumerate(ad_plan):
        tree = {}
        off = 0
        for s_i, (_, count) in enumerate(segs):
            keys = per[off].keys()
            tree[f"seg{s_i}"] = {
                k: torch.stack([torch.stack([t[per[rep * period + off + c][k]]
                                             for c in range(count)])
                                for rep in range(repeats)])
                for k in keys}
            off += count
        trees.append(tree)
        for li, leaves in enumerate(per):
            if dims["kinds"][li] == "attn":
                ref_layers[li].append({n: (t[leaves["a" + n]],
                                           t[leaves["b" + n]])
                                       for n in "qkv"})
            else:
                ref_layers[li].append({"in": (t[leaves["a"]],
                                              t[leaves["b"]])})
    inv = adapters["invocation_tokens"]
    out = []
    for a, tree in enumerate(trees):
        ids = tuple(V - 1 - (inv * a + j) for j in range(inv))
        out.append((f"alora{a}", ids, tree))
    return {"params": params, "adapters": out, "layers": ref_layers}
