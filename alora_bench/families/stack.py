"""The ``stack`` family: the repo's decoder stacks of two layer kinds, an
attention layer of width ``d_model`` with a SwiGLU MLP and a Mamba2
layer with a full-width gated norm, in the order the port's
``ModelConfig.pattern()`` gives (granite-3.2-8b: 40 attention layers;
the tests' zamba2: Mamba2 layers with attention layers among them).  A
configuration file without a ``family`` key is of this family.  Its
reference is ``reference/stack.py``."""
from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from alora_bench import spec as S
from alora_bench import weights as W

REF = S.reference_module(Path(__file__))


def config(spec: S.CellSpec, reduced: bool):
    """The port's configuration of the cell's model, checked against
    every number of the configuration file (the reduced CPU-test
    configuration is the port's own, with the file's ``reduced_model``
    changes, unchecked)."""
    from repro_torch.configs import get_config, get_reduced
    arch = spec.config["arch"]
    if reduced:
        return get_reduced(arch).replace(
            **spec.config.get("reduced_model", {}))
    cfg = get_config(arch)
    m = spec.config["model"]
    for k, v in m.items():
        if k == "ssm":
            for sk, sv in v.items():
                if getattr(cfg.ssm, sk) != sv:
                    raise ValueError(f"{arch}: ssm.{sk} {getattr(cfg.ssm, sk)}"
                                     f" is not the file's {sv}")
        elif k == "attention_every":
            want = tuple("attn" if (i + 1) % v == 0 else "ssm"
                         for i in range(cfg.num_layers))
            if cfg.pattern() != want:
                raise ValueError(f"{arch}: layer pattern is not attention "
                                 f"every {v}th layer")
        elif getattr(cfg, k) != v:
            raise ValueError(f"{arch}: {k} {getattr(cfg, k)} is not the "
                             f"file's {v}")
    return cfg


def dims_of(cfg) -> Dict[str, Any]:
    """Plain numbers of a ``repro_torch`` ``ModelConfig``: what the
    reference, ``step_flops``, the traced run and the generators are
    given.  Beside the keys every family gives (``spec.py``), the stack's
    own: ``d_model``, ``d_ff``, ``padded_vocab``, ``activation``,
    ``norm_eps``, ``rope_theta``, ``tie_embeddings``, ``num_layers`` and,
    with Mamba2 layers, ``d_inner`` and ``conv_ch``."""
    kinds = ["ssm" if k == "ssm" else "attn" for k in cfg.pattern()]
    d = {"d_model": cfg.d_model, "num_heads": cfg.num_heads,
         "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
         "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
         "padded_vocab": -(-cfg.vocab_size // W.PAD_VOCAB) * W.PAD_VOCAB,
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
    dtype = W.torch_dtype(dims["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    d, H, KV, hd = (dims["d_model"], dims["num_heads"], dims["num_kv_heads"],
                    dims["head_dim"])
    L, V, Vp = dims["num_layers"], dims["vocab_size"], dims["padded_vocab"]
    std, out_std = 0.02, 0.02 / math.sqrt(2 * L)
    flat = W.Flat()
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


def reference(dims: Dict[str, Any], weights: Dict[str, Any],
              layers: List, device, quant=None):
    """The plain float32 reference over the drawn ``weights`` and the
    adapters' per-layer ``layers``; ``quant`` rounds every product's
    operands (the control)."""
    return REF.Reference(dims, weights, layers, device, quant)


def token_matmul_flops(m: Dict) -> Dict[str, int]:
    """FLOPs of one token through one layer's dense products, by layer
    kind, and of one adapted token's low-rank deltas; ``m`` holds the
    configuration file's model block (with ``d_inner``, ``ssm_heads``,
    ``conv_ch`` filled in for an SSM model)."""
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    gate = 3 if m["activation"] == "swiglu" else 2
    out = {"attn": 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d
           + 2 * gate * d * m["d_ff"]}
    r = m.get("adapter_rank", 0)
    out["attn_lora"] = 2 * r * (d + H * hd) + 4 * r * (d + KV * hd)
    if "ssm" in m:
        s = m["ssm"]
        in_dim = m["d_inner"] + m["conv_ch"] + m["ssm_heads"]
        out["ssm"] = 2 * d * in_dim + 2 * m["d_inner"] * d \
            + 2 * s["conv_width"] * m["conv_ch"]
        out["ssm_lora"] = 2 * r * (d + in_dim)
    return out


def step_flops(call: Dict, dims: Dict, adapter_rank: int) -> float:
    """Model FLOPs of one mixed step's computed tokens (``call``: the
    traced run's summary of its batch): every token through every
    layer's dense products, the adapted tokens' low-rank deltas,
    attention over each token's context, the SSM scan's operations and
    the logits of each request row over the published vocabulary."""
    f = token_matmul_flops(dict(dims, adapter_rank=adapter_rank))
    La, Ls = dims["kinds"].count("attn"), dims["kinds"].count("ssm")
    flops = call["T"] * (La * f["attn"] + Ls * f.get("ssm", 0)) \
        + call["adapted"] * (La * f["attn_lora"] + Ls * f.get("ssm_lora", 0))
    flops += La * 4 * dims["num_heads"] * dims["head_dim"] * call["ctx"]
    flops += Ls * call.get("ssd_ops", 0)
    flops += call["R"] * 2 * dims["d_model"] * dims["vocab_size"]
    return float(flops)
