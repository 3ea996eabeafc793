"""The port's engine against ``repro.serving.Engine`` on the four reduced
dense families with converted weights, through the paper's base →
aLoRA pipeline: stablelm (swiglu, untied embeddings), minitron and
nemotron (squared ReLU, G = 3) and starcoder2 (tanh GELU, a 128-token
sliding window, served with prompts longer than the window so that the
mask cuts keys).  Identical output tokens for every request, equal
per-request ``n_cache_hit_tokens``, KV hits, misses and evictions and
mixed-step counts, and no block leaked after the drain."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import AdapterSpec as JSpec
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.models import init_params as jax_init
from repro.serving import Engine as JEngine
from repro.serving import pipelines as JP
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import Engine
from repro_torch.serving import pipelines as P

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

INV = (7, 8, 9)
# arch -> pipeline; starcoder2's prompts (150 + 6 + 3 tokens at the eval)
# pass its 128-token window
CASES = {
    "stablelm-12b": dict(prompt_len=40, gen_len=6, eval_len=4, batch=2),
    "minitron-4b": dict(prompt_len=40, gen_len=6, eval_len=4, batch=2),
    "nemotron-4-15b": dict(prompt_len=40, gen_len=6, eval_len=4, batch=2),
    "starcoder2-3b": dict(prompt_len=150, gen_len=6, eval_len=4, batch=2),
}


@pytest.mark.parametrize("arch", list(CASES))
def test_dense_engine_matches_reference(arch):
    pipe = CASES[arch]
    cfg_j, cfg = jax_reduced(arch), get_reduced(arch)
    if arch == "starcoder2-3b":
        assert 0 < cfg.sliding_window < pipe["prompt_len"]
    pj = jax_init(jax.random.key(0), cfg_j)
    aj = jax_adapter(jax.random.key(7), cfg_j, 8)
    jeng = JEngine(cfg_j, pj, adapters=[(JSpec("uq", 8, INV), aj)])
    jres = JP.base_adapter(jeng, adapter_names=["uq"], **pipe)
    eng = Engine(cfg, params_from_jax(jax.tree.map(np.asarray, pj), cfg,
                                      "cpu"), device="cpu",
                 adapters=[(AdapterSpec("uq", 8, INV), adapters_from_jax(
                     jax.tree.map(np.asarray, aj), cfg, "cpu"))])
    assert eng.runner.window == cfg.sliding_window
    res = P.base_adapter(eng, adapter_names=["uq"], **pipe)
    ids = res.base_ids + res.eval_ids
    assert ids == jres.base_ids + jres.eval_ids
    for rid in ids:
        got, want = eng.request(rid), jeng.request(rid)
        assert got.output_tokens == want.output_tokens, rid
        assert got.n_cache_hit_tokens == want.n_cache_hit_tokens, rid
    # every eval request reused at least its prompt's whole blocks
    bs = eng.ecfg.block_size
    assert min(eng.request(r).n_cache_hit_tokens for r in res.eval_ids) \
        >= pipe["prompt_len"] // bs * bs
    assert eng.kv_mgr.hits == jeng.kv_mgr.hits > 0
    assert eng.kv_mgr.misses == jeng.kv_mgr.misses
    assert eng.kv_mgr.evictions == jeng.kv_mgr.evictions
    assert eng.runner.call_counts["mixed_step"] == \
        jeng.runner.call_counts["mixed_step"]
    assert sum(m.ref for m in eng.kv_mgr.meta) == 0
    assert eng.kv_mgr.num_free() == eng.kv_mgr.num_blocks
