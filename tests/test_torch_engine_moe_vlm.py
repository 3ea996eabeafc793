"""The port's engine against ``repro.serving.Engine`` on the reduced
mixture-of-experts models (granite-moe, phi3.5-moe: the paper's base →
aLoRA pipeline) and the reduced phi-3-vision with a 16-patch image
prefix, on converted weights (float32).  Identical output tokens for
every request, equal per-request ``n_cache_hit_tokens``, KV hits,
misses and evictions and mixed-step counts, and no block leaked after
the drain.  The vision run reuses an image's blocks only for the same
image: a second image under the same pseudo-tokens reuses nothing."""
import hashlib

import jax
import jax.numpy as jnp
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
from repro_torch.models.model import init_params
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import Engine
from repro_torch.serving import pipelines as P

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

INV = (7, 8, 9)
PIPE = dict(prompt_len=40, gen_len=6, eval_len=4, batch=2)
VLM = "phi-3-vision-4.2b"


def _engines(arch):
    """The reference engine and the port's on the same converted weights
    and rank-8 aLoRA adapter "uq"."""
    cfg_j, cfg = jax_reduced(arch), get_reduced(arch)
    pj = jax_init(jax.random.key(0), cfg_j)
    aj = jax_adapter(jax.random.key(7), cfg_j, 8)
    jeng = JEngine(cfg_j, pj, adapters=[(JSpec("uq", 8, INV), aj)])
    eng = Engine(cfg, params_from_jax(jax.tree.map(np.asarray, pj), cfg,
                                      "cpu"), device="cpu",
                 adapters=[(AdapterSpec("uq", 8, INV), adapters_from_jax(
                     jax.tree.map(np.asarray, aj), cfg, "cpu"))])
    return jeng, eng


def _same_run(eng, jeng, ids):
    for rid in ids:
        got, want = eng.request(rid), jeng.request(rid)
        assert got.output_tokens == want.output_tokens, rid
        assert got.n_cache_hit_tokens == want.n_cache_hit_tokens, rid
    assert eng.kv_mgr.hits == jeng.kv_mgr.hits > 0
    assert eng.kv_mgr.misses == jeng.kv_mgr.misses
    assert eng.kv_mgr.evictions == jeng.kv_mgr.evictions
    assert eng.runner.call_counts["mixed_step"] == \
        jeng.runner.call_counts["mixed_step"]
    assert sum(m.ref for m in eng.kv_mgr.meta) == 0
    assert eng.kv_mgr.num_free() == eng.kv_mgr.num_blocks


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_engine_matches_reference(arch):
    jeng, eng = _engines(arch)
    jres = JP.base_adapter(jeng, adapter_names=["uq"], **PIPE)
    res = P.base_adapter(eng, adapter_names=["uq"], **PIPE)
    ids = res.base_ids + res.eval_ids
    assert ids == jres.base_ids + jres.eval_ids
    _same_run(eng, jeng, ids)
    bs = eng.ecfg.block_size
    assert min(eng.request(r).n_cache_hit_tokens for r in res.eval_ids) \
        >= PIPE["prompt_len"] // bs * bs


def image(seed, cfg):
    """(num_patches, d) float32 patch embeddings and their digest."""
    pe = (np.random.RandomState(seed).randn(cfg.num_patches, cfg.d_model)
          * 0.02).astype(np.float32)
    return pe, (hashlib.sha256(pe.tobytes()).hexdigest(),)


def vision_traffic(eng, cfg):
    """Two base requests, each on its own image (16 pseudo-tokens, then
    24 text tokens); an aLoRA eval on each (x + y + invocation, same
    image); a base request with request 0's tokens under a third image;
    and a prompt of 10 pseudo-tokens, shorter than its 16 patches.
    Returns (base ids, eval ids, other-image id, short id)."""
    rng = np.random.RandomState(3)
    pseudo = [1] * cfg.num_patches
    imgs = [image(s, cfg) for s in (10, 11, 12)]
    prompts = [pseudo + list(rng.randint(10, cfg.vocab_size, 24))
               for _ in range(2)]
    base = [eng.submit(x, 6, prefix_embeds=pe, salt=salt)
            for x, (pe, salt) in zip(prompts, imgs)]
    eng.run_until_idle()
    evals = [eng.submit(x + eng.request(b).output_tokens + list(INV), 4,
                        adapter_name="uq", prefix_embeds=pe, salt=salt)
             for x, b, (pe, salt) in zip(prompts, base, imgs)]
    eng.run_until_idle()
    other = eng.submit(prompts[0], 6, prefix_embeds=imgs[2][0],
                       salt=imgs[2][1])
    short = eng.submit(pseudo[:10], 4, prefix_embeds=imgs[0][0],
                       salt=imgs[0][1])
    eng.run_until_idle()
    return base, evals, other, short


def test_vision_engine_matches_reference():
    jeng, eng = _engines(VLM)
    cfg = eng.cfg
    jids = vision_traffic(jeng, jeng.cfg)
    base, evals, other, short = vision_traffic(eng, cfg)
    assert (base, evals, other, short) == jids
    _same_run(eng, jeng, base + evals + [other, short])
    bs = eng.ecfg.block_size
    # the eval reuses every whole block of its base request's x + y
    for b, e in zip(base, evals):
        n = len(eng.request(b).prompt) + len(eng.request(b).output_tokens)
        assert eng.request(e).n_cache_hit_tokens == (n - 1) // bs * bs
    # another image under the same pseudo-tokens reuses none of them
    assert eng.request(other).n_cache_hit_tokens == 0
    assert eng.request(other).output_tokens != \
        eng.request(base[0]).output_tokens
    assert len(eng.request(short).output_tokens) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_prompt", [40, 10], ids=["longer", "shorter"])
def test_build_input_embeds_places_the_patches(dtype, n_prompt):
    """The patch rows replace the leading rows of the host embeddings,
    rounded to the model dtype as the reference's ``pe.astype``; a prompt
    shorter than the patches gets the patch rows alone."""
    cfg = get_reduced(VLM).replace(dtype=dtype)
    eng = Engine(cfg, init_params(torch.Generator().manual_seed(0), cfg,
                                  device="cpu"), device="cpu")
    pe, _ = image(4, cfg)
    prompt = list(range(20, 20 + n_prompt))
    emb = eng.runner.build_input_embeds(prompt, pe)
    want_pe = np.asarray(jnp.asarray(pe).astype(getattr(jnp, dtype))
                         .astype(jnp.float32))
    assert emb.dtype == np.float32
    n_pe = cfg.num_patches
    if n_prompt >= n_pe:
        assert emb.shape == (n_prompt, cfg.d_model)
        tok = eng.runner.params["embed"]["tok"]
        np.testing.assert_array_equal(emb[n_pe:],
                                      tok[prompt[n_pe:]].float().numpy())
    else:
        assert emb.shape == (n_pe, cfg.d_model)
    np.testing.assert_array_equal(emb[:n_pe], want_pe)
    if dtype == "bfloat16":
        assert not np.array_equal(emb[:n_pe], pe)
    np.testing.assert_array_equal(eng.runner.build_input_embeds(prompt),
                                  eng.runner.build_input_embeds(
                                      prompt, None))
