"""The port's sequential execution mode (one device call per decode batch
and per prefill chunk) against the reference's sequential engine and
against the port's own mixed engine, on the reduced granite, mamba2,
zamba2 and whisper with converted weights (float32), through the base →
aLoRA pipeline (whisper's requests on audio frames salted by their
digest, and a last request with the first base request's prompt on
another audio).

Against the reference: identical tokens, ``n_cache_hit_tokens`` and
``state_reused`` per request, KV and state-snapshot hits, misses and
evictions, preemptions, and the calls of each step function.  Against
the mixed engine: identical tokens, hits and ``state_reused``.  On the
CPU the fused aLoRA projection, decode attention and the grouped delta
run their plain versions; on a card the same calls launch the kernels
(``chip_smoke.py``)."""
import functools
import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import AdapterSpec as JSpec
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.models import init_params as jax_init
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import Engine, EngineConfig

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

INV = (7, 8, 9)
INV2 = (8, 9, 10)
ARCHS = ["granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3"]


def traffic(eng):
    """Two base requests (prompts of 40, 6 tokens each), an aLoRA eval on
    each (x + y + invocation, 4 tokens), then for an encoder-decoder
    request 0's prompt again on a third audio.  Returns the ids."""
    cfg = eng.cfg
    rng = np.random.RandomState(3)
    extra = [{} for _ in range(3)]
    if cfg.is_encoder_decoder:
        for i, e in enumerate(extra):
            fr = (np.random.RandomState(10 + i).randn(
                cfg.encoder_seq_len, cfg.d_model) * 0.02).astype(np.float32)
            e.update(frame_embeds=fr,
                     salt=(hashlib.sha256(fr.tobytes()).hexdigest(),))
    xs = [list(rng.randint(10, cfg.vocab_size, 40)) for _ in range(2)]
    base = [eng.submit(x, 6, **e) for x, e in zip(xs, extra)]
    eng.run_until_idle()
    evals = [eng.submit(x + eng.request(b).output_tokens + list(INV), 4,
                        adapter_name="uq", **e)
             for x, b, e in zip(xs, base, extra)]
    eng.run_until_idle()
    if not cfg.is_encoder_decoder:
        return base + evals
    last = eng.submit(xs[0], 6, **extra[2])
    eng.run_until_idle()
    return base + evals + [last]


def summary(eng, ids):
    mgrs = {"kv": eng.kv_mgr, "state": eng.st_mgr}
    return dict(
        tokens=[eng.request(i).output_tokens for i in ids],
        hits=[eng.request(i).n_cache_hit_tokens for i in ids],
        state_reused=[eng.request(i).state_reused for i in ids],
        pools={k: None if m is None else (m.hits, m.misses, m.evictions)
               for k, m in mgrs.items()},
        preemptions=eng.preemptions,
        calls={k: eng.runner.call_counts[k] for k in
               ("prefill_chunk", "decode_batch", "mixed_step", "encode")},
        leaked=[k for k, m in mgrs.items() if m is not None and (
            m.num_free() != m.num_blocks or any(b.ref for b in m.meta))])


@functools.lru_cache(maxsize=None)
def converted(arch):
    """(cfg_j, cfg, reference weights, port weights, adapters): rank-8
    aLoRA adapters "uq" (key 7) and "uq2" (key 8) in both packages."""
    cfg_j, cfg = jax_reduced(arch), get_reduced(arch)
    # jitted: the same weights for both packages, drawn faster than eagerly
    pj = jax.jit(functools.partial(jax_init, cfg=cfg_j))(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu")
    ads = []
    for name, key, inv in (("uq", 7, INV), ("uq2", 8, INV2)):
        aj = jax_adapter(jax.random.key(key), cfg_j, 8)
        ads.append(((JSpec(name, 8, inv), aj), (AdapterSpec(name, 8, inv),
                    adapters_from_jax(jax.tree.map(np.asarray, aj), cfg,
                                      "cpu"))))
    return cfg_j, cfg, pj, params, ads


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """The reference's sequential engine, the port's sequential engine and
    the port's mixed engine on the same converted weights and rank-8
    aLoRA adapter "uq"."""
    cfg_j, cfg, pj, params, ads = converted(request.param)
    (jspec, aj), (spec, at) = ads[0]
    out = {}
    jeng = JEngine(cfg_j, pj, adapters=[(jspec, aj)],
                   engine_cfg=JEngineConfig(execution_mode="sequential"))
    out["reference"] = summary(jeng, traffic(jeng))
    for mode in ("sequential", "mixed"):
        eng = Engine(cfg, params, device="cpu", adapters=[(spec, at)],
                     engine_cfg=EngineConfig(execution_mode=mode))
        out[mode] = summary(eng, traffic(eng))
    return cfg, out


def test_sequential_matches_reference(runs):
    _, out = runs
    assert out["sequential"] == out["reference"]


def test_sequential_matches_mixed(runs):
    _, out = runs
    seq, mixed = out["sequential"], out["mixed"]
    for k in ("tokens", "hits", "state_reused"):
        assert seq[k] == mixed[k], k
    assert seq["calls"]["mixed_step"] == 0
    assert mixed["calls"]["prefill_chunk"] == \
        mixed["calls"]["decode_batch"] == 0


def test_sequential_reuses_and_drains(runs):
    """Each eval reuses its base request's whole blocks (and on SSM
    stacks restores the state snapshot there); on another audio the
    repeated prompt reuses nothing; every block and state slot comes
    back, and each admission encodes once."""
    cfg, out = runs
    seq = out["sequential"]
    assert seq["hits"][2:] == ([32, 32, 0] if cfg.is_encoder_decoder
                               else [32, 32])
    if cfg.ssm is not None:
        assert all(seq["state_reused"][2:4])
    assert seq["leaked"] == []
    assert seq["calls"]["encode"] == (
        len(seq["tokens"]) + seq["preemptions"] if cfg.is_encoder_decoder
        else 0)


# block pressure: 8 blocks of 16 for three 64-token prompts, two running
PRESSURE = dict(num_blocks=8, max_running=2, num_state_slots=6,
                adapter_slots=1)


def pressure_traffic(eng):
    """Three 64-token requests, the first on the base model and the
    others on aLoRA adapters "uq" and "uq2" sharing one adapter slot
    (each with its invocation tokens), whisper's on their own audio."""
    cfg = eng.cfg
    rng = np.random.RandomState(5)
    rids = []
    for i, name in enumerate((None, "uq", "uq2")):
        kw = {}
        if cfg.is_encoder_decoder:
            fr = (np.random.RandomState(20 + i).randn(
                cfg.encoder_seq_len, cfg.d_model) * 0.02).astype(np.float32)
            kw = dict(frame_embeds=fr, salt=(i,))
        inv = [] if name is None else list(INV if name == "uq" else INV2)
        prompt = list(rng.randint(10, cfg.vocab_size, 64 - len(inv))) + inv
        rids.append(eng.submit(prompt, 4, adapter_name=name, **kw))
    eng.run_until_idle()
    return rids


@pytest.mark.parametrize("arch", ["granite-3.2-8b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_sequential_under_block_pressure_and_churn(arch):
    """The reference's ``test_mixed_equals_sequential_preemption_archs``
    with the two adapters cycling through one slot: the port's
    sequential engine equals the reference's (tokens, hits, pools,
    preemptions, call counts) and the port's mixed engine (tokens),
    preempts on the block-bearing stacks, evicts the adapter slot, and
    leaks no block, state slot, run slot or adapter pin."""
    cfg_j, cfg, pj, params, ads = converted(arch)
    jeng = JEngine(cfg_j, pj, adapters=[a for a, _ in ads],
                   engine_cfg=JEngineConfig(execution_mode="sequential",
                                            **PRESSURE))
    want = summary(jeng, pressure_traffic(jeng))
    got = {}
    for mode in ("sequential", "mixed"):
        eng = Engine(cfg, params, device="cpu", adapters=[p for _, p in ads],
                     engine_cfg=EngineConfig(execution_mode=mode,
                                             **PRESSURE))
        got[mode] = summary(eng, pressure_traffic(eng))
        assert got[mode]["leaked"] == []
        assert sorted(eng._free_slots) == list(range(PRESSURE[
            "max_running"]))
        assert eng.adapter_pool.pinned_slots() == 0
        assert eng.adapter_pool_stats().evictions > 0
    assert got["sequential"] == want
    assert got["mixed"]["tokens"] == want["tokens"]
    assert got["mixed"]["preemptions"] == want["preemptions"]
    assert all(len(t) == 4 for t in want["tokens"])
    if eng.runner.La:                # block-bearing stacks must starve
        assert want["preemptions"] > 0
