"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at the reduced size, with each fault a serving cell can have
planted in the program's mixed step: a served token altered where it is
sampled; a step that leaves its state unchanged (the K/V pools, or the
live SSM states); attention over half of each row's context; the aLoRA
delta left out."""
from __future__ import annotations

import pytest
import torch

from alora_bench import harness, reduced, spec

# the reduced granite at a width where attention, not the token's own
# embedding, decides the logits (at d_model 256 the tied embedding
# dominates them and a broken attention path changes no argmax)
WIDE = spec.deep_merge(reduced.OVERRIDES, {"config": {"reduced_model": {
    "d_model": 1024, "num_heads": 8, "num_kv_heads": 2, "head_dim": 128,
    "d_ff": 2048}}})


def alter_tokens(orig):
    def step(self, *a, **k):
        sampled, boundary = orig(self, *a, **k)
        sampled = sampled.clone()
        sampled[::2] = (sampled[::2] + 1) % self.cfg.vocab_size
        return sampled, boundary
    return step


def keep_state(*names):
    def wrap(orig):
        def step(self, *a, **k):
            saved = [getattr(self, n).clone() for n in names]
            out = orig(self, *a, **k)
            for n, t in zip(names, saved):
                getattr(self, n).copy_(t)
            return out
        return step
    return wrap


def half_context(orig):
    def step(self, *a, **k):
        a = list(a)
        a[5] = (a[5] + 1) // 2            # qln: each row's causal length
        return orig(self, *a, **k)
    return step


def no_adapter(orig):
    def step(self, *a, **k):
        a = list(a)
        a[6] = torch.zeros_like(a[6])     # ad: each token's adapter slot
        return orig(self, *a, **k)
    return step


@pytest.fixture(scope="module")
def ssm_root(tmp_path_factory):
    return reduced.with_ssm_cell(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAULTS = {
    "token_altered": ("granite-rag-alora", alter_tokens),
    "kv_state_unchanged": ("granite-rag-alora",
                           keep_state("k_pool", "v_pool")),
    "ssm_state_unchanged": (reduced.SSM_CELL,
                            keep_state("live_ssm", "live_conv")),
    "half_context": ("granite-rag-alora", half_context),
    "adapter_left_out": (reduced.SSM_CELL, no_adapter),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(fault, monkeypatch, ssm_root):
    from repro_torch.serving.runner import ModelRunner
    cell, wrap = FAULTS[fault]
    monkeypatch.setattr(ModelRunner, "_mixed_impl",
                        wrap(ModelRunner._mixed_impl))
    ssm = cell == reduced.SSM_CELL
    result, _ = harness.run(
        cell, 13579, 1.0, False, device="cpu", reduced=True,
        root=ssm_root if ssm else spec.ROOT,
        overrides=reduced.OVERRIDES if ssm else WIDE)
    assert result["correct"] is False, result["readings"]
