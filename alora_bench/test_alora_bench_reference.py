"""The plain reference against the port's CPU path on the reduced
granite and zamba2 (float32; zamba2 as the tests' own cell, see
``reduced.with_ssm_cell``): the port's full-sequence model with an
aLoRA adapter active on part of the sequence gives the reference's
logits within float32 rounding, and the engine path (the harness's own
run, with an aLoRA request that reused a base request's blocks and, on
zamba2, restored its state snapshot) serves tokens the reference puts
first.  The control, computed one precision below (bfloat16 here), is
told apart by the same limit: put in the program's place, it makes the
run not correct."""
from __future__ import annotations

import pytest
import torch

from alora_bench import harness, reduced, spec
from alora_bench.reference import Reference, Seq


@pytest.fixture(scope="module")
def ssm_root(tmp_path_factory):
    return reduced.with_ssm_cell(tmp_path_factory.mktemp("bench"))


def root_of(cell, ssm_root):
    return ssm_root if cell == reduced.SSM_CELL else spec.ROOT


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["granite-rag-alora", "zamba2-rag-alora"])
def test_reference_equals_the_port_full_sequence_model(cell, ssm_root):
    from repro_torch.core.alora import stack_adapters
    from repro_torch.models.model import forward_full, logits_for
    sp, cfg, dims, w = harness.prepare(cell, 7, "cpu",
                                       root=root_of(cell, ssm_root),
                                       overrides=reduced.OVERRIDES,
                                       reduced=True)
    S, inv = 90, 55
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, dims["vocab_size"] - 8, (S,), generator=g)
    name, ids, tree = w["adapters"][1]
    stacked = stack_adapters(cfg, [tree], sp.config["adapters"]["rank"],
                             device="cpu")
    idx = (torch.arange(S) >= inv).to(torch.int32)
    with torch.no_grad():
        hidden, _, _ = forward_full(w["params"], cfg, tokens[None],
                                    adapters=stacked, adapter_idx=idx[None])
        port = logits_for(w["params"], cfg, hidden[0])
    ref = Reference(dims, w["params"], w["layers"], "cpu").logits(
        [Seq(tokens.tolist(), 1, inv, list(range(S)))])[0]
    scale = ref.abs().max()
    assert (port - ref).abs().max() <= 1e-5 * scale
    # the adapter moves the logits after its activation, not before
    base = Reference(dims, w["params"], w["layers"], "cpu").logits(
        [Seq(tokens.tolist(), None, S, list(range(S)))])[0]
    assert torch.equal(base[:inv], ref[:inv])
    assert (base[inv:] - ref[inv:]).abs().max() > 1e-3 * scale


@pytest.mark.parametrize("cell", ["granite-rag-alora", "zamba2-rag-alora"])
def test_served_tokens_with_reuse_agree_with_the_reference(cell, ssm_root):
    result, _ = harness.run(cell, 24680, 1.5, False, device="cpu",
                            root=root_of(cell, ssm_root),
                            overrides=reduced.OVERRIDES, reduced=True)
    r = result["readings"]
    assert r["tokens"] >= 40 and r["adapted"] >= 1
    assert r["reused_tokens"] > 0
    if cell.startswith("zamba2"):
        assert r["restored"] >= 1
    assert r["max_logit_gap"] <= reduced.F32_GAP_LIMIT
    assert result["correct"] is True


def test_the_control_fails_the_limit_at_test_size(ssm_root):
    """zamba2 reduced: the reference in bfloat16, judged in the
    program's place, puts first tokens that the float32 reference ranks
    below its best by more than the limit, so the run is not correct,
    on two seeds, while the program's served tokens stay within it.
    (The reduced granite's logits are too peaked for rounding to move
    any argmax; its control is read on the card, at full size.)"""
    ov = spec.deep_merge(reduced.OVERRIDES, {"mix": {
        "base_output": [16, 32], "final_output": [16, 24]}})
    for seed in (1, 2):
        result, _ = harness.run(reduced.SSM_CELL, seed, 1.5, False,
                                device="cpu", root=ssm_root, overrides=ov,
                                reduced=True, control=True)
        r = result["readings"]
        assert r["served_logit_gap"] <= reduced.F32_GAP_LIMIT \
            < r["max_logit_gap"], r
        assert result["checks"]["max_logit_gap"]["value"] \
            == r["max_logit_gap"]
        assert result["correct"] is False
