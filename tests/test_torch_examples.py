"""The port's examples (``repro_torch.examples``) run on the CPU to
their own asserts and print what the reference's examples print:
quickstart's aLoRA evaluation reuses the base request's blocks (and a
vanilla-LoRA adapter would reuse none), serve_multiturn's aLoRA evals
reuse blocks where LoRA's do not, async_poisson serves every Poisson
pipeline; without a card the default device raises."""
import pytest
import torch

from repro_torch.examples import async_poisson, quickstart, serve_multiturn

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)


def test_quickstart(capsys):
    req = quickstart.main(device="cpu")
    assert req.n_cache_hit_tokens > 0
    out = capsys.readouterr().out
    assert "base answered 24 tokens" in out and "cache reuse: " in out


def test_serve_multiturn(capsys):
    res = serve_multiturn.main(device="cpu", argv=["--batch", "2",
                                                   "--prompt-len", "48"])
    for kind, (eng, r) in res.items():
        hit = r.stage_metrics(eng, "eval").means["cache_hit_frac"]
        assert (hit > 0) == (kind == "alora"), (kind, hit)
    assert "adapter-evaluation speedup" in capsys.readouterr().out


def test_async_poisson(capsys):
    res = async_poisson.main(device="cpu", argv=["--requests", "4"])
    for kind, (eng, r) in res.items():
        assert len(r.eval_ids) == 4 and eng.idle
        hit = r.stage_metrics(eng, "eval").means["cache_hit_frac"]
        assert (hit > 0) == (kind == "alora"), (kind, hit)
    assert "alora λ=8.0: eval" in capsys.readouterr().out


@pytest.mark.parametrize("example", [quickstart, serve_multiturn,
                                     async_poisson])
def test_examples_default_to_the_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main()
