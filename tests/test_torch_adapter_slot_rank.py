"""The adapter pool's slot rank on the card and on the CPU.

On a CUDA device the grouped-LoRA kernel takes only the rank buckets of
``ragged_lora.RANKS``: ``slot_rank_for`` rounds a requested slot rank up
to the next bucket and raises above the largest, so an engine on the
card never builds a pool its kernel cannot run.  On the CPU the rank is
kept as given, as the reference's pool keeps it."""
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels.ragged_lora import RANKS
from repro_torch.serving.adapter_pool import AdapterPool, slot_rank_for


@pytest.mark.parametrize("rank,want", [(1, 8), (8, 8), (9, 16), (48, 64),
                                       (256, 256)])
@pytest.mark.parametrize("device", ["cuda", torch.device("cuda", 0)])
def test_card_slot_rank_rounds_up_to_a_bucket(rank, want, device):
    assert slot_rank_for(rank, device) == want
    assert want in RANKS


@pytest.mark.parametrize("rank", [257, 300])
def test_card_slot_rank_above_the_largest_bucket_raises(rank):
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64, 128, 256\)"):
        slot_rank_for(rank, "cuda")


@pytest.mark.parametrize("rank", [1, 8, 9, 48, 256, 257, 300])
def test_cpu_slot_rank_is_kept(rank):
    assert slot_rank_for(rank, "cpu") == rank


def test_cpu_pool_keeps_the_requested_slot_rank():
    cfg = get_reduced("granite-3.2-8b")
    pool = AdapterPool(cfg, num_slots=2, slot_rank=48, device="cpu")
    assert pool.slot_rank == 48
    a = pool.layers[0]["aq"]
    assert a.shape[0] == 3 and a.shape[-1] == 48
