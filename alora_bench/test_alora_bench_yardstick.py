"""The frozen yardstick equals the program's own arithmetic where the two
count the same call: B1's and B3's bytes and operations against
``repro_torch.kernels.bench`` at serving shapes, and the ragged counts
reduce to the dense ones."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from alora_bench import yardstick as Y

bench = pytest.importorskip("repro_torch.kernels.bench")


@pytest.mark.parametrize("shape", [
    # granite-3.2-8b decode over contexts the cells reach
    dict(B=8, H=32, KV=8, hd=128, bs=16, nb=64,
         lengths=[16, 100, 256, 300, 512, 640, 1000, 1024], window=0),
    # zamba2-2.7b's attention layers (MHA, head 80)
    dict(B=4, H=32, KV=32, hd=80, bs=16, nb=32,
         lengths=[1, 17, 255, 512], window=0),
    # a window (the bench's float32 case)
    dict(B=3, H=32, KV=8, hd=128, bs=16, nb=16, lengths=[5, 40, 256],
         window=24),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b1_counts_equal_the_kernel_bench(shape, dtype):
    gen = torch.Generator().manual_seed(0)
    case = bench.attention_case(gen, "cpu", dtype, name="t", **shape)
    es = torch.finfo(dtype).bits // 8
    assert Y.decode_attention_work(es=es, **shape) == (case.nbytes, case.ops)


def test_ragged_b1_reduces_to_decode_plus_its_row_vector():
    lengths = [16, 100, 256, 300]
    tables = [list(range(i * 64, i * 64 + 64)) for i in range(4)]
    nb, ops = Y.ragged_attention_work(
        H=32, KV=8, hd=128, bs=16, q_lens=np.array(lengths),
        req_rows=np.arange(4), block_tables=tables, table_width=64, es=2)
    want = Y.decode_attention_work(B=4, H=32, KV=8, hd=128, bs=16, nb=64,
                                   lengths=lengths, window=0, es=2)
    assert (nb, ops) == (want[0] + 4 * 4, want[1])


def test_ragged_b1_reads_a_shared_block_once():
    tables = [[0, 1, 2], [0, 1, 3]]          # two requests sharing 2 blocks
    nb, _ = Y.ragged_attention_work(
        H=4, KV=2, hd=16, bs=16, q_lens=np.array([48, 48]),
        req_rows=np.array([0, 1]), block_tables=tables, table_width=4, es=2)
    kv = 2 * 16 * 2 * 16 * 2                 # one block of K and V
    assert nb == 2 * 2 * 4 * 16 * 2 + 4 * kv + 4 * (2 * 4 + 4)


@pytest.mark.parametrize("S,N,P", [(1, 64, 64), (16, 64, 64), (64, 64, 64),
                                   (200, 128, 64), (2048, 64, 64),
                                   (70, 32, 40)])
def test_b3_operations_equal_the_kernel_bench(S, N, P):
    assert Y.ssd_ops(S, N, P) == bench.ssd_ops(S, N, P)


def test_b3_dense_bytes_equal_the_kernel_bench():
    gen = torch.Generator().manual_seed(0)
    case = bench.ssd_case(gen, "cpu", Bt=2, S=128, H=80, P=64, N=64,
                          name="t", plain_iters=1)
    assert Y.dense_ssd_bytes(Bt=2, S=128, H=80, N=64, P=64) == case.nbytes
    assert 2 * 80 * Y.ssd_ops(128, 64, 64) == case.ops


def test_ragged_b3_reduces_to_dense_plus_its_vectors_and_entry_states():
    nb, ops = Y.ragged_ssd_work(H=80, N=64, P=64, seg_lens=[128, 128],
                                seg_from_zero=[True, True], n_kept=2)
    dense = Y.dense_ssd_bytes(Bt=2, S=128, H=80, N=64, P=64)
    # + the two entry states read, + 2T + kept int32 entries
    assert nb == dense + 4 * 2 * 80 * 64 * 64 + 4 * (2 * 256 + 2)
    assert ops == 2 * 80 * Y.ssd_ops(128, 64, 64)
    # a segment that continues a state pays C.state and the decay
    _, cont = Y.ragged_ssd_work(H=80, N=64, P=64, seg_lens=[128],
                                seg_from_zero=[False], n_kept=1)
    assert cont > ops / 2


def test_bound_takes_the_larger_time():
    assert Y.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert Y.bound_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert Y.bound_s(0, 165e12, "float32") == pytest.approx(1.0)
