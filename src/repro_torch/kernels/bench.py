"""Kernel bench of the port: decode paged attention, the dense SSD chunk
scan and the fused aLoRA QKV projection, at full model widths.

    python -m repro_torch.kernels.bench [--device cpu] [--reduced]

The port of the reference's ``benchmarks/bench_kernels.py``.  By
default it runs on the card at the widths of granite-3.2-8b (decode
attention over contexts of 256 to 4096 tokens; the fused Q/K/V
projection with four stacked rank-32 adapters) and of mamba2-2.7b and
zamba2-2.7b (the scan over two rows of 2048 tokens).  For each case it
prints the kernel's time (CUDA events, the L2 cache flushed before each
launch), the plain version's time, the kernel's error against the plain
version, and the least time the card could take for the same work (the
larger of the unique bytes over 3.35 TB/s and the operations over the
type's peak rate: 989 TFLOP/s bf16, 165 float32 as three TF32
products; NVIDIA H100 SXM data sheet).  For the projection it also
times the base product alone with ``torch.matmul``; for decode
attention, ``scaled_dot_product_attention`` on K/V gathered beforehand
(yardsticks: the port calls neither), each by events and by the
profiler's device time; and each case's device time per launch of each
CUDA kernel (``torch.profiler``), which splits the fused projection into
its shrink, the pass over its splits, its tile kernel and the sum of
the tile's d splits.

With ``--device cpu --reduced`` it runs only the plain versions, at
small shapes, and prints one row per kernel.  Rows are CSV,
``name,us_per_call,derived``; :func:`run` also returns every number.
"""
from __future__ import annotations

import argparse
import re
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.alora_qkv import alora_qkv, alora_qkv_ref
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.ssd_chunk import ssd_chunk_ref, ssd_chunk_scan

HBM_BYTES_PER_S = 3.35e12                            # H100 SXM HBM3
BF16_PEAK = 989e12            # dense bf16 on the tensor cores
# float32: the port's float32 kernels run on the tensor cores as three
# TF32 products each (3xTF32: hi*hi + hi*lo + lo*hi), so their peak is
# the 495 TFLOP/s of TF32 over three; the 67 TFLOP/s of the CUDA cores
# would let a tensor-core kernel read over 100 % of its bound
FP32_TENSOR_PEAK = 495e12 / 3
FP32_CUDA_CORE_PEAK = 67e12   # not a bound: kept for comparison
PEAK_OPS = {torch.bfloat16: BF16_PEAK, torch.float32: FP32_TENSOR_PEAK}


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """CSV contract: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}")
    sys.stdout.flush()


@dataclass
class Case:
    """One bench case: the kernel's wrapper and its plain version on the
    same inputs, and the work the call must do."""
    kernel: str
    name: str
    args: tuple
    kwargs: dict
    nbytes: int
    ops: int
    dtype: torch.dtype
    shape: str
    per_row: bool = False       # error per output row (attention)
    plain_iters: int = 10       # the plain SSD scan is a long Python loop
    # (result key, factory of the call to time): a PyTorch call timed
    # beside the kernel, on the card only; the factory does the set-up
    # that is not timed
    yardstick: Optional[Tuple[str, Callable[[], Callable]]] = None


WRAPPERS = {"paged_attention": (paged_attention, paged_attention_ref),
            "alora_qkv": (alora_qkv, alora_qkv_ref),
            "ssd_chunk_scan": (ssd_chunk_scan, ssd_chunk_ref)}


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype):
    """The larger of the bytes' and the operations' time on the card,
    in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def b1_counts(tracer=None) -> Dict[str, int]:
    """What B1's planner counted since the last read, summed over the
    devices it ran on (``paged_attention.COUNTS``: items, cut items,
    blocks launched, blocks the replaced (T, KV, splits) grid would have
    launched), and the counters zeroed.  ``tracer``: each count is also
    added to its counters (``Tracer.count``).  A read syncs with the
    card: call it at a bench's end, never inside a step."""
    from repro_torch.kernels import paged_attention as pa
    total = dict.fromkeys(pa.COUNTS, 0)
    for t in pa._COUNTS.values():
        for name, v in zip(pa.COUNTS, t.tolist()):
            total[name] += int(v)
        t.zero_()
    if tracer is not None:
        for name, v in total.items():
            tracer.count(name, v)
    return total


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
def attention_case(gen, device, dtype, *, B, H, KV, hd, bs, lengths, nb,
                   window, name):
    """Decode attention: sequence b holds ``lengths[b]`` tokens in blocks
    drawn from a shuffled pool of ``B * nb + 1`` blocks; every table entry
    past a length points at the pool's last block, which no sequence
    owns."""
    used = [-(-n // bs) for n in lengths]
    NB = B * nb + 1
    dump = NB - 1
    perm = torch.randperm(NB - 1, generator=gen, device=device)
    tables = torch.full((B, nb), dump, dtype=torch.int32, device=device)
    lo = 0
    for b, n in enumerate(used):
        tables[b, :n] = perm[lo:lo + n]
        lo += n
    q = torch.randn((B, H, hd), generator=gen, device=device).to(dtype)
    k = torch.randn((NB, bs, KV, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((NB, bs, KV, hd), generator=gen, device=device).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    es = q.element_size()
    # bytes: q and out once, the blocks holding each sequence's valid
    # positions (inside the window), the tables and lengths; operations:
    # Q.K^T and P.V over the valid positions
    blocks = ops = 0
    for n in lengths:
        first = max(0, n - window) // bs if window else 0
        blocks += -(-n // bs) - first
        ops += 4 * H * hd * (min(n, window) if window else n)
    nbytes = 2 * B * H * hd * es + 2 * blocks * bs * KV * hd * es \
        + 4 * (tables.numel() + B)
    shape = (f"B={B} H={H} KV={KV} hd={hd} bs={bs} nb={nb} "
             f"lengths={lengths[0]}..{lengths[-1]} window={window}")
    return Case("paged_attention", name, (q, k, v, tables, lens),
                {"window": window}, nbytes, ops, dtype, shape, per_row=True,
                yardstick=("library_ms",
                           lambda: sdpa_call(q, k, v, tables, lens, window)))


def sdpa_call(q, k_pool, v_pool, tables, lens, window):
    """``scaled_dot_product_attention`` over each sequence's K/V gathered
    here (not in the returned call), masked to its length and window:
    one PyTorch call for decode attention's function."""
    B, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    nb = tables.shape[1]
    bt = tables.long()
    k = k_pool[bt].reshape(B, nb * bs, KV, hd).transpose(1, 2).contiguous()
    v = v_pool[bt].reshape(B, nb * bs, KV, hd).transpose(1, 2).contiguous()
    pos = torch.arange(nb * bs, device=q.device)[None, :]
    valid = pos < lens[:, None]
    if window:
        valid = valid & (pos > lens[:, None] - 1 - window)
    mask = valid[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def alora_case(gen, device, dtype, *, T, d, out, n, r, name, edge=False):
    """The fused projection with ``n`` stacked adapters (slot 0 the zero
    adapter) and the tokens spread evenly over the indices 0..n-1.  With
    ``edge``, slot 0 holds a nonzero adapter and some tokens the indices
    -1 and n: the kernel must skip all three, as the plain version does."""
    x = torch.randn((T, d), generator=gen, device=device).to(dtype)
    w = (torch.randn((d, out), generator=gen, device=device)
         / d ** 0.5).to(dtype)
    a = (torch.randn((n, d, r), generator=gen, device=device)
         / d ** 0.5).to(dtype)
    b = (torch.randn((n, r, out), generator=gen, device=device)
         * (0.5 / r ** 0.5))
    if not edge:
        b[0] = 0
    b = b.to(dtype)
    idx = torch.arange(T, device=device, dtype=torch.int32) % n
    if edge:
        idx[::5] = -1
        idx[1::5] = n
    idx = idx[torch.randperm(T, generator=gen, device=device)].contiguous()
    es = x.element_size()
    on = [int((idx == i).sum()) for i in range(1, n)]
    live = sum(1 for c in on if c)
    nbytes = (T * d + d * out + live * r * (d + out) + T * out) * es + 4 * T
    ops = 2 * T * d * out + sum(on) * 2 * r * (d + out)
    shape = f"T={T} d={d} out={out} n={n} r={r}"
    return Case("alora_qkv", name, (x, w, a, b, idx), {}, nbytes, ops, dtype,
                shape, yardstick=("base_gemm_ms",
                                  lambda: lambda: torch.matmul(x, w)))


def ssd_ops(S: int, N: int, P: int) -> int:
    """The least operations the scan of one (row, head) over S tokens
    needs: those of the chunked form at its best chunk length Q, where
    a chunk of q tokens costs the lower triangles of C.B^T and of W.x
    (q(q+1)/2 (N + P) multiply-adds), C.state and the state update
    (q.N.P multiply-adds each) and the state's decay (N.P multiplies);
    the first chunk starts from a zero state and needs neither C.state
    nor the decay.  Q = 1 is the token recurrence (5 N.P per token); the
    best Q is near sqrt(N.P / (N + P)), 6 or 7 at N 128, P 64."""
    def chunk(q, first):
        return q * (q + 1) * (N + P) + 2 * q * N * P \
            + (0 if first else 2 * q * N * P + N * P)

    def at(Q):
        full, rest = divmod(S, Q)       # Q <= S: full >= 1
        return chunk(Q, True) + (full - 1) * chunk(Q, False) \
            + (chunk(rest, False) if rest else 0)
    return min(at(Q) for Q in range(1, S + 1))


def ssd_case(gen, device, *, Bt, S, H, P, N, name, plain_iters):
    """The dense scan over full sequences, inputs as the reference's
    kernel bench makes them: dt = softplus(randn), dA = -exp(0.3 randn) dt."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = rnd(Bt, S, H, P)
    B = rnd(Bt, S, H, N) * 0.5
    C = rnd(Bt, S, H, N) * 0.5
    dt = F.softplus(rnd(Bt, S, H))
    dA = -torch.exp(rnd(Bt, S, H) * 0.3) * dt
    nbytes = 4 * (2 * Bt * S * H * P + 2 * Bt * S * H * N + 2 * Bt * S * H
                  + Bt * H * N * P)
    ops = Bt * H * ssd_ops(S, N, P)
    shape = f"Bt={Bt} S={S} H={H} P={P} N={N}"
    return Case("ssd_chunk_scan", name, (x, B, C, dA, dt), {}, nbytes, ops,
                torch.float32, shape, plain_iters=plain_iters)


def cases(device: str = "cuda", reduced: bool = False) -> Iterator[Case]:
    """The bench's cases, one at a time (each holds its inputs), made
    from a seeded generator on ``device``.
    Full: granite-3.2-8b's decode attention (bf16, and float32 with a
    24-token window) and fused Q/K/V projection (bf16 at T = 128 and 512,
    float32 at 128); the scan at mamba2-2.7b's N = 128, zamba2-2.7b's
    N = 64 and the reduced SSM models' N = 16, each at mamba2's H and P.
    Reduced: one small case per kernel."""
    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    if reduced:
        yield attention_case(gen, device, f32, B=3, H=8, KV=2, hd=32, bs=8,
                             lengths=[5, 17, 32], nb=4, window=0,
                             name="reduced_f32")
        yield alora_case(gen, device, f32, T=100, d=64, out=96, n=3, r=8,
                         name="reduced_f32")
        yield ssd_case(gen, device, Bt=1, S=70, H=2, P=16, N=32,
                       name="reduced_f32", plain_iters=3)
        return
    granite = dict(B=8, H=32, KV=8, hd=128, bs=16, nb=256,
                   lengths=[256, 512, 768, 1024, 1536, 2048, 3072, 4096])
    qkv = dict(d=4096, out=6144, n=4, r=32)     # [wq | wk | wv], rank 32
    ssd = dict(Bt=2, S=2048, H=80, P=64, plain_iters=1)
    yield attention_case(gen, device, bf16, window=0, name="granite_bf16",
                         **granite)
    yield attention_case(gen, device, f32, window=24,
                         name="granite_f32_window24", **granite)
    for dtype, T in ((bf16, 128), (bf16, 512), (f32, 128)):
        yield alora_case(gen, device, dtype, T=T,
                         name=f"granite_{_short(dtype)}_T{T}", **qkv)
    yield ssd_case(gen, device, N=128, name="mamba2_N128", **ssd)
    yield ssd_case(gen, device, N=64, name="zamba2_N64", **ssd)
    yield ssd_case(gen, device, N=16, name="reduced_ssm_N16", **ssd)


def _short(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]


# ---------------------------------------------------------------------------
# timing and errors
# ---------------------------------------------------------------------------
class Timer:
    """Median ms of one call.  On the card by CUDA events, with the 50 MB
    L2 cache flushed before each launch (a serving step's callers find it
    cold: every layer reads other weights between two calls); on the CPU
    by the host clock."""

    def __init__(self, device: str):
        self.cuda = torch.device(device).type == "cuda"
        self.flush = torch.empty(96 << 20, dtype=torch.uint8,
                                 device=device) if self.cuda else None

    def __call__(self, fn, n: int = 25, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            if not self.cuda:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
                continue
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def errors(got, want, per_row: bool) -> Dict[str, float]:
    """max |got - want|, that over max |want|, and (per_row) the largest
    per-row max |got - want| over that row's max |want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    out = {"max_abs_err": err,
           "rel_err": err / max(w.abs().max().item(), 1e-30),
           "finite": bool(g.isfinite().all())}
    if per_row:
        d = (g - w).abs().reshape(g.shape[0], -1).amax(1)
        s = w.abs().reshape(w.shape[0], -1).amax(1).clamp_min(1e-30)
        out["row_rel_err"] = (d / s).max().item()
    return out


def outputs(result) -> tuple:
    return result if isinstance(result, tuple) else (result,)


def _profiled(call, timer, n: int = 10):
    """``torch.profiler`` over ``n`` calls of ``call``, the L2 cache
    flushed before each (by ``timer.flush``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            timer.flush.zero_()
            call()
        torch.cuda.synchronize()
    return prof


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0) or 0


def device_split(case, kernel, timer, n: int = 10) -> Dict[str, float]:
    """Device ms per launch of each CUDA kernel of the port that a call
    of ``kernel`` launches (each once per call), over ``n`` calls with
    the L2 cache flushed before each (the flush's own kernel not
    counted).  Averaged over the launches the profiler recorded: a
    second profiling session in one process may miss some."""
    prof = _profiled(lambda: kernel(*case.args, **case.kwargs), timer, n)
    split = {}
    for e in prof.key_averages():
        us = _device_us(e)
        m = re.search(r"repro_torch::(?:\(anonymous namespace\)::)?(\w+)",
                      e.key)
        if m and us > 0:
            total, count = split.get(m.group(1), (0.0, 0))
            split[m.group(1)] = (total + us / 1e3, count + e.count)
    return {name: total / count for name, (total, count) in split.items()}


def device_span(case, kernel, timer, n: int = 10) -> Optional[float]:
    """Device ms from the first kernel of a call of ``kernel`` to the end
    of its last, over ``n`` calls with the L2 cache flushed before each
    (the flush's kernel starts each call's group); the call's kernels may
    overlap (programmatic dependent launch), so their device times do not
    add up to it.  None when the profiler gives no kernel times."""
    from torch.autograd import DeviceType
    prof = _profiled(lambda: kernel(*case.args, **case.kwargs), timer, n)
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and e.time_range.end > e.time_range.start),
                    key=lambda e: e.time_range.start)
    spans, group = [], None
    for e in events:
        if "repro_torch" not in e.name:     # the flush: a new call
            if group:
                spans.append(group[1] - group[0])
            group = None
            continue
        group = (e.time_range.start, e.time_range.end) if group is None \
            else (group[0], max(group[1], e.time_range.end))
    if group:
        spans.append(group[1] - group[0])
    return statistics.mean(spans) / 1e3 if spans else None


def call_device_ms(call, timer, n: int = 10) -> float:
    """Device ms of one ``call`` (every kernel it launches, summed), over
    ``n`` calls with the L2 cache flushed before each; the flush's own
    kernel is not counted (it is profiled alone first, by name)."""
    flush = {e.key for e in _profiled(lambda: None, timer, 1).key_averages()
             if _device_us(e) > 0}
    prof = _profiled(call, timer, n)
    return sum(_device_us(e) for e in prof.key_averages()
               if e.key not in flush) / 1e3 / n


def run(device: str = "cuda", reduced: bool = False) -> Dict[str, dict]:
    """Run every case and print its rows; returns, by ``kernel/name``, the
    shape, the work, and (on the card) the kernel's error and time, its
    yardstick's time and its device time per launch of each CUDA
    kernel."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernel bench runs on the card by default; "
                           "pass device='cpu' (--device cpu) without one")
    on_card = torch.device(device).type == "cuda"
    timer = Timer(device)
    results = {}
    for case in cases(device, reduced):
        kernel, plain = WRAPPERS[case.kernel]
        key = f"{case.kernel}/{case.name}"
        last = {}           # the plain output of the last timed call

        def plain_call():
            last["out"] = plain(*case.args, **case.kwargs)
        plain_ms = timer(plain_call, n=case.plain_iters, warmup=0)
        want = outputs(last.pop("out"))
        bnd, by = bound_ms(case.nbytes, case.ops, case.dtype)
        res = {"kernel": case.kernel, "shape": case.shape,
               "dtype": str(case.dtype).replace("torch.", ""),
               "bytes": case.nbytes, "ops": case.ops, "bound_ms": bnd,
               "bound_by": by, "plain_ms": plain_ms, "device": device}
        emit(f"kernels/{key}/plain-{device}", plain_ms * 1e3, case.shape)
        if on_card:
            got = outputs(kernel(*case.args, **case.kwargs))
            torch.cuda.synchronize()
            errs = [errors(g, w, case.per_row) for g, w in zip(got, want)]
            res["finite"] = all(e.pop("finite") for e in errs)
            res.update({k: max(e[k] for e in errs) for k in errs[0]})
            res["ms"] = timer(lambda: kernel(*case.args, **case.kwargs))
            err = " ".join(f"{k}={res[k]:.3e}" for k in
                           ("max_abs_err", "rel_err", "row_rel_err")
                           if k in res)
            emit(f"kernels/{key}/{device}", res["ms"] * 1e3,
                 f"{err} bound_us={bnd * 1e3:.1f}({by}) {case.shape}")
            if case.yardstick is not None:
                field, make = case.yardstick
                call = make()
                res[field] = timer(call)
                res[field[:-3] + "_device_ms"] = call_device_ms(call, timer)
                emit(f"kernels/{key}/{field[:-3]}-{device}",
                     res[field] * 1e3, "yardstick: one PyTorch call")
                emit(f"kernels/{key}/{field[:-3]}-device",
                     res[field[:-3] + "_device_ms"] * 1e3,
                     "yardstick, torch.profiler device time")
            res["device_split_ms"] = device_split(case, kernel, timer)
            for name, ms in res["device_split_ms"].items():
                emit(f"kernels/{key}/device-{name}", ms * 1e3,
                     "torch.profiler, per launch")
            res["device_span_ms"] = device_span(case, kernel, timer)
            if res["device_span_ms"] is not None:
                emit(f"kernels/{key}/device-span", res["device_span_ms"] * 1e3,
                     "torch.profiler, first kernel start to last kernel end")
            del got
        results[key] = res
        del want
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): kernels and plain versions; cpu: "
                         "the plain versions only")
    ap.add_argument("--reduced", action="store_true",
                    help="small shapes instead of the models' widths")
    args = ap.parse_args(argv)
    run(args.device, args.reduced)


if __name__ == "__main__":
    main()
