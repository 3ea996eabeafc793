"""Step audit (Pass A of the invariant analyzer), the reference's
``repro/analysis/step_audit.py`` on the port's eager mixed step.

The serving engine's performance story rests on properties of ONE
step: ``ModelRunner._mixed_impl``.  The reference checks them on the
compiled module of the exact lowering production dispatches; the port's
step is eager, so its counterpart of that module is what one step
dispatches, recorded by ``ModelRunner.trace_mixed`` (the same
``_assemble_mixed`` and ``_mixed_impl`` that ``submit_batch`` runs, on
clones of the in-place state; ``analysis.step_trace``).  For every
config in ``repro_torch.configs`` × mesh in {one device, data=2/model=4}
we check:

  A1  no host round-trip inside the step: no ``_local_scalar_dense``
      (``.item()``, ``int(t)``, ``bool(t)``), no copy from the device to
      the host; on a card the assembly and the step run under
      ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
      synchronising call the record could miss.  The plain versions'
      host loops run only on CPU tensors and enter the record as one
      call each (``plain:<kernel>``).
  A2  the host payload is ids-only: every returned output is one of
      ``b_ssm``/``b_conv``/``sampled``; ``sampled`` is a 1-D int32 of at
      most pow2(max_running) rows; no returned output has a vocab-sized
      dimension.  After the capture serve the runner's device → host log
      holds exactly one "step" fetch per mixed step, int32, of at most
      pow2(max_running) elements (``fetch_sampled`` is the only per-step
      transfer).
  A3  pools updated in place (donation in the reference): the K/V
      pools, ``tok_buf`` and, on SSM stacks, ``live_ssm``/``live_conv``
      keep their ``data_ptr`` and have their ``_version`` advanced by
      the step; no other persistent tensor (params, adapter stacks,
      snapshot and encoder pools) changes version; no tensor of a pool's
      or a pool layer's shape is allocated in the step (a pool rebuilt
      out of place).
  A4  collective fingerprint: per-(config, mesh) counts and result
      bytes of ``distributed.parallel.COLLECTIVES`` over one step on
      rank 0 must match the checked-in golden under ``goldens/`` (the
      port's own: gloo's ``all_reduce``/``all_gather``), and every
      rank's fingerprint must equal rank 0's.
  A5  hygiene: no float32 copy of a bf16 tensor of at least d_model²
      elements (``ALLOWED_UPCASTS`` lists the reviewed exceptions); no
      operation whose output shape depends on data (``nonzero``,
      ``masked_select``, ``unique*``, a bool-mask index,
      ``repeat_interleave`` with tensor repeats); bucket-static: two
      consecutive decode-only steps of the capture serve in one pow2
      bucket dispatch the same operations with the same shapes and the
      same kernel launches.

Sync ≡ async: batches are captured from an engine running the production
default (async one-step-lookahead); the sync-flavoured copy
(``from_buf=None``) must dispatch the same operations, shapes and
launches — the two modes are data, not program.

The kernel path: the traced step must run each serving kernel once per
layer (B1 and B2's fused Q/K/V entry per attention layer, B3 and B2's
one-pair entry per SSM layer): launched on a card, its plain version
on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.step_trace import StepTrace
from repro_torch.configs import get_reduced, list_archs
from repro_torch.configs.base import ATTN, SSM
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.runner import MixedBatch, log_d2h, next_pow2

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# mesh-name → (data, model) axes; None = single device
MESHES: Dict[str, Optional[Tuple[int, int]]] = {"1x1": None, "2x4": (2, 4)}

# the step's outputs by slot name: the pools it updates in place, then
# what ``_mixed_impl`` returns
OUT_NAMES = ("k_pool", "v_pool", "live_ssm", "live_conv", "tok_buf",
             "b_ssm", "b_conv", "sampled")
# outputs allowed to reach the host
HOST_PAYLOAD = frozenset({"b_ssm", "b_conv", "sampled"})
# reviewed float32 copies of bf16 param-sized tensors, by the path of
# the param they copy (suffix) and why each stays
ALLOWED_UPCASTS: Tuple[Tuple[str, str], ...] = (
    ("ssm/out_proj",
     "models/ssm.py:286 `_out_proj` casts the SSM out-projection to "
     "float32 in every SSM layer at every step, the float32 product the "
     "reference computes (repro/models/ssm.py:365); casting it once at "
     "load is ROADMAP B'2"),)
# operations whose output shape depends on the data
DYNAMIC_OPS = ("aten.nonzero.", "aten.masked_select.", "aten.unique",
               "aten._unique", "aten.argwhere.",
               "aten.repeat_interleave.Tensor")
# the serving kernels by layer kind: (wrapper, layer kind, needs adapters)
SERVING_KERNELS = (("ragged_paged_attention", ATTN, False),
                   ("ragged_grouped_lora_qkv", ATTN, True),
                   ("ragged_grouped_lora", SSM, True),
                   ("ragged_ssd_chunk_scan", SSM, False))


@dataclass
class AuditResult:
    arch: str
    mesh: str
    violations: List[str] = field(default_factory=list)
    fingerprint: Dict[str, Dict] = field(default_factory=dict)
    fingerprint_diff: str = ""
    donated: List[str] = field(default_factory=list)
    sync_async_identical: bool = True
    memory: Dict[str, float] = field(default_factory=dict)
    # findings on ALLOWED_UPCASTS' list (not violations), the traced
    # step's kernel launches (or plain calls on the CPU), and whether it
    # ran under the sync debug mode "error"
    allowed: List[str] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)
    sync_guarded: bool = False

    @property
    def ok(self) -> bool:
        return not self.violations and not self.fingerprint_diff

    def to_json(self) -> Dict:
        return {
            "kind": "analysis_audit", "arch": self.arch,
            "mesh": self.mesh, "ok": self.ok,
            "violations": list(self.violations),
            "fingerprint": self.fingerprint,
            "fingerprint_drift": bool(self.fingerprint_diff),
            "donated": list(self.donated),
            "sync_async_identical": self.sync_async_identical,
            "memory": dict(self.memory),
        }


# ------------------------------------------------------------- checks
def check_host_roundtrips(trace: StepTrace) -> List[str]:
    """A1."""
    out = []
    if trace.sync_error:
        out.append(f"host-sync: the step made a synchronising CUDA call "
                   f"({trace.sync_error})")
    for i, op in enumerate(trace.ops):
        if op.name.startswith("aten._local_scalar_dense"):
            m = op.ins[0] if op.ins else None
            out.append(f"host-sync: op #{i} {op.name} reads a "
                       f"{m.dtype if m else '?'} scalar back to the host "
                       "(.item()/int()/bool() in the step)")
        elif any(m.device != "cpu" for m in op.ins) \
                and any(m.device == "cpu" for m in op.outs):
            out.append(f"host-sync: op #{i} {op.name} copies device "
                       "memory to the host in the step")
    return out


def check_payload(trace: StepTrace, vocab_size: int,
                  max_running: int) -> List[str]:
    """A2 on the step's returned outputs."""
    out = []
    cap = next_pow2(max_running)
    for idx, (name, m) in enumerate(trace.outputs):
        if name not in HOST_PAYLOAD:
            out.append(f"payload: returned output #{idx} ({name}, "
                       f"{m.dtype}{list(m.shape)}) is not part of the "
                       "ids-only host payload")
        if vocab_size in m.shape:
            out.append(f"payload: returned output #{idx} ({name}) has a "
                       f"vocab-sized dim {list(m.shape)} — logits must "
                       "never leave the device")
        if name == "sampled" and (m.dtype != "int32" or len(m.shape) != 1
                                  or m.shape[0] > cap):
            out.append(f"payload: sampled is {m.dtype}{list(m.shape)}; "
                       f"expected 1-D int32 of ≤ {cap} rows")
    return out


def check_fetches(fetches: Sequence[Tuple[int, str, str]], n_steps: int,
                  max_running: int) -> List[str]:
    """A2 on the serve: ``fetches`` are the runner's ``d2h_fetches``
    entries logged over ``n_steps`` mixed steps."""
    cap = next_pow2(max_running)
    steps = [f for f in fetches if f[2] == "step"]
    out = [f"payload: a {tag!r} device→host transfer ({n} x {dt}) beside "
           "the per-step sampled ids" for n, dt, tag in fetches
           if tag not in ("step", "admit")]
    if len(steps) != n_steps:
        out.append(f"payload: {len(steps)} 'step' fetches over {n_steps} "
                   "mixed steps; expected exactly one per step")
    out += [f"payload: a step fetched {n} x {dt}; expected int32 of "
            f"≤ {cap} elements" for n, dt, _ in steps
            if dt != "int32" or n > cap]
    return out


def check_donation(trace: StepTrace, La: int,
                   Ls: int) -> Tuple[List[str], List[str]]:
    """A3: every pool updated in place, nothing else persistent touched,
    no pool rebuilt.  The K/V pools exist where the stack has ``La``
    attention layers, the live SSM pools where it has ``Ls`` SSM layers.
    Returns (violations, names updated in place)."""
    expected = {"tok_buf"}
    if La:
        expected |= {"k_pool", "v_pool"}
    if Ls:
        expected |= {"live_ssm", "live_conv"}
    out, donated = [], []
    for name in sorted(expected):
        st = trace.pools.get(name)
        if st is None:
            out.append(f"donation: expected pool '{name}' absent")
            continue
        if st.ptr_after != st.ptr_before:
            out.append(f"donation: {name} was replaced by a new tensor in "
                       "the step — its memory doubles every step")
        elif st.version_after == st.version_before:
            out.append(f"donation: {name} was not updated in place by the "
                       "step")
        else:
            donated.append(name)
    for name in sorted(set(trace.pools) - expected):
        out.append(f"donation: unexpected in-place update of {name}")
    for path, (v0, v1) in sorted(trace.persistent.items()):
        if v1 != v0:
            out.append(f"donation: the step wrote {path} in place (version "
                       f"{v0} -> {v1}) — only the pools may change")
    shapes: Dict[Tuple, List[str]] = {}
    for name, st in sorted(trace.pools.items()):
        if name != "tok_buf":
            shapes.setdefault((st.meta.shape, st.meta.dtype), []).append(name)
            shapes.setdefault((st.meta.shape[1:], st.meta.dtype),
                              []).append(f"a layer of {name}")
    outputs = {m.storage for _, m in trace.outputs}
    for i, op in enumerate(trace.ops):
        ins = {m.storage for m in op.ins}
        for m in op.outs:
            what = " or ".join(shapes.get((m.shape, m.dtype), ()))
            if what and m.storage not in ins and m.storage not in outputs:
                out.append(f"donation: op #{i} {op.name} allocates "
                           f"{m.dtype}{list(m.shape)}, the shape of {what} "
                           "— a pool rebuilt out of place")
    return out, sorted(donated)


def check_bf16_upcasts(trace: StepTrace, threshold_elems: int
                       ) -> Tuple[List[str], List[str]]:
    """A5: float32 copies of bf16 tensors of at least ``threshold_elems``
    elements.  Returns (violations, findings on ``ALLOWED_UPCASTS``)."""
    out, allowed = [], []
    for i, op in enumerate(trace.ops):
        if not op.name.startswith(("aten._to_copy", "aten.copy_")) \
                or not op.ins:
            continue
        src = op.ins[-1] if op.name.startswith("aten.copy_") else op.ins[0]
        if src.dtype != "bfloat16" \
                or not any(m.dtype == "float32" for m in op.outs):
            continue
        n = int(np.prod(src.shape))
        if n < threshold_elems:
            continue
        path = trace.names.get(src.storage, "a step tensor")
        msg = (f"bf16-upcast: op #{i} {op.name} copies {path} "
               f"bf16{list(src.shape)} ({n} elems ≥ {threshold_elems}) to "
               "float32")
        site = next((s for s, _ in ALLOWED_UPCASTS if path.endswith(s)),
                    None)
        if site is None:
            out.append(f"{msg} — param-sized tensors must stay bf16 in-step")
        else:
            allowed.append(f"{msg} [allowed: {site}]")
    return out, allowed


def check_dynamic_shapes(trace: StepTrace) -> List[str]:
    """A5: no operation whose output shape depends on data."""
    return [f"dynamic-shape: op #{i} {op.name}"
            + (" indexes by a bool mask" if op.bool_index else "")
            + " (bucketed shapes must stay fully static)"
            for i, op in enumerate(trace.ops)
            if op.bool_index or op.name.startswith(DYNAMIC_OPS)]


def diff_traces(a: StepTrace, b: StepTrace) -> str:
    """Where two traces' signatures first differ ("" if they agree)."""
    ka, kb = a.signature(), b.signature()
    if ka == kb:
        return ""
    if ka[1] != kb[1]:
        return f"kernel launches {dict(ka[1])} vs {dict(kb[1])}"
    for i, (x, y) in enumerate(zip(ka[0], kb[0])):
        if x != y:
            return f"op #{i}: {x} vs {y}"
    return f"{len(ka[0])} vs {len(kb[0])} ops"


def check_bucket_static(a: StepTrace, b: StepTrace) -> List[str]:
    """A5: two steps of one bucket must dispatch the same program."""
    if a.bucket != b.bucket:
        return [f"bucket-static: the steps compared are in buckets "
                f"{a.bucket} and {b.bucket}"]
    d = diff_traces(a, b)
    return [f"bucket-static: two decode-only steps of bucket {a.bucket} "
            f"dispatch different programs ({d})"] if d else []


def check_sync_async(trace: StepTrace, trace_sync: StepTrace) -> List[str]:
    """The sync-flavoured step (``from_buf=None``) must dispatch the same
    program and run the same collectives as the async one."""
    out = []
    d = diff_traces(trace, trace_sync)
    if d:
        out.append(f"sync-async: the sync-flavoured step dispatches another "
                   f"program ({d})")
    if fingerprint_of(trace_sync) != fingerprint_of(trace):
        out.append("sync-async: the sync-flavoured step runs other "
                   "collectives")
    return out


def check_launches(trace: StepTrace, runner) -> List[str]:
    """The traced step ran the kernel path: each serving kernel once per
    layer of its kind (launched on a card, its plain version on the
    CPU), and no other kernel."""
    adapted = {k: sum(1 for kind, al in zip(runner.kinds,
                                            runner.adapter_layers)
                      if kind == k and al is not None) for k in (ATTN, SSM)}
    layers = {ATTN: runner.La, SSM: runner.Ls}
    want = {name: (adapted if needs else layers)[kind]
            for name, kind, needs in SERVING_KERNELS}
    got = trace.launches if trace.device == "cuda" else trace.plain_calls()
    other = trace.plain_calls() if trace.device == "cuda" else {
        k: v for k, v in trace.launches.items() if v}
    out = [f"kernel-path: {name} ran {got.get(name, 0)} times in the step; "
           f"expected {n} (once per layer)" for name, n in want.items()
           if got.get(name, 0) != n]
    out += [f"kernel-path: {name} ran {n} times beside the serving kernels"
            for name, n in got.items() if name not in want and n]
    if any(other.values()):
        out.append(f"kernel-path: on {trace.device} the step also ran "
                   f"{other}")
    return out


# -------------------------------------------------------- fingerprints
def golden_path(arch: str, mesh_name: str,
                golden_dir: str = GOLDEN_DIR) -> str:
    return os.path.join(golden_dir, f"{arch}__{mesh_name}.json")


def fingerprint_of(trace: StepTrace) -> Dict[str, Dict]:
    c = trace.collectives
    return {"counts": {k: c[k]["count"] for k in sorted(c)},
            "result_bytes": {k: c[k]["bytes"] for k in sorted(c)}}


# the knob most likely responsible when a collective kind drifts
_DRIFT_KNOBS: Dict[str, str] = {
    "all-gather": "EngineConfig.data_shard_tokens / the mesh `data` axis "
                  "(TensorParallel.gather_rows: K/V, xBC/dt and hidden "
                  "rows) or the `model` axis (gather_vocab)",
    "all-reduce": "the mesh `model` axis / RankLayout (the row-parallel "
                  "sums after Wo, w_down, the experts and out_proj, the "
                  "vocab-parallel embedding, the gated norm's sum)",
}


def diff_fingerprint(arch: str, mesh_name: str, seen: Dict,
                     golden: Optional[Dict]) -> str:
    """Human-reviewable drift report, one line pair per collective kind:
    count and result-byte deltas, and the knob most likely to have moved
    them."""
    if golden is None:
        return (f"{arch} [{mesh_name}]: no golden checked in at "
                f"{golden_path(arch, mesh_name)} — run `python -m "
                "repro_torch.analysis --update-goldens --device cpu`\n")
    if seen == golden:
        return ""
    lines = [f"{arch} [{mesh_name}]: collective fingerprint drift"]
    gc, sc = golden.get("counts", {}), seen.get("counts", {})
    gb, sb = golden.get("result_bytes", {}), seen.get("result_bytes", {})
    for kind in sorted(set(gc) | set(sc) | set(gb) | set(sb)):
        c0, c1 = gc.get(kind, 0), sc.get(kind, 0)
        b0, b1 = gb.get(kind, 0), sb.get(kind, 0)
        if c0 == c1 and b0 == b1:
            continue
        if c0 == 0 and b0 == 0:
            what, knob = "NEW op", ("a sharding change introduced this "
                                    "collective")
        elif c1 == 0 and b1 == 0:
            what, knob = "GONE", "a sharding change removed this collective"
        else:
            what = "drifted"
            knob = _DRIFT_KNOBS.get(kind, "the mesh shape / RankLayout")
        lines.append(f"  {kind:20s} {what:8s} "
                     f"count {c0} -> {c1} ({c1 - c0:+d}), "
                     f"bytes {b0} -> {b1} ({b1 - b0:+d})")
        lines.append(f"  {'':20s} likely knob: {knob}")
    return "\n".join(lines) + "\n"


def settle_golden(res: AuditResult, golden_dir: str = GOLDEN_DIR,
                  update_goldens: bool = False) -> AuditResult:
    """Write ``res``'s fingerprint as the golden, or diff it against the
    checked-in one."""
    gp = golden_path(res.arch, res.mesh, golden_dir)
    if update_goldens:
        os.makedirs(golden_dir, exist_ok=True)
        with open(gp, "w") as f:
            json.dump({"arch": res.arch, "mesh": res.mesh,
                       **res.fingerprint}, f, indent=2, sort_keys=True)
            f.write("\n")
        return res
    golden: Optional[Dict] = None
    if os.path.exists(gp):
        with open(gp) as f:
            g = json.load(f)
        golden = {"counts": g.get("counts", {}),
                  "result_bytes": g.get("result_bytes", {})}
    res.fingerprint_diff = diff_fingerprint(res.arch, res.mesh,
                                            res.fingerprint, golden)
    return res


# ------------------------------------------------------- engine plumbing
def build_engine(arch: str, mesh_name: str, *, device="cuda",
                 mesh=None) -> Engine:
    """The reduced ``arch`` with one rank-8 aLoRA adapter, 4 running and
    64 tokens a step; ``mesh``: this rank's mesh of ``MESHES[mesh_name]``
    (None at 1x1)."""
    if (MESHES[mesh_name] is None) != (mesh is None):
        raise ValueError(f"mesh {mesh_name} needs "
                         f"{'no' if mesh is not None else 'a'} rank mesh")
    dev = torch.device(device)
    cfg = get_reduced(arch)
    params = init_params(torch.Generator(device=dev.type).manual_seed(0),
                         cfg, device=dev)
    ads = [(AdapterSpec("ad0", rank=8, invocation_tokens=(7, 8, 9)),
            init_adapter_weights(
                torch.Generator(device=dev.type).manual_seed(100), cfg, 8,
                device=dev))]
    return Engine(cfg, params, adapters=ads, device=dev,
                  engine_cfg=EngineConfig(max_running=4,
                                          max_batched_tokens=64, mesh=mesh))


@contextlib.contextmanager
def capturing(eng: Engine):
    """Keep a copy of every batch the engine submits while entered; yields
    ``(batches, fetches)``: the device → host transfers of those steps
    are logged in ``fetches`` (the runner's own log gets them on exit)."""
    runner = eng.runner
    batches: List[MixedBatch] = []
    fetches: List[Tuple[int, str, str]] = []
    orig, log = runner.submit_batch, runner.d2h_fetches
    own = "submit_batch" in vars(runner)

    def cap(mb: MixedBatch):
        # the engine assembles batches in its pooled host buffers, which
        # later steps overwrite: keep a copy
        batches.append(dataclasses.replace(mb, **{
            f.name: np.array(v) if isinstance(v, np.ndarray)
            else [list(t) for t in v] if f.name == "block_tables" else v
            for f in dataclasses.fields(mb)
            for v in (getattr(mb, f.name),)}))
        return orig(mb)

    runner.submit_batch = cap  # type: ignore[method-assign]
    runner.d2h_fetches = fetches
    try:
        yield batches, fetches
    finally:
        if own:
            runner.submit_batch = orig  # type: ignore[method-assign]
        else:
            del runner.submit_batch
        runner.d2h_fetches = log
        for f in fetches:
            log_d2h(log, *f)


def capture_serve(eng: Engine, n: int = 4, gen: int = 4, plen: int = 24,
                  adapter: str = "ad0"):
    """Run a short production (async) serve of ``n`` requests, every
    other one on ``adapter``, request i generating ``gen + i`` tokens (so
    the run slots thin out one at a time within a request bucket);
    returns (the submitted batches, the device → host log entries of the
    serve)."""
    cfg = eng.cfg
    rng = np.random.RandomState(5)
    with capturing(eng) as (batches, fetches):
        for i in range(n):
            kw = {}
            if cfg.is_encoder_decoder:
                kw = dict(frame_embeds=np.random.RandomState(7).randn(
                    cfg.encoder_seq_len, cfg.d_model).astype(np.float32))
            eng.submit(list(rng.randint(10, 500, plen)), gen + i,
                       adapter_name=adapter if i % 2 else None,
                       arrival_time=1e-9 * i, **kw)
        steps = 0
        while (eng.pending or eng.waiting or eng.running) and steps < 60:
            eng.step()
            steps += 1
    if not batches:
        raise RuntimeError(f"no mixed batch captured for {cfg.name}")
    return batches, fetches


def richest(batches: Sequence[MixedBatch]) -> MixedBatch:
    """The batch to audit: one mixing decode rows with prefill chunks
    where there is one, the shape the steady-state engine dispatches."""
    return max(batches, key=lambda mb: (bool(len(mb.block_tables)),
                                        len(mb.tok_ids)))


def decode_pair(runner, batches: Sequence[MixedBatch]
                ) -> Optional[Tuple[MixedBatch, MixedBatch]]:
    """Two consecutive decode-only batches (one token per request, no
    snapshot rows) in one bucket of ``runner.buckets``: the first such
    pair whose run slots differ (a request retired between them), else
    the first such pair."""
    def decode(mb):
        return len(mb.tok_ids) == len(mb.block_tables) and (
            mb.snap_rows is None or not len(mb.snap_rows))
    pairs = [(a, b) for a, b in zip(batches, batches[1:])
             if decode(a) and decode(b)
             and runner.buckets(a) == runner.buckets(b)]
    return next((p for p in pairs if not np.array_equal(
        np.sort(p[0].run_slots), np.sort(p[1].run_slots))),
        pairs[0] if pairs else None)


# ------------------------------------------------------------ the audit
def audit_engine(eng: Engine, batches: Sequence[MixedBatch],
                 fetches: Sequence[Tuple[int, str, str]], n_steps: int, *,
                 arch: Optional[str] = None,
                 mesh_name: str = "1x1") -> AuditResult:
    """Trace the richest of ``batches`` (and its sync flavour, and a
    decode-only pair of one bucket) on ``eng`` and run every check but
    the golden diff; ``fetches``/``n_steps``: the device → host log of
    the serve that submitted ``batches`` and its mixed-step count;
    ``arch``: the record's name (default: the config's)."""
    runner, cfg = eng.runner, eng.cfg
    res = AuditResult(arch=arch or cfg.name, mesh=mesh_name)
    mb = richest(batches)
    trace = runner.trace_mixed(mb)
    # async vs sync is data (the from_buf mask), not program
    trace_sync = runner.trace_mixed(dataclasses.replace(mb, from_buf=None))
    res.sync_async_identical = not diff_traces(trace, trace_sync)
    res.violations += check_sync_async(trace, trace_sync)
    res.violations += check_host_roundtrips(trace)
    res.violations += check_payload(trace, cfg.vocab_size,
                                    runner.rcfg.max_running)
    res.violations += check_fetches(fetches, n_steps,
                                    runner.rcfg.max_running)
    dviol, res.donated = check_donation(trace, runner.La, runner.Ls)
    res.violations += dviol
    if dtype_of(cfg) == torch.bfloat16:
        up, res.allowed = check_bf16_upcasts(
            trace, threshold_elems=cfg.d_model * cfg.d_model)
        res.violations += up
    res.violations += check_dynamic_shapes(trace)
    pair = decode_pair(runner, batches)
    if pair is None:
        res.violations.append("bucket-static: the capture serve has no two "
                              "consecutive decode-only steps in one bucket")
    else:
        res.violations += check_bucket_static(
            *(runner.trace_mixed(x) for x in pair))
    res.violations += check_launches(trace, runner)
    res.sync_guarded = trace.sync_guarded
    res.launches = {k: v for k, v in (
        trace.launches if trace.device == "cuda"
        else trace.plain_calls()).items() if v}
    res.fingerprint = fingerprint_of(trace)
    res.memory = {
        "alias_size_bytes": float(sum(trace.pools[n].meta.nbytes
                                      for n in res.donated)),
        "output_size_bytes": float(sum(m.nbytes for _, m in trace.outputs)),
        "argument_size_bytes": float(trace.argument_bytes)}
    if trace.temp_bytes is not None:
        res.memory["temp_size_bytes"] = float(trace.temp_bytes)
    return res


def audit_config(arch: str, mesh_name: str, *, device="cuda", mesh=None,
                 golden_dir: str = GOLDEN_DIR,
                 update_goldens: bool = False,
                 golden: bool = True) -> AuditResult:
    """Build the reduced ``arch``'s engine (``mesh``: this rank's, for a
    sharded mesh), serve the capture workload and audit its richest
    step; with ``golden`` the fingerprint is then diffed against the
    checked-in golden (or, with ``update_goldens``, written as it)."""
    eng = build_engine(arch, mesh_name, device=device, mesh=mesh)
    steps0 = eng.runner.call_counts["mixed_step"]
    batches, fetches = capture_serve(eng)
    res = audit_engine(eng, batches, fetches,
                       eng.runner.call_counts["mixed_step"] - steps0,
                       arch=arch, mesh_name=mesh_name)
    return settle_golden(res, golden_dir, update_goldens) if golden else res


def _audit_rank(rank, archs: Sequence[str], mesh_name: str
                ) -> List[AuditResult]:
    """One rank of a sharded audit: every arch on this rank's mesh."""
    return [audit_config(arch, mesh_name, device=rank.device,
                         mesh=rank.mesh, golden=False) for arch in archs]


def audit_mesh(archs: Sequence[str], mesh_name: str, *, device="cuda",
               golden_dir: str = GOLDEN_DIR,
               update_goldens: bool = False) -> List[AuditResult]:
    """Audit ``archs`` on a sharded mesh in ONE world of its ranks
    (``distributed.spawn``): rank 0's results, each with a violation
    where another rank's fingerprint differs from rank 0's."""
    from repro_torch.distributed.spawn import launch
    data, model = MESHES[mesh_name]
    per_rank = launch(_audit_rank, list(archs), mesh_name, data=data,
                      model=model, device=device)
    out = []
    for i, res in enumerate(per_rank[0]):
        for r, rr in enumerate(per_rank[1:], start=1):
            if rr[i].fingerprint != res.fingerprint:
                res.violations.append(
                    f"collectives: rank {r}'s fingerprint "
                    f"{rr[i].fingerprint} differs from rank 0's")
            res.violations += [f"rank {r}: {v}" for v in rr[i].violations]
        out.append(settle_golden(res, golden_dir, update_goldens))
    return out


def audit_all(archs: Optional[List[str]] = None,
              mesh_names: Optional[List[str]] = None, *, device="cuda",
              golden_dir: str = GOLDEN_DIR, update_goldens: bool = False,
              progress=None) -> List[AuditResult]:
    """Every arch × mesh; a sharded mesh runs all its archs in one world
    of ranks (on a card, ranks sharing it)."""
    archs = list_archs() if archs is None else list(archs)
    mesh_names = list(MESHES) if mesh_names is None else list(mesh_names)
    res: Dict[Tuple[str, str], AuditResult] = {}
    for mesh_name in mesh_names:
        if MESHES[mesh_name] is None:
            for arch in archs:
                if progress:
                    progress(f"auditing {arch} [{mesh_name}]")
                res[(arch, mesh_name)] = audit_config(
                    arch, mesh_name, device=device, golden_dir=golden_dir,
                    update_goldens=update_goldens)
        else:
            if progress:
                progress(f"auditing {len(archs)} config(s) [{mesh_name}] "
                         f"in one world of "
                         f"{MESHES[mesh_name][0] * MESHES[mesh_name][1]} "
                         "ranks")
            for r in audit_mesh(archs, mesh_name, device=device,
                                golden_dir=golden_dir,
                                update_goldens=update_goldens):
                res[(r.arch, mesh_name)] = r
    return [res[(a, m)] for a in archs for m in mesh_names]
