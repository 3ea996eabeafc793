"""The port's invariant analyzer (``repro_torch.analysis``), Passes B and
C fitted to PyTorch, on AST fixtures and on the real port tree:

* every torch sync kind fires in a schedule/submit-phase fixture, and
  none fires in a retire, sequential-oracle or ``*_ref`` fixture, nor
  with ``non_blocking=True``, nor on a dtype cast;
* a ``sync-ok`` site without ``log_d2h`` fires; the obs recording rule
  (no torch call, no sync, no annotation escape); the phase protocol
  (retire-only calls, waivers, stale waivers) and the tables' honesty;
* Pass C's leak shapes, flagged and clean as fixed, a leaked run slot on
  an encoder-decoder admission (``encode`` acquires nothing: the encoder
  K/V live in the run slot), and a teardown without ``xkv``;
* the real port tree is clean and the CLI's exit codes and artifacts;
* ``ModelRunner.encode`` uploads the frames from the runner's staging
  pool with ``non_blocking=True`` and writes the same encoder K/V."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.analysis import check_files, check_tree, lint_files, \
    lint_tree
from repro_torch.analysis import hotpath_lint as HL
from repro_torch.analysis.__main__ import main

SRC_ROOT = os.path.join(os.path.dirname(__file__), "..", "src")

FIXTURE_KW = dict(roots=(("Engine", "step"),),
                  retire={("Engine", "_retire")},
                  oracle={("Engine", "_oracle")}, retire_only=set(),
                  attr_classes={"runner": "ModelRunner"})

GOOD_SRC = '''\
import numpy as np
import torch

def log_d2h(log, elems, dtype, tag):
    log.append((elems, dtype, tag))

class ModelRunner:
    def fetch(self, h):
        x = h.cpu()  # hotpath: sync-ok (test fixture)
        log_d2h([], 1, "int32", "step")
        return x

class Engine:
    def step(self):
        self._schedule()
        self.runner.fetch(None)
        self._oracle()
        self._retire()

    def _schedule(self):
        return np.array([1, 2])

    def _oracle(self):
        return np.array([3])

    def _retire(self):
        return np.array([4])

    def _never_called(self):
        return torch.zeros(2).cpu()
'''

# (snippet, kind) — each a host sync in torch terms
SYNCS = [
    ("x.item()", ".item()"),
    ("x.tolist()", ".tolist()"),
    ("x.cpu()", ".cpu()"),
    ('x.to("cpu")', ".to('cpu')"),
    ('x.to(torch.device("cpu"))', ".to('cpu')"),
    ('x.to(device="cpu")', ".to('cpu')"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("ev.synchronize()", ".synchronize()"),
    ("x.to(self.device)", "blocking .to(<device>)"),
    ("x.to(dev, torch.float32)", "blocking .to(<device>)"),
    ('x.to("cuda")', "blocking .to(<device>)"),
    ("x.cuda()", "blocking .cuda()"),
    ("torch.as_tensor(a, device=self.device)",
     "torch.as_tensor(..., device=)"),
    ('torch.tensor(a, device="cuda")', "torch.tensor(..., device=)"),
]
NOT_SYNCS = [
    "x.to(self.device, non_blocking=True)",
    'x.to("cuda", non_blocking=True)',
    "x.cuda(non_blocking=True)",
    "x.to(torch.float32)",
    "x.to(y.dtype)",
    "x.numpy()",
    "torch.as_tensor(a)",
    'torch.tensor(a, device="cpu")',
    "np.asarray(a)",
    "x.item(0)",
]


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    return str(p)


def _in(func: str, snippet: str) -> str:
    """GOOD_SRC with ``func``'s body replaced by ``snippet``."""
    body = {"_schedule": "return np.array([1, 2])",
            "_oracle": "return np.array([3])",
            "_retire": "return np.array([4])"}[func]
    return GOOD_SRC.replace(body, snippet)


def test_lint_fixture_clean(tmp_path):
    assert lint_files([_write(tmp_path, "good.py", GOOD_SRC)],
                      **FIXTURE_KW) == []


@pytest.mark.parametrize("snippet,kind", SYNCS, ids=[s for s, _ in SYNCS])
def test_sync_kind_fires_in_schedule(tmp_path, snippet, kind):
    vs = lint_files([_write(tmp_path, "bad.py", _in("_schedule", snippet))],
                    **FIXTURE_KW)
    assert [v.rule for v in vs] == ["hot-sync"]
    assert "Engine._schedule" in vs[0].message and kind in vs[0].message


@pytest.mark.parametrize("func", ["_retire", "_oracle"])
def test_sync_kinds_allowed_in_retire_and_oracle(tmp_path, func):
    body = "; ".join(s for s, _ in SYNCS)
    vs = lint_files([_write(tmp_path, "ok.py", _in(func, body))],
                    **FIXTURE_KW)
    assert vs == []


@pytest.mark.parametrize("snippet", NOT_SYNCS)
def test_not_a_sync(tmp_path, snippet):
    vs = lint_files([_write(tmp_path, "ok.py", _in("_schedule", snippet))],
                    **FIXTURE_KW)
    assert vs == []


def test_submit_phase_callee_fires(tmp_path):
    """A sync reached from the root through ``self.runner.*`` fires."""
    src = GOOD_SRC.replace(
        "    def fetch(self, h):\n",
        "    def upload(self, a):\n"
        "        return torch.from_numpy(a).to(self.device)\n\n"
        "    def fetch(self, h):\n").replace(
        "        self._schedule()\n",
        "        self._schedule()\n        self.runner.upload(None)\n")
    vs = lint_files([_write(tmp_path, "bad.py", src)], **FIXTURE_KW)
    assert [v.rule for v in vs] == ["hot-sync"]
    assert "ModelRunner.upload" in vs[0].message


def test_annotated_but_unlogged(tmp_path):
    src = GOOD_SRC.replace('        log_d2h([], 1, "int32", "step")\n', "")
    vs = lint_files([_write(tmp_path, "bad.py", src)], **FIXTURE_KW)
    assert [v.rule for v in vs] == ["sync-unlogged"]
    assert ".cpu()" in vs[0].message


def test_phase_table_honesty(tmp_path):
    kw = dict(FIXTURE_KW, retire={("Engine", "_retire"),
                                  ("Engine", "_gone_with_refactor")})
    vs = lint_files([_write(tmp_path, "good.py", GOOD_SRC)], **kw)
    assert [v.rule for v in vs] == ["phase-table"]
    assert "_gone_with_refactor" in vs[0].message


KERNEL = '''\
import torch

def wrapper_ref(x, active_slots):
    for s in active_slots.tolist():
        x = x + s
    return x.cpu()

def wrapper(x, active_slots):
    return active_slots.tolist()
'''


def test_kernels_checked_but_plain_versions_exempt(tmp_path):
    """Every kernels/ function is hot, reachable or not, except the
    ``*_ref`` plain versions, which run only on CPU tensors."""
    vs = lint_files([_write(tmp_path, "good.py", GOOD_SRC)],
                    kernel_paths=(_write(tmp_path, "k.py", KERNEL),),
                    **FIXTURE_KW)
    assert [v.rule for v in vs] == ["hot-sync"]
    assert "wrapper:" in vs[0].message and ".tolist()" in vs[0].message


def test_obs_clean_tracer_passes(tmp_path):
    obs = ("import time\n"
           "class Tracer:\n"
           "    def event(self, track, name):\n"
           "        t = time.perf_counter()\n"
           "        self.events.append((track, name, t))\n")
    vs = lint_files([_write(tmp_path, "good.py", GOOD_SRC)],
                    obs_paths=(_write(tmp_path, "tracer.py", obs),),
                    **FIXTURE_KW)
    assert vs == []


def test_obs_torch_and_sync_fire_without_annotation_escape(tmp_path):
    obs = ("import torch\n"
           "class Tracer:\n"
           "    def event(self, x):\n"
           "        v = torch.as_tensor(x)  # hotpath: sync-ok\n"
           "        n = v.item()  # hotpath: sync-ok\n"
           "        self.events.append(n)\n")
    vs = lint_files([_write(tmp_path, "good.py", GOOD_SRC)],
                    obs_paths=(_write(tmp_path, "tracer.py", obs),),
                    **FIXTURE_KW)
    assert sorted(v.rule for v in vs) == ["obs-sync", "obs-torch"]
    assert all("Tracer.event" in v.message for v in vs)


# ------------------------------------------------- B5: phase protocol
B5_KW = dict(roots=(("Engine", "step"),), retire=set(), oracle=set(),
             retire_only={("Engine", "_finish")}, attr_classes={})

B5_SRC = '''\
import numpy as np

class Engine:
    def step(self):
        self._schedule()
        self._finish()

    def _schedule(self):
        return np.array([1])

    def _finish(self):
        self.done = []
'''


def test_phase_retire_only_fires(tmp_path):
    vs = lint_files([_write(tmp_path, "b5.py", B5_SRC)], **B5_KW)
    assert [v.rule for v in vs] == ["phase-retire-only"]
    assert "_finish" in vs[0].message


def test_phase_annotation_sanctions(tmp_path):
    src = B5_SRC.replace(
        "        self._finish()\n",
        "        # phase: retire-ok (test fixture sanction)\n"
        "        self._finish()\n")
    assert lint_files([_write(tmp_path, "b5.py", src)], **B5_KW) == []


def test_phase_stale_annotation_fires(tmp_path):
    src = B5_SRC.replace(
        "        self._finish()\n",
        "        # phase: retire-ok (test fixture sanction)\n"
        "        self._finish()\n").replace(
        "        return np.array([1])\n",
        "        # phase: retire-ok (sanctions nothing)\n"
        "        return np.array([1])\n")
    vs = lint_files([_write(tmp_path, "b5.py", src)], **B5_KW)
    assert [v.rule for v in vs] == ["phase-stale"]


def test_retire_only_table_honesty(tmp_path):
    kw = dict(B5_KW, retire_only={("Engine", "_gone")})
    vs = lint_files([_write(tmp_path, "b5.py", B5_SRC)], **kw)
    assert [v.rule for v in vs] == ["phase-table"]
    assert "_gone" in vs[0].message


# ------------------------------------ Pass C: resource-lifecycle fixtures
def _lc(tmp_path, src, teardown=None):
    return check_files([_write(tmp_path, "fix.py", src)],
                       teardown=teardown if teardown is not None else {})


LC_ROLLBACK_LEAK = '''\
class Engine:
    def _try_admit(self, req):
        m = self.cache.match_and_acquire(req.prompt)
        n, kv_blocks, state_slot = m.n_tokens, m.kv_blocks, m.state_slot
        new_blocks = []
        try:
            for _ in range(3):
                new_blocks.append(self.kv_mgr.allocate())
        except OutOfBlocks:
            return False
        req.block_ids = kv_blocks + new_blocks
        return True
'''

LC_ROLLBACK_FIXED = '''\
class Engine:
    def _try_admit(self, req):
        m = self.cache.match_and_acquire(req.prompt)
        n, kv_blocks, state_slot = m.n_tokens, m.kv_blocks, m.state_slot
        new_blocks = []
        def bail():
            if self.kv_mgr is not None:
                self.kv_mgr.release_all(kv_blocks + new_blocks)
            if state_slot is not None:
                self.st_mgr.release(state_slot)
            return False
        try:
            for _ in range(3):
                new_blocks.append(self.kv_mgr.allocate())
        except OutOfBlocks:
            return bail()
        req.block_ids = kv_blocks + new_blocks
        if state_slot is not None:
            self.st_mgr.release(state_slot)
        return True
'''

LC_CLAIM_LEAK = '''\
class Engine:
    def _schedule_decodes(self):
        for r in self.running:
            claimed = []
            try:
                while r.needs_more():
                    claimed.append(self.kv_mgr.allocate())
            except OutOfBlocks:
                continue
            r.block_ids.extend(claimed)
'''

LC_CLAIM_FIXED = '''\
class Engine:
    def _schedule_decodes(self):
        ok = []
        for r in self.running:
            n_before = len(r.block_ids)
            try:
                while r.needs_more():
                    r.block_ids.append(self.kv_mgr.allocate())
            except OutOfBlocks:
                pass
            if r.still_needs():
                while len(r.block_ids) > n_before:
                    self.kv_mgr.release(r.block_ids.pop())
                continue
            ok.append(r)
        return ok
'''

LC_STAGING_LEAK = '''\
class AdapterPool:
    def prefetch(self, uid):
        reg = self._by_uid[uid]
        reg.device_layers = [self._put(lw) for lw in reg.layers]
        return True
'''

LC_STAGING_FIXED = '''\
class AdapterPool:
    def _stage(self, reg):
        reg.device_layers = [self._put(lw) for lw in reg.layers]
        self._staged[reg.uid] = self._tick
'''

LC_WINDOW_COLLAPSE = '''\
from itertools import islice
class Engine:
    def step(self):
        for uid in islice(self.pending,
                          self.max_running - len(self.running)):
            self.adapter_pool.prefetch(uid)
'''

LC_WINDOW_FIXED = '''\
from itertools import islice
class Engine:
    def step(self):
        for r in islice(self.waiting, self.ecfg.admission_window):
            self.adapter_pool.prefetch(r.adapter_uid)
'''

LC_PLAIN_LEAK = ('class Engine:\n'
                 '    def f(self):\n'
                 '        b = self.kv_mgr.allocate()\n'
                 '        if self.bad:\n'
                 '            return False\n'
                 '        self.kv_mgr.release(b)\n'
                 '        return True\n')

LC_ADAPTER_CLEAN = ('class Engine:\n'
                    '    def f(self, req):\n'
                    '        slot = self.adapter_pool.acquire(req.uid)\n'
                    '        if slot is None:\n'
                    '            return False\n'
                    '        req.adapter_slot = slot\n'
                    '        return True\n')
LC_ADAPTER_LEAK = LC_ADAPTER_CLEAN.replace(
    "        req.adapter_slot = slot\n",
    "        if req.too_big:\n"
    "            return False\n"
    "        req.adapter_slot = slot\n")

# (name, leaking source, fixed source, kind named in the message)
LC_CASES = [
    ("rollback", LC_ROLLBACK_LEAK, LC_ROLLBACK_FIXED, "kv"),
    ("claim", LC_CLAIM_LEAK, LC_CLAIM_FIXED, "kv"),
    ("staging", LC_STAGING_LEAK, LC_STAGING_FIXED, "staged"),
    ("early_return", LC_PLAIN_LEAK, None, "kv"),
    ("adapter_pin", LC_ADAPTER_LEAK, LC_ADAPTER_CLEAN, "adapter"),
]


@pytest.mark.parametrize("name,leak,fixed,kind", LC_CASES,
                         ids=[c[0] for c in LC_CASES])
def test_lc_leak_and_fix(tmp_path, name, leak, fixed, kind):
    vs = _lc(tmp_path, leak)
    assert vs and set(v.rule for v in vs) == {"leak"}
    assert any(kind in v.message for v in vs)
    if fixed is not None:
        assert _lc(tmp_path, fixed) == []


def test_lc_window_collapse_and_fix(tmp_path):
    vs = _lc(tmp_path, LC_WINDOW_COLLAPSE)
    assert [v.rule for v in vs] == ["window-collapse"]
    assert _lc(tmp_path, LC_WINDOW_FIXED) == []


def test_lc_owner_annotation_and_honesty(tmp_path):
    ann = ('class Engine:\n'
           '    def f(self):\n'
           '        b = self.kv_mgr.allocate()   # owner: self._ledger\n'
           '        self._ledger.note(b)\n')
    assert _lc(tmp_path, ann) == []
    stale = ('class Engine:\n'
             '    # owner: nothing acquired here\n'
             '    def f(self):\n'
             '        return 1\n')
    vs = _lc(tmp_path, stale)
    assert [v.rule for v in vs] == ["owner-unused"]


ENCDEC_ADMIT = '''\
class Engine:
    def _try_admit(self, req):
        if not self._free_slots:
            return False
        slot = self._free_slots.pop()
        self.runner.encode(req.frame_embeds, slot)
        req.run_slot = slot
        return True
'''
ENCDEC_ADMIT_LEAK = ENCDEC_ADMIT.replace(
    "        req.run_slot = slot\n",
    "        if req.too_long:\n"
    "            return False\n"
    "        req.run_slot = slot\n")


def test_lc_encdec_admission_leaks_the_run_slot(tmp_path):
    """``encode`` writes into the run slot's encoder pools and acquires
    nothing; the run slot itself is still tracked on every exit."""
    assert _lc(tmp_path, ENCDEC_ADMIT) == []
    vs = _lc(tmp_path, ENCDEC_ADMIT_LEAK)
    assert [v.rule for v in vs] == ["leak"]
    assert "runslot" in vs[0].message and "xkv" not in vs[0].message


TEARDOWN = '''\
class Engine:
    def _preempt(self, r):
        self.kv_mgr.release_all(r.block_ids)
        self._free_slots.append(r.run_slot)
        self.adapter_pool.release(r.adapter_uid)

    def _finish_requests(self):
        for r in self.running:
            self.kv_mgr.release_all(r.block_ids)
            self._free_slots.append(r.run_slot)
            self.adapter_pool.release(r.adapter_uid)
'''


def test_lc_teardown_has_no_xkv_kind(tmp_path):
    """The port's teardown table asks for kv, runslot and adapter (the
    encoder K/V go back with the run slot); dropping one still fires,
    and a stale entry is itself a violation."""
    assert check_files([_write(tmp_path, "t.py", TEARDOWN)]) == []
    vs = check_files([_write(tmp_path, "t.py", TEARDOWN.replace(
        "        self._free_slots.append(r.run_slot)\n"
        "        self.adapter_pool", "        self.adapter_pool"))])
    assert [v.rule for v in vs] == ["teardown-missing"]
    assert "_preempt" in vs[0].message and "runslot" in vs[0].message
    vs = _lc(tmp_path, TEARDOWN, teardown={("Engine", "_gone"):
                                           frozenset({"kv"})})
    assert [v.rule for v in vs] == ["lifecycle-table"]


# ------------------------------------------------------- the real tree
def test_real_tree_lints_clean():
    assert lint_tree(SRC_ROOT) == []


def test_sharded_step_collectives_in_scope(tmp_path):
    """The sharded step's collectives (``distributed/parallel.py``) are
    on the hot graph: a host sync in one the runner reaches fails."""
    shutil.copytree(os.path.join(SRC_ROOT, "repro_torch"),
                    tmp_path / "repro_torch",
                    ignore=shutil.ignore_patterns("csrc", "__pycache__"))
    path = tmp_path / "repro_torch" / "distributed" / "parallel.py"
    src = path.read_text()
    for fn, sync in (
            ("def gather_rows(self, x: torch.Tensor) -> torch.Tensor:",
             "x.cpu()"),
            ("def reduce(self, y: torch.Tensor, part: str) -> torch.Tensor:",
             "y.sum().item()")):
        assert fn in src
        src = src.replace(fn, f"{fn}\n        {sync}")
    path.write_text(src)
    vs = lint_tree(str(tmp_path))
    assert {v.message.split(":")[0] for v in vs} >= {
        "TensorParallel.gather_rows", "TensorParallel.reduce"}


def test_real_tree_lifecycle_clean():
    assert check_tree(SRC_ROOT) == []


def test_real_tree_tables_name_port_functions():
    """Every phase-table entry names a function of the scanned port."""
    pkg = os.path.join(SRC_ROOT, "repro_torch")
    funcs = HL._index_functions(
        HL._py_files(os.path.join(pkg, "serving"))
        + HL._py_files(os.path.join(pkg, "obs"), HL.OBS_EXPORT_FILES))
    for table in (HL.RETIRE_PHASE, HL.SEQUENTIAL_ORACLE, HL.RETIRE_ONLY,
                  set(HL.ROOTS)):
        assert table and all(entry in funcs for entry in table)


# ---------------------------------------------------------------- CLI
def test_cli_clean_tree_exit0(tmp_path, capsys):
    (tmp_path / "analysis_lifecycle.txt").write_text("stale\n")
    assert main(["--json", "--out", str(tmp_path)]) == 0
    assert "[lint] 0 violation(s)" in capsys.readouterr().out
    with open(tmp_path / "analysis_audit.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["kind"] for r in recs] == ["hotpath_lint", "lifecycle_check"]
    assert all(r["ok"] and r["n_violations"] == 0 for r in recs)
    assert not (tmp_path / "analysis_lifecycle.txt").exists()


def test_cli_fixture_exit1(tmp_path, capsys):
    bad = _write(tmp_path, "leak.py", LC_PLAIN_LEAK)
    assert main(["--out", str(tmp_path), "--lint-paths", bad]) == 1
    err = capsys.readouterr().err
    # the fixture defines none of the default tables' functions
    assert "leak" in err and "phase-table" in err
    assert "leak" in (tmp_path / "analysis_lifecycle.txt").read_text()


# ---------------------------------------------------------------- C2
def test_encode_uploads_from_the_pinned_pool_without_waiting(monkeypatch):
    """C2: ``encode`` stages the frames in the runner's host pool (pinned
    on a card) and uploads with ``non_blocking=True``; the encoder K/V it
    writes equal the encoder's on the frames themselves."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.serving.runner import ModelRunner, RunnerConfig
    cfg = get_reduced("whisper-large-v3")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg, device="cpu")
    runner = ModelRunner(cfg, params, RunnerConfig(max_running=3),
                         device="cpu")
    assert runner.host_bufs.pin is False      # pinned exactly on a card
    frames = np.random.RandomState(0).randn(
        cfg.encoder_seq_len, cfg.d_model).astype(np.float32)
    calls = []
    orig = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if args and isinstance(args[0], (torch.device, str)):
            calls.append((self.data_ptr(), kwargs))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    runner.encode(frames, 1)
    monkeypatch.setattr(torch.Tensor, "to", orig)
    buf = runner.host_bufs.take("frames1", cfg.encoder_seq_len, np.float32,
                                trailing=(cfg.d_model,), fill=None)
    assert calls == [(buf.ctypes.data, {"non_blocking": True})]
    np.testing.assert_array_equal(buf, frames)
    with torch.no_grad():
        enc = M.run_encoder(runner.params["encoder"], cfg,
                            torch.from_numpy(frames)[None])
        for ai, (_, lp) in enumerate(M.iter_layers(runner.params, cfg)):
            xk, xv = M.encoder_kv(lp, cfg, enc)
            assert torch.equal(runner.xk_pool[ai, 1], xk[0].transpose(0, 1))
            assert torch.equal(runner.xv_pool[ai, 1], xv[0].transpose(0, 1))
