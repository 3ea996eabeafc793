"""No module of the benchmark imports JAX, Flax or the JAX package
(``repro``), compared by whole top-level name (``repro_torch`` is not
``repro``); the references, each model family's among them, import
nothing of the program either."""
from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(top_level_imports(f) & FORBIDDEN)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = top_level_imports(f)
        assert not names & (FORBIDDEN | {"repro_torch"}), (f, names)


def module_imports(path: Path):
    """Every module a file imports, by its full dotted name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_every_family_is_scanned_and_its_reference_is_plain():
    """Each model family (``families/<name>.py``, scanned above) has its
    reference beside the others (``reference/<name>.py``), and every file
    there imports plain PyTorch, NumPy and the references' shared code
    alone: nothing of the program, directly or through another module of
    the benchmark."""
    scanned = set(BENCH.rglob("*.py"))
    families = sorted((BENCH / "families").glob("*.py"))
    assert BENCH / "families" / "stack.py" in families
    assert set(families) <= scanned
    plain = {"__future__", "math", "typing", "dataclasses", "torch",
             "numpy"}
    for fam in families:
        assert (BENCH / "reference" / fam.name).is_file(), fam
    for ref in sorted((BENCH / "reference").glob("*.py")):
        for name in module_imports(ref):
            assert name.split(".")[0] in plain \
                or name.startswith("alora_bench.reference"), (ref, name)


def test_the_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.serving\nfrom jaxtyping import X\n"
                 "import importlib\nimportlib.import_module('repro.core')\n")
    assert top_level_imports(p) & FORBIDDEN == {"repro"}
