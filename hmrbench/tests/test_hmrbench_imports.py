"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level module name; the reference loads nothing of the port."""
import ast
import json
import subprocess
import sys

from hmrbench.lib import common

PROBE = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import tiny_cells
from hmrbench.lib import common
tiny_cells.run({cell!r})
print(json.dumps(common.forbidden_modules()))
"""


def test_forbidden_names_are_whole_top_level_names():
    assert common.forbidden_modules(["egohmr_tpu_torch", "egohmr_tpu_torch.models"]) == []
    assert common.forbidden_modules(["egohmr_tpu.models", "jaxlib.xla_client", "flaxen"]) \
        == ["egohmr_tpu", "jaxlib"]


def test_a_run_loads_no_jax():
    for cell in ("egohmr-ddim5-bulk", "prohmr-flow"):
        out = subprocess.run([sys.executable, "-c", PROBE.format(
            root=str(common.ROOT), tests=str(common.BENCH / "tests"), cell=cell)],
            capture_output=True, text=True, timeout=600, check=True).stdout
        assert json.loads(out.strip().splitlines()[-1]) == []


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_port():
    files = sorted((common.BENCH / "reference").glob("*.py"))
    assert len(files) >= 3
    for f in files:
        assert not imported_tops(f) & {common.PROGRAM_MODULE, *common.FORBIDDEN_MODULES}, f
    probe = ("import sys; sys.path.insert(0, {root!r}); from pathlib import Path; "
             "from hmrbench.lib import common; "
             "[common.load_file(p) for p in sorted(Path({ref!r}).glob('*.py'))]; "
             "import json; print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))"
             ).format(
        root=str(common.ROOT), ref=str(common.BENCH / "reference"))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & {common.PROGRAM_MODULE, *common.FORBIDDEN_MODULES}
