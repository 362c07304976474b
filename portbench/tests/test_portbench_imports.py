"""Nothing the benchmark runs imports JAX, the JAX package or the repo's
other scripts (top-level names compared whole: the port's name begins
with the JAX package's), and the reference imports nothing of the
port."""

import subprocess
import sys

from portbench import cell

BLOCK = '''
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "rappas_tpu", "bench", "chip_smoke",
           "scripts")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
'''


def _run(code: str):
    r = subprocess.run([sys.executable, "-c", BLOCK % str(cell.ROOT) + code],
                       capture_output=True, text=True, timeout=600,
                       cwd=cell.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_harness_runs_with_jax_blocked():
    out = _run('''
import json, tempfile, time
from pathlib import Path
import portbench.run, portbench.readings, portbench.trace, portbench.roofline
from portbench import cell
from portbench.tests import tiny
for p in sorted((cell.HERE / "recipes").glob("*.py")) + \\
        sorted((cell.HERE / "metrics").glob("*.py")):
    cell.load_module(p, "m_" + p.stem.replace(".", "_"))
with tempfile.TemporaryDirectory() as wd:
    out = tiny.run("c1-16s-k8.miseq240", Path(wd))
print(json.dumps(portbench.run.forbidden_modules()),
      out["numbers"]["calls_checked"])
''')
    assert out.split()[-2] == "[]" and int(out.split()[-1]) >= 1


def test_reference_imports_nothing_of_the_port():
    out = _run('''
import portbench.reference, portbench.roofline, portbench.traffic
print(sorted(m for m in sys.modules if m.split(".")[0] == "rappas_tpu_torch"))
''')
    assert out.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "rappas_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "rappas_tpu_torch_extra" not in run.forbidden_modules()
    assert "jaxtyping" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rappas_tpu.place", sys)
    assert "rappas_tpu.place" in run.forbidden_modules()
