"""No module of the benchmark loads JAX, its libraries or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's and must not trip it); the references load nothing of the
program."""
import json
import subprocess
import sys

from perfbench.tests import tiny

SCRIPT = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
import importlib
from perfbench import harness
bench = Path({bench!r})
mods = []
for p in sorted(bench.rglob("*.py")):
    if "tests" in p.parts:
        continue
    rel = p.relative_to(bench.parent).with_suffix("")
    if p.parent.name in ("metrics", "traffic", "reference"):
        harness.load_module(p)
    else:
        importlib.import_module(".".join(rel.parts))
    mods.append(str(rel))
if {touch_port}:
    import repro_torch.serve.engine, repro_torch.train.trainer
print(json.dumps({{"loaded": len(mods), "names": sorted(sys.modules)}}))
"""


def _loaded(touch_port: bool, only_reference: bool = False):
    bench = tiny.BENCH / "reference" if only_reference else tiny.BENCH
    code = SCRIPT.format(root=str(tiny.ROOT), src=str(tiny.ROOT / "src"),
                         bench=str(bench), touch_port=touch_port)
    if only_reference:
        code = code.replace('bench.parent', 'bench.parents[1]')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_loads_jax_or_the_jax_package():
    got = _loaded(touch_port=True)
    assert got["loaded"] > 20
    tops = {n.split(".", 1)[0] for n in got["names"]}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    assert "repro_torch" in tops      # the port is loaded, and passes


def test_the_references_load_nothing_of_the_program():
    got = _loaded(touch_port=False, only_reference=True)
    tops = {n.split(".", 1)[0] for n in got["names"]}
    assert "repro_torch" not in tops and "repro" not in tops
