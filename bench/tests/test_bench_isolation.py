"""What the harness and the reference load: no JAX and not the JAX
package (``repro``), compared by whole top-level names, in a process of
their own; the reference imports nothing of the program; nothing under
the benchmark reads the JAX package's benchmarks or the smoke script."""
import ast
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_sources():
    for path in BENCH.rglob("*.py"):
        mods = set(_imports(path))
        assert not mods & FORBIDDEN, (path, mods & FORBIDDEN)
        if path.parent.name == "lgcref":
            assert not mods & {"repro_torch", "lgcbench"}, path
        text = path.read_text()
        for name in ("chip_" + "smoke", "bench" + "marks/"):
            assert name not in text, (path, name)


def test_a_run_loads_no_jax():
    code = f"""
import sys, time
import torch
torch.set_num_threads(1)
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]
from conftest import TINY, SMALL_TRAFFIC
sys.argv = ["run.py"]
import runpy
run_mod = runpy.run_path({str(BENCH / 'run.py')!r}, run_name="bench_run")
from lgcbench.runner import run
run("granite8b.lgc_rar.compressed", 7, 0.0, False, "cpu", time.time(),
    TINY["dense_decoder"], dict(SMALL_TRAFFIC, setup_steps=3))
print(run_mod["forbidden_modules"]())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
