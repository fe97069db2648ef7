"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level module name: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "basd_tpu"]

# import the named modules with the forbidden top-level names blocked,
# then report every top-level name that got loaded
PROBE = """
import importlib, json, sys
blocked = set(json.loads(sys.argv[1]))
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for mod in json.loads(sys.argv[2]):
    importlib.import_module(mod)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def harness_modules() -> list[str]:
    mods = []
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or rel.name == "__init__":
            continue
        mods.append(".".join(rel.parts))
    return mods


def loaded(blocked: list[str], modules: list[str]) -> set[str]:
    out = subprocess.run([sys.executable, "-c", PROBE, json.dumps(blocked), json.dumps(modules)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_imports_no_jax():
    names = loaded(FORBIDDEN, harness_modules())
    assert "basd_tpu_torch" in names and "benchmark" in names
    assert not names & set(FORBIDDEN)


@pytest.mark.parametrize("module", [m for m in harness_modules()
                                    if m.startswith("benchmark.reference")])
def test_the_reference_imports_nothing_of_the_port(module):
    names = loaded(FORBIDDEN + ["basd_tpu_torch"], [module])
    assert not names & set(FORBIDDEN + ["basd_tpu_torch"])
