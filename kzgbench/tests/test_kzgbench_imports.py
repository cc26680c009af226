"""No process the benchmark starts loads JAX or the JAX package, and the
reference loads nothing of the program. Each check runs in a fresh
interpreter and compares top-level module names whole."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_levels(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_levels("import kzgbench.run, kzgbench.harness, kzgbench.system, "
                        "kzgbench.control, kzgbench.faults, kzgbench.traffic.open, "
                        "kzgbench.traffic.verify\n"
                        "from kzgbench.system import Port\n"
                        "import torch\n"
                        "Port(torch.device('cpu'), '.')")
    assert "kzgbench" in names and "kzg_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "kzg_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_levels("import kzgbench.reference.bls, kzgbench.reference.fr, "
                        "kzgbench.reference.judge, kzgbench.reference.system")
    assert not names & {"kzg_tpu_torch", "kzg_tpu", "jax"}


def test_reference_sources_import_only_torch_and_itself():
    for path in glob.glob(os.path.join(ROOT, "kzgbench", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert tops <= {"torch", "numpy", "math"}, (path, tops)


def test_run_refuses_without_a_card():
    """On a host without a card the command exits 2 and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, "-m", "kzgbench.run", "--workload",
                          "eip4844_blob.verify", "--seed", str(2**40), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout.strip() == ""
