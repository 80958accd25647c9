"""What the harness and the reference load, in a fresh process: no module
of JAX or of the JAX package gi_gs_tpu (compared by whole top-level
name: gi_gs_tpu_torch is not gi_gs_tpu), and the reference nothing of the
program either."""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "gi_gs_tpu"}


def _top_level_modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level_modules(
        "import runpy, sys; sys.argv = ['run.py']\n"
        "sys.path.insert(0, '.')\n"
        "import perfbench.run, perfbench.runner, perfbench.control, "
        "perfbench.faults\n"
        "from perfbench import cells, sides\n"
        "for m in cells.benchmark()['per_layer']:\n"
        "    cells.metric_reader(m['name'])\n"
        "sides.Side(sides.PROGRAM); sides.Side(sides.REFERENCE)")
    assert not mods & FORBIDDEN
    assert "gi_gs_tpu_torch" in mods          # the program itself


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench.sides import Side, REFERENCE\n"
        "Side(REFERENCE)\n"
        "import perfbench.reference.plain.cli.render_cli")
    assert not mods & (FORBIDDEN | {"gi_gs_tpu_torch"})
