"""A process's first CPU call of the port's math gives the bits of its
later calls. PyTorch's CPU exp, log and sqrt call MKL's vector math, and
in a fresh process its first call that PyTorch splits across OpenMP
threads can compute the worker threads' chunks at lower accuracy (about
one process in ten; `tools/parity_processes.py` saw the scales of the
first CPU render move). Importing the package sets MKL up first
(gi_gs_tpu_torch/__init__.py)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 32
AT_ONCE = 8
# The first op after the import is the scales' f64 exp over 8 chunks of
# 2048 values (2048 is PyTorch's grain for these ops), then the f32 exp,
# log and sqrt on their first calls; each against its second call.
CODE = r"""
import types
import numpy as np
import torch
torch.set_num_threads(8)
from gi_gs_tpu_torch.models.gaussians import GaussianParams
x = torch.as_tensor(np.random.RandomState({seed}).uniform(
    -6.0, -1.0, (16384 // 3 + 1, 3)).astype(np.float32))
p = types.SimpleNamespace(scaling=x)
first = [GaussianParams.get_scaling(p)]
first += [f(x.abs().reshape(-1)) for f in (torch.exp, torch.log, torch.sqrt)]
again = [GaussianParams.get_scaling(p)]
again += [f(x.abs().reshape(-1)) for f in (torch.exp, torch.log, torch.sqrt)]
print(sum(int((a != b).sum()) for a, b in zip(first, again)))
"""


def test_first_call_in_fresh_processes_matches_later_calls():
    """`GaussianParams.get_scaling` (and exp, log, sqrt after it) in
    PROCESSES fresh interpreters, AT_ONCE at a time: the first call equals
    the second bit for bit in every process. Without the set-up on import
    about one process in ten moved."""
    moved = []
    for start in range(0, PROCESSES, AT_ONCE):
        procs = [subprocess.Popen(
            [sys.executable, "-c", CODE.format(seed=seed)], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for seed in range(start, start + AT_ONCE)]
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            moved.append(int(out.split()[-1]))
    assert moved == [0] * PROCESSES, moved
