"""The benchmark on a card: one short run of a cell, correct. Marked
`cuda`; without a card it skips (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs the port's kernels")


def test_short_run_is_correct(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "zkevm16.verify.b8", "--seed", "3141592653",
                          "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "gpu"
