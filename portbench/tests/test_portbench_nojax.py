"""No run may load JAX or the JAX package; the check compares whole
top-level names. The reference imports nothing of the program."""

import subprocess
import sys

from portbench import harness


def test_whole_top_level_names():
    mods = ["jax.numpy", "halo2_snark_aggregator_tpu.ops", "flax",
            "halo2_snark_aggregator_tpu_torch.ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "flax", "halo2_snark_aggregator_tpu", "jax"]
    assert harness.forbidden_modules(["halo2_snark_aggregator_tpu_torch",
                                      "jaxlib_extra"]) == []


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=120)


def test_reference_imports_nothing_of_the_program():
    out = _run("import sys; import portbench.reference.check, portbench.faults;"
               "print(sorted({m.split('.')[0] for m in sys.modules} & "
               "{'torch', 'jax', 'halo2_snark_aggregator_tpu', "
               "'halo2_snark_aggregator_tpu_torch'}))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "zkevm16.verify.b8", "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
