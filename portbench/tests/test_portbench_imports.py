"""No module of the benchmark imports JAX or the JAX package, and no module
of the reference (nor the traffic generator and the trace arithmetic it
shares) imports the program under test. Module names are compared whole, before the first dot: the
port's name starts with the JAX package's."""

import ast
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "mloam_tpu"}
PROGRAM = "mloam_tpu_torch"


def _imports(path, strings=True):
    """Top-level names of the modules ``path`` imports, and (``strings``)
    of the dotted module paths it names in string constants, which the
    runners hand to ``importlib``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
        elif strings and isinstance(node, ast.Constant) and isinstance(node.value, str):
            # dotted module paths handed to importlib
            v = node.value
            if v.replace(".", "").replace("_", "").isalnum() and "." in v:
                out.add(v.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for p in harness.PKG.rglob("*.py"):
        # the tests name the forbidden modules as data; their imports count
        assert not (_imports(p, strings="tests" not in p.parts) & FORBIDDEN), p


def test_reference_and_generators_import_nothing_of_the_program():
    ref = list((harness.PKG / "ref").rglob("*.py")) + [harness.PKG / "gen.py",
                                                       harness.PKG / "trace.py"]
    for p in ref:
        assert PROGRAM not in _imports(p), p


def test_loading_the_reference_loads_no_program_or_jax_module():
    code = ("import sys, portbench.ref.pgo, portbench.gen, portbench.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(FORBIDDEN | {PROGRAM})!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout.strip()
    assert out == "[]"


def test_the_check_compares_whole_names():
    assert harness.loaded_forbidden(["mloam_tpu_torch", "mloam_tpu_torch.ops.knn",
                                     "numpy", "jaxtyping"]) == []
    assert harness.loaded_forbidden(["mloam_tpu.ops", "jax._src.core", "flax",
                                     "jaxlib"]) == ["flax", "jax", "jaxlib", "mloam_tpu"]
