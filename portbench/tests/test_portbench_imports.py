"""The reference imports nothing of the port, of JAX or of the JAX
package; nothing the benchmark runs imports JAX or the JAX package."""

import ast
import subprocess
import sys

from portbench import harness

FORBIDDEN_REF = ("kaolin_tpu_torch", "kaolin_tpu", "jax", "jaxlib", "flax")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_reference_and_roofline_import_nothing_of_the_port():
    for sub in ("reference", "roofline"):
        for path in (harness.PKG / sub).glob("*.py"):
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(FORBIDDEN_REF), (path, tops)
            # what they import of the benchmark is the yardstick itself
            for m in _imports(path):
                if m.startswith("portbench"):
                    assert m.split(".")[1] in ("reference", "roofline"), \
                        (path, m)


def test_no_source_of_the_benchmark_imports_jax():
    for path in harness.PKG.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.JAX_NAMES), (path, tops)


def test_reference_loads_without_the_port():
    code = ("import sys; import portbench.reference.dibr_fit, "
            "portbench.roofline.dibr; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN_REF!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_whole_top_level_names():
    """``kaolin_tpu_torch`` begins with ``kaolin_tpu`` but is not it."""
    saved = dict(sys.modules)
    try:
        sys.modules["kaolin_tpu_torch_fake.x"] = sys
        assert "kaolin_tpu_torch_fake.x" not in harness.jax_loaded()
        sys.modules["kaolin_tpu.fake"] = sys
        assert "kaolin_tpu.fake" in harness.jax_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
