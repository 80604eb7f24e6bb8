"""The PyTorch/CUDA port stands alone: no module of llama_box_tpu_torch and
not chip_smoke.py imports JAX or anything of the JAX package, neither in
its source (an AST scan of every import) nor at run time (every module
imported in a fresh interpreter, then sys.modules inspected)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "llama_box_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    names = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names + ["chip_smoke"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "llama_box_tpu" or name.startswith("llama_box_tpu."))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'llama_box_tpu' or "
        "m.startswith('llama_box_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_grammar_core_is_the_ports_own_copy():
    """The port builds its grammar core from its own source and never
    reaches for the JAX package's native library or its switch."""
    from llama_box_tpu_torch.gguf import native
    assert native.SRC.resolve().is_relative_to(PORT)
    bad = [str(p.relative_to(ROOT)) for p in SOURCES
           if any(w in p.read_text() for w in ("libgguf_kernels",
                                               "LLAMA_BOX_TPU_NO_NATIVE"))]
    assert not bad, bad


def test_multimodal_modules_are_covered():
    """The multimodal modules (the towers, the pipeline, the mp3 binding)
    are among the modules both checks above scan and import, and the
    pipeline decodes images through Pillow, imported where an image is
    decoded, never at import."""
    names = _module_names()
    for mod in ("llama_box_tpu_torch.models.clip",
                "llama_box_tpu_torch.models.audio",
                "llama_box_tpu_torch.server.multimodal",
                "llama_box_tpu_torch.utils.mp3"):
        assert mod in names
    code = ("import sys\n"
            "import llama_box_tpu_torch.server.multimodal, "
            "llama_box_tpu_torch.models.clip, "
            "llama_box_tpu_torch.models.audio, llama_box_tpu_torch.cli\n"
            "assert 'PIL' not in sys.modules, 'Pillow at import'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
