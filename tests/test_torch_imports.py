"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and importing every module
of the port leaves JAX unloaded.  Also the kernel build's plumbing, which the
CPU can check without ``nvcc``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_importing_the_port_leaves_jax_unloaded():
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m.removesuffix(".__init__") for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_targets_hopper_and_keys_on_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command("conv2d_direct", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/conv2d_direct.cu")
    assert (_build.CSRC / "conv2d_direct.cu").is_file()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR


def test_kernel_symbol_matches_its_binding():
    src = (_build.CSRC / "conv2d_direct.cu").read_text()
    assert 'extern "C" int repro_conv2d_direct_f32(' in src
    binding = (PORT / "kernels" / "conv2d_direct.py").read_text()
    assert ".repro_conv2d_direct_f32" in binding


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_wu_kernel_symbol_matches_its_binding():
    src = (_build.CSRC / "conv2d_wu.cu").read_text()
    assert 'extern "C" int repro_conv2d_wu_f32(' in src
    binding = (PORT / "kernels" / "conv2d_wu.py").read_text()
    assert ".repro_conv2d_wu_f32" in binding
    assert set(_build.KERNELS) == {p.stem for p in _build.CSRC.glob("*.cu")}


def test_build_all_starts_every_compiler_before_waiting(tmp_path,
                                                         monkeypatch):
    """One nvcc per source, all started before the first is waited on;
    a failed build raises with its log after every compiler exited."""
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    for name in ("a", "b"):
        (tmp_path / "csrc" / f"{name}.cu").write_text(f"// {name}")
    events = []

    class FakeProc:
        def __init__(self, cmd, stdout, stderr):
            self.out = pathlib.Path(cmd[cmd.index("-o") + 1])
            self.name = pathlib.Path(cmd[-1]).stem
            events.append(("start", self.name))

        def wait(self):
            events.append(("wait", self.name))
            if self.name == "b":
                return 1
            self.out.write_text("lib")
            return 0

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    with pytest.raises(RuntimeError, match="kernel build failed: b"):
        _build.build_all(("a", "b"))
    assert events == [("start", "a"), ("start", "b"), ("wait", "a"),
                      ("wait", "b")]
    assert _build.library_path("a").exists()
    assert not _build.library_path("b").exists()
    assert _build.build_all(("a",)) == {"a": 0.0}
