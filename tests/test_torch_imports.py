"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and importing every module
of the port leaves JAX unloaded.  Also the kernel build's plumbing, which the
CPU can check without ``nvcc``."""
import ast
import ctypes
import os
import re
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


def test_library_name_keys_on_the_headers_the_source_includes(tmp_path,
                                                             monkeypatch):
    """An edited ``csrc/*.cuh`` that a source includes (directly or through
    another header) renames its library, so no stale build loads; a header
    it does not include leaves the name as it is."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = {n: _build.library_path(n) for n in _build.KERNELS}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in _build.KERNELS:
        includes = '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()
        assert (_build.library_path(name) != names[name]) == includes, name
    assert {n for n in _build.KERNELS if _build.library_path(n) != names[n]} \
        == {"flash_attention", "flash_attention_bwd", "matmul_fused",
            "moe_gmm", "moe_gmm_bwd"}
    (csrc / "k.cu").write_text('#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// one\n")
    (csrc / "c.cuh").write_text("// one\n")
    first = _build.library_path("k")
    (csrc / "c.cuh").write_text("// two\n")
    assert _build.library_path("k") == first
    (csrc / "b.cuh").write_text("// two\n")
    assert _build.library_path("k") != first


@pytest.mark.parametrize("kernel,symbol", [
    ("flash_attention", "repro_flash_attention_wgmma"),
    ("flash_attention_bwd", "repro_flash_attention_bwd_wgmma"),
    ("moe_gmm", "repro_moe_gmm_wgmma"),
    ("matmul_fused", "repro_matmul_fused_wgmma")])
def test_wgmma_route_symbol_matches_its_binding(kernel, symbol):
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    assert f'extern "C" int {symbol}(' in src
    assert '#include "hopper.cuh"' in src
    wrapper = {"flash_attention": "attention",
               "flash_attention_bwd": "attention"}.get(kernel, kernel)
    binding = (PORT / "kernels" / f"{wrapper}.py").read_text()
    assert f".{symbol}" in binding


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


def test_q8_kernel_symbol_matches_its_binding():
    src = (_build.CSRC / "conv2d_q8.cu").read_text()
    assert 'extern "C" int repro_conv2d_q8(' in src
    # the s8 product K3 compiles: its source and the headers it includes
    # (the instruction lives in csrc/q8_mma.cuh, shared with K10c)
    built = "".join(path.read_text() for path in
                    _build._sources(_build.CSRC / "conv2d_q8.cu", []))
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in built
    binding = (PORT / "kernels" / "conv2d_q8.py").read_text()
    assert ".repro_conv2d_q8" in binding
    assert "conv2d_q8" in _build.KERNELS


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


def test_streams_kernel_symbol_and_argtypes(monkeypatch):
    """K4's ctypes binding: one argtype per parameter of the C function,
    pointers as c_void_p and ints as c_int, and the kernel's tile switch
    lists the tiles the wrapper chooses from."""
    from repro_torch.kernels import conv2d_streams as k4
    src = (_build.CSRC / "conv2d_streams.cu").read_text()
    sig = re.search(r'extern "C" int repro_conv2d_streams_f32\((.*?)\)\s*\{',
                    src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]

    class Fn:
        argtypes = restype = None

    class Lib:
        repro_conv2d_streams_f32 = Fn()

    monkeypatch.setattr(_build, "load", lambda name: {
        "conv2d_streams": Lib()}[name])
    monkeypatch.setattr(k4, "_fn", None)
    fn = k4._kernel_fn()
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params) == 22
    for ty, param in zip(fn.argtypes, params):
        assert ty is (ctypes.c_void_p if "*" in param else ctypes.c_int), \
            param
    tiles = re.findall(r"launch<(\d+), (\d+), (\d+), (\d+)>\(a, runs, st\)",
                       src)
    assert [tuple(map(int, t)) for t in tiles] == list(k4.TILES)
    assert "conv2d_streams" in _build.KERNELS


@pytest.mark.parametrize("name,symbol,module", [
    ("flash_attention", "repro_flash_attention", "attention"),
    ("matmul_fused", "repro_matmul_fused", "matmul_fused"),
    ("conv1d_causal", "repro_conv1d_causal", "conv1d_causal"),
    ("moe_gmm", "repro_moe_gmm", "moe_gmm")])
def test_lm_kernel_symbols_and_argtypes(monkeypatch, name, symbol, module):
    """K7's, K6's, K8's and K9's ctypes bindings: one argtype per parameter of the
    C function, pointers as c_void_p, floats as c_float, 64-bit ints as
    c_longlong, ints as c_int."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]

    class Fn:
        argtypes = restype = None

    monkeypatch.setattr(_build, "load", lambda n: {
        name: type("Lib", (), {symbol: Fn()})()}[n])
    monkeypatch.setattr(mod, "_fn", None)
    fn = mod._kernel_fn()
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params)
    for ty, param in zip(fn.argtypes, params):
        want = (ctypes.c_void_p if "*" in param else
                ctypes.c_float if param.startswith("float") else
                ctypes.c_longlong if param.startswith("long long") else
                ctypes.c_int)
        assert ty is want, param
    assert name in _build.KERNELS


def test_moe_gmm_kernel_uses_the_bf16_tensor_cores():
    """K9's bf16 instance multiplies with mma.sync bf16 -> f32, reads its B
    fragments by ldmatrix.trans from the (D, F) weights, and picks its block
    height from the heights the wrapper names.  The source is read with the
    headers it includes (the helpers live in ``csrc/mma_bf16.cuh``)."""
    from repro_torch.kernels import moe_gmm as k9
    src = "".join(p.read_text() for p in _build._sources(
        _build.CSRC / "moe_gmm.cu", []))
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    heights = [int(h) for h in re.findall(r"bm % (\d+) == 0", src)]
    assert heights == [128, 64, 128, 64]
    assert k9.BLOCK_ROWS == (128, 64, 16)
