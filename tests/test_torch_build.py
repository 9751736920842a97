"""The kernel build cache and launch counters, without a card: ``nvcc`` is
replaced by a stand-in script that copies its source to its output, so the
bookkeeping (content-addressed names, one compile per source, parallel
jobs, failures reported with the compiler's output) runs on the CPU."""

import stat

import pytest
import torch

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *.cu) src="$1"; shift;; *) shift;; esac
done
echo "$src" >> "$(dirname "$0")/calls"
if grep -q BROKEN "$src"; then echo "error: cannot compile"; exit 1; fi
cp "$src" "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return bin_dir / "calls"


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


def test_sources_compile_once_each_and_are_content_addressed(fake_toolkit):
    paths = _build.build([("a", "int a;"), ("b", "int b;"), ("a", "int a;")])
    assert paths[0] == paths[2] != paths[1]
    assert all(p.exists() and p.read_text().startswith("int") for p in paths)
    assert len(_calls(fake_toolkit)) == 2
    _build.build([("a", "int a;")])
    assert len(_calls(fake_toolkit)) == 2  # cached: no second compile
    assert _build.library_path("a", "int a; ") != paths[0]
    assert sorted(p.suffix for p in _build.BUILD_DIR.iterdir()) == [".cu", ".cu", ".so", ".so"]


def test_failed_build_raises_with_compiler_output(fake_toolkit):
    with pytest.raises(RuntimeError, match="cannot compile"):
        _build.build([("ok", "int ok;"), ("bad", "BROKEN")])
    assert _build.library_path("ok", "int ok;").exists()
    assert not _build.library_path("bad", "BROKEN").exists()


def test_missing_toolkit_is_reported(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_name_covers_headers_and_flags(tmp_path, monkeypatch):
    """A changed shared header or flag set must not load a stale library."""
    header = tmp_path / "stencil_common.cuh"
    header.write_text("// v1")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    v1 = _build.library_path("x", "int x;")
    header.write_text("// v2")
    v2 = _build.library_path("x", "int x;")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1])
    assert len({v1, v2, _build.library_path("x", "int x;")}) == 3
    assert v1.name.startswith("x-") and v1.suffix == ".so"


def test_launch_counters():
    _build.reset_launches()
    _build.check_launch("k", 0)
    _build.check_launch("k", 0)
    _build.count_launch("j")
    assert _build.LAUNCHES == {"k": 2, "j": 1}
    _build.reset_launches()
    assert _build.LAUNCHES == {}


class _Tensor:
    """Stands in for a CUDA tensor: what ``check_input`` reads, no card."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:0", contiguous=True):
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device(device)
        self.ndim, self._contiguous = len(self.shape), contiguous

    def is_contiguous(self):
        return self._contiguous


F32 = (torch.float32,)


@pytest.mark.parametrize("x, kwargs, error, match", [
    (_Tensor((2, 8, 8)), {}, None, None),
    (_Tensor((16, 256), torch.bfloat16), {"ndim": 2}, TypeError, "dtype"),
    (_Tensor((8, 8)), {}, ValueError, r"\(depth, rows, cols\)"),
    (_Tensor((70000, 8, 8)), {}, None, None),
    (_Tensor((2, 8, 8), device="cpu"), {}, ValueError, "a CUDA device"),
    (_Tensor((2, 8, 8), contiguous=False), {}, ValueError, "contiguous"),
    (_Tensor((1, 4, 2, 8)), {"shape": (1, 4, 2, 8), "device": torch.device("cuda:0")},
     None, None),
    (_Tensor((1, 4, 2, 8)), {"shape": (1, 4, 2, 4), "device": torch.device("cuda:0")},
     ValueError, r"expected \(1, 4, 2, 4\)"),
    (_Tensor((1, 4, 2, 8), device="cuda:1"),
     {"shape": (1, 4, 2, 8), "device": torch.device("cuda:0")}, ValueError, "cuda:0"),
    (_Tensor((70000, 8, 8)), {"shape": (70000, 8, 8), "device": torch.device("cuda:0")},
     None, None),
])
def test_check_input(x, kwargs, error, match):
    """One validator: the stencil layouts by rank (any depth: the wrappers
    cut a deep field into launches), the recurrences' inputs by exact shape
    and launch device."""
    if error is None:
        _build.check_input("k", x, F32, **kwargs)
    else:
        with pytest.raises(error, match=match):
            _build.check_input("k", x, F32, **kwargs)
