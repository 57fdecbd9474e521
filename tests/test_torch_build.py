"""The port's kernel build (deeplearning4j_tpu_torch/ops/_build.py) on the
CPU, with a stand-in ``nvcc``: a shell script in a temporary
``CUDA_HOME`` that answers ``--version``. The library name hashes the
toolchain, so a library built by another compiler never loads under the
name of this one's, and the build log names the compiler."""
import os

import pytest

from deeplearning4j_tpu_torch.ops import _build


def fake_nvcc(root, release: str) -> str:
    """``root/bin/nvcc`` answering ``--version`` with ``release``; on any
    other call it writes an empty library to its ``-o`` argument."""
    path = root / "bin" / "nvcc"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then\n'
        f'  echo "Cuda compilation tools, {release}"; exit 0\n'
        "fi\n"
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
        "done\n")
    path.chmod(0o755)
    return str(path)


@pytest.fixture
def cuda_home(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    return tmp_path / "cuda"


def test_library_name_follows_the_nvcc_version(cuda_home):
    path = fake_nvcc(cuda_home, "release 12.8, V12.8.93")
    assert _build.nvcc() == path
    first = _build.library("paged_decode")
    assert _build.library("paged_decode") == first
    assert "release 12.8" in _build.toolchain()
    # the same path, another version: another library
    fake_nvcc(cuda_home, "release 12.9, V12.9.41")
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    second = _build.library("paged_decode")
    assert second != first and second.parent == first.parent
    assert "release 12.9" in _build.toolchain()
    # another source keeps its own name under the same compiler
    assert _build.library("xent") not in (first, second)


def test_library_name_follows_the_nvcc_path(tmp_path, monkeypatch):
    names = []
    for d in ("a", "b"):
        fake_nvcc(tmp_path / d, "release 12.8, V12.8.93")
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / d))
        names.append(_build.library("paged_decode"))
    assert names[0] != names[1]


def test_build_log_records_the_toolchain(cuda_home, monkeypatch, tmp_path):
    fake_nvcc(cuda_home, "release 12.8, V12.8.93")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    took = _build.build(["paged_decode"])
    assert set(took) == {"paged_decode"}
    assert _build.library("paged_decode").exists()
    log = _build.build_log("paged_decode")
    assert log.startswith(f"nvcc {os.path.realpath(_build.nvcc())}\n")
    assert "release 12.8" in log and "sm_90a" in log
    # built once: the next build compiles nothing
    assert _build.build(["paged_decode"]) == {"paged_decode": 0.0}
