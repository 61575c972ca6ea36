"""The port's native RTP edge under ASan and UBSan: the twin of
tests/test_native.py::test_native_sanitizers, built from
ka9q_radio_tpu_torch/native/edge_selftest.cpp and rtp_edge.cpp (the
analog of the reference's `make SANITIZE=1`, src/Makefile:50-54)."""
import os
import subprocess

import pytest

import ka9q_radio_tpu_torch.native as native


def test_edge_sanitizers(tmp_path):
    d = os.path.dirname(os.path.abspath(native.__file__))
    exe = tmp_path / "edge_selftest"
    try:
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
             os.path.join(d, "edge_selftest.cpp"), "-o", str(exe), "-ldl", "-lpthread"],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"sanitizer toolchain unavailable: {e}")
    r = subprocess.run([str(exe)], capture_output=True, text=True, timeout=60,
                       env={**os.environ, "UBSAN_OPTIONS": "halt_on_error=1",
                            "ASAN_OPTIONS": "detect_leaks=1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "edge_selftest OK" in r.stdout
