"""Process set-up shared by the entry points: the compile cache, the
host-keyed native library, the GPU guard of the smoke run, and the trace
reduction behind ``--profile``."""

import os

import jax
import pytest

from rpcc import runtime
from rpcc.codec import lz4block
from rpcc.utils.profiling import reduce_device_events


def test_compile_cache_left_to_jax_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_compile_cache() == before  # nothing set in code


def test_compile_cache_fixed_in_checkout_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compile_cache_dir()
    assert path == runtime.DEFAULT_COMPILE_CACHE == runtime.compile_cache_dir()
    assert os.path.dirname(path) == runtime.REPO_ROOT
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.setup_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_path_keyed_by_host_and_flags(tmp_path):
    a = lz4block.library_path(cpu_id="model name : CPU A\nflags : avx2")
    assert a == lz4block.library_path(cpu_id="model name : CPU A\nflags : avx2")
    assert a != lz4block.library_path(cpu_id="model name : CPU B\nflags : avx2")
    assert a != lz4block.library_path(cpu_id="model name : CPU A\nflags : avx512f")
    flags = lz4block.CXX_FLAGS + ("-DEXTRA",)
    assert a != lz4block.library_path(flags=flags, cpu_id="model name : CPU A\nflags : avx2")
    assert os.path.dirname(a) == lz4block.BUILD_DIR
    assert lz4block.BUILD_DIR.startswith(os.path.join(runtime.REPO_ROOT, "build"))
    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nmodel name\t: CPU A\nflags\t\t: avx2 fma\n\n"
                    "processor\t: 1\nmodel name\t: CPU A\nflags\t\t: avx2 fma\n")
    assert lz4block.host_cpu_id(str(info)) == "model name\t: CPU A\nflags\t\t: avx2 fma"


def test_chip_smoke_refuses_cpu_only_process(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code == 2
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "GPU" in err


def test_trace_reduction_counts_device_kernels_once():
    events = [
        ("/host:CPU", "python", "PjitFunction(encode)", 5e6),
        ("/device:GPU:0", "XLA Modules", "jit_encode", 9e6),
        ("/device:GPU:0", "XLA Ops", "fusion.1", 2e6),
        ("/device:GPU:0", "Stream #13(Compute)", "fusion.1", 2e6),
        ("/device:GPU:0", "Stream #13(Compute)", "sort.7", 3e6),
        ("/device:GPU:0", "Stream #14(MemcpyH2D)", "MemcpyH2D", 1e6),
        ("/device:GPU:0", "Stream #13(Compute)", "fusion.1", 1e6),
    ]
    rows = reduce_device_events(events, top=2)
    assert rows == [(3.0, "fusion.1", 2), (3.0, "sort.7", 1)]
    # planes with no per-stream lines count every non-aggregate line
    rows = reduce_device_events([("/device:ACCEL:0", "XLA Ops", "x", 4e6),
                                 ("/device:ACCEL:0", "Steps", "0", 9e6)])
    assert rows == [(4.0, "x", 1)]
