"""bench.py measures the GPU only: with no GPU it exits nonzero and
prints no result line, and it never swaps in an assumed baseline."""

import importlib.util
import os

import pytest

_BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "bench.py")


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_refuses_a_host_without_gpu():
    bench = _load_bench()
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.require_gpu_device()


def test_main_prints_no_result_without_gpu(capsys):
    bench = _load_bench()
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_baseline_fails_instead_of_assuming(monkeypatch):
    """No native library, no baseline: the benchmark fails rather than
    dividing by a number it did not measure."""
    from odesat_tpu import native

    bench = _load_bench()
    monkeypatch.setattr(native, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no baseline"):
        bench.measure_baseline(None)
    assert not hasattr(bench, "FALLBACK_BASELINE_TRAJ_STEPS_PER_SEC")
